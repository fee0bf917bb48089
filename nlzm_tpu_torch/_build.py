"""Build and load the port's CUDA kernels.

Each nlzm_tpu_torch/csrc/<name>.cu compiles with nvcc into its own shared
library with a plain C interface, .build/torch_kernels/lib<name>-<hash>.so,
where the hash covers the source, the shared header and the flags. A
library that exists is reused; the sources compile in parallel, one nvcc
process each, at first use. Libraries load with ctypes: every pointer and
the stream pass as c_void_p, every size as c_int, and every entry point
returns the CUDA error code of its launch (0 = launched).

Nothing here runs at import time, so importing the package needs no CUDA.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build" / "torch_kernels"
KERNELS = (
    "stage_windows", "plane_scan", "assemble", "lz_expand", "fsm_decode",
    "find_matches", "greedy_cover", "repify", "plane_encode",
    "emit_model", "rans_backward", "bits_forward", "dp_parse", "measure_costs",
    "plane_decode", "huff_scan", "ppm_decode",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(str(Path(os.environ[env]) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library of `names` that is missing, all in parallel.

    Returns {name: ptxas resource report} for the libraries compiled now
    (empty for those already built). Raises KernelBuildError with nvcc's
    output when any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
        reports[name] = log
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return reports


def entry(name: str, symbol: str, n_ptr: int, n_int: int):
    """The ctypes function `symbol` of kernel library `name`.

    Its C signature is (n_ptr pointers, n_int ints, device, stream) ->
    int, in that order: pointers and the stream as c_void_p, the rest as
    c_int.
    """
    key = (name, symbol)
    with _lock:
        fn = _libs.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = (
                [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1)
                + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            _libs[key] = fn
    return fn


def check_cuda(name: str, *tensors) -> None:
    """Every given tensor (None skipped) is contiguous and on one CUDA
    device; raise ValueError otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got {devs}")
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{name}: tensors must be contiguous")


def launch(fn, ptrs, ints, device) -> None:
    """Call a kernel entry on `device`'s current torch stream; raise on a
    nonzero launch status. Every entry calls cudaSetDevice(device) and
    leaves it set, so the call runs under torch.cuda.device(index): the
    caller's current device comes back when it returns."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        status = fn(*ptrs, *ints, index, stream)
    if status != 0:
        raise KernelLaunchError(f"{fn.__name__}: CUDA error {status} at launch")
