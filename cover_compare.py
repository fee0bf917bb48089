#!/usr/bin/env python3
"""The cover walk's kernel against another build of it, on one GPU.

    python3 cover_compare.py OTHER_CSRC

OTHER_CSRC is a directory holding another greedy_cover.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive. Both are built with the port's nvcc flags; the other
one's nlzm_greedy_cover and nlzm_dp_cover take the same arguments, so the
port's wrappers launch it unchanged. On each input, greedy_cover and
dp_cover of both builds are held exactly against their plain versions,
then timed in turns (other, this, this, other; CUDA events, mean of
chip_smoke.KERNEL_REPS back-to-back calls each): the v1 encodes' 1024 x
8192, the wide encodes' 245 x 32768 (dp C = 3), 1 MiB of long matches at
8 KiB blocks (chip_smoke.long_match_data), 1 MiB at 128 KiB blocks (the
global-scratch path), and every chip_smoke.fuzz_cover pattern at 1024 x
8192. Prints one JSON line an input, then the card's
name and power limit. Imports nothing of JAX or of nlzm_tpu.
"""

import ctypes
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import chip_smoke as cs

ENTRIES = (("nlzm_greedy_cover", 8, 3), ("nlzm_dp_cover", 9, 4))


def build_other(src_dir: Path, source: str = "greedy_cover", entries=ENTRIES, defines=(),
                tag: str = "other"):
    """The entries ((symbol, pointers, ints), ...) of src_dir/<source>.cu,
    built apart (as lib<source>_<tag>.so) with the port's flags and the
    macro definitions `defines` ("NAME=VALUE", ...): ({symbol: ctypes
    function}, ptxas's register lines)."""
    from nlzm_tpu_torch import _build

    out = Path(__file__).resolve().parent / ".build" / "compare" / f"lib{source}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                        "-o", str(out), str(src_dir / f"{source}.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}/{source}.cu:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for sym, n_ptr, n_int in entries:
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (n_int + 1) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[sym] = fn
    return fns, [ln for ln in r.stdout.splitlines() + r.stderr.splitlines()
                 if "registers" in ln or "spill" in ln]


@contextmanager
def using(fns, source: str = "greedy_cover"):
    """The port's wrappers of kernel library `source` launch the entries
    `fns` ({symbol: function}; None: the port's own)."""
    from nlzm_tpu_torch import _build

    keys = [(source, sym) for sym in fns or ()]
    saved = {k: _build._libs.get(k) for k in keys}
    for k in keys:
        _build._libs[k] = fns[k[1]]
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                _build._libs.pop(k, None)
            else:
                _build._libs[k] = v


def compare(label: str, name: str, args, T: int, other) -> dict:
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    kernel, plain = getattr(eo, name), getattr(eo, f"{name}_ref")
    want = plain(*args, T)
    for fns in (other, None):
        with using(fns):
            got = kernel(*args, T)
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            who = "other" if fns is not None else "this"
            raise AssertionError(f"{label} {name}: the {who} kernel differs from the plain version")
    times = []
    for fns in (other, None, None, other):
        with using(fns):
            times.append(cs.timed_mean(lambda: kernel(*args, T), cs.KERNEL_REPS))
    live = want[0] >= 0
    return {"input": label, "kernel": name, "blocks": want[0].shape[1],
            "positions": args[0].shape[1], "commands": int(live.sum()),
            "max_cmds": int(live.sum(0).max()), "other_ms": [times[0], times[3]],
            "this_ms": [times[1], times[2]],
            "speedup": min(times[0], times[3]) / min(times[1], times[2])}


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("cover_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    reports = _build.build(("greedy_cover", "find_matches", "dp_parse"))
    other, regs = build_other(Path(sys.argv[1]))
    this = [ln for ln in reports.get("greedy_cover", "").splitlines() if "registers" in ln]
    print(json.dumps({"other": sys.argv[1], "other_ptxas": regs, "this_ptxas": this,
                      "ctas_per_sm": {f"{n}_{N}": cs.cover_ctas_per_sm(N, n == "dp")
                                      for n in ("greedy", "dp") for N in (8192, 32768, 131072)}}),
          flush=True)
    put = lambda a: torch.as_tensor(a, device="cuda")
    corpus = cs.build_corpus(max(cs.SHIP_BYTES, cs.V1_ENC_BYTES))

    def parsed(label, data, N, reach):
        arr, nv = eo._blocks_arrays(data, N)
        dt, nvt = put(arr), put(nv)
        T = (N + 255) // 256 * 256
        print(json.dumps(compare(label, "greedy_cover",
                                 (dt, *eo.find_matches(dt, nvt, reach), nvt), T, other)), flush=True)
        d3, m3 = eo.find_matches(dt, nvt, reach, 3)
        print(json.dumps(compare(label, "dp_cover", (dt, d3, *eo.dp_parse(d3, m3, nvt), nvt), T,
                                 other)), flush=True)

    v1, wide = cs.V1_ENC["block_size"], cs.WIDE_OPT["block_size"]
    parsed("v1_1024x8192", corpus[:cs.V1_ENC_BYTES], v1, (1 << cs.V1_ENC_HIST_BITS) - 1)
    parsed("wide_245x32768", corpus[:cs.SHIP_BYTES], wide, (1 << cs.ENC_HIST_BITS) - 1)
    parsed("long_match_128x8192", cs.long_match_data(11), v1, (1 << cs.V1_ENC_HIST_BITS) - 1)
    big = cs.BIG_COVER["block_size"]
    parsed("global_8x131072", corpus[:cs.BIG_COVER["bytes"]], big, big - 1)
    for pat, f in cs.fuzz_cover(7, 1024, v1).items():
        g = tuple(put(f[k]) for k in ("data", "delta", "mlen", "n_valid"))
        print(json.dumps(compare(pat, "greedy_cover", g, f["num_steps"], other)), flush=True)
        d = tuple(put(f[k]) for k in ("data", "delta3", "choice_len", "choice_cand", "n_valid"))
        print(json.dumps(compare(pat, "dp_cover", d, f["num_steps"], other)), flush=True)
        del g, d
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
