#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nlzm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path - wide-profile NLZP container decode - on the
card and fails (nonzero exit, no result line) on anything wrong:

1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles the four kernels from nlzm_tpu_torch/csrc with nvcc;
3. kernels: encodes the bench corpus (8 MB) at the shipping config with
   the native host encoder, stages it on the card, and holds each kernel
   against its plain PyTorch version on the same device tensors at these
   main-path shapes (exact: the codec is integer and lossless);
   times both with CUDA events;
4. end to end: decode_container(device="cuda") must return the input
   (CRC-verified) with every kernel's launch count > 0; decode MB/s;
5. frontier: the same at 128 KiB blocks, 128 KiB dictionary, depth cap
   12, on 4 MB;
6. corrupt input: a flipped stream byte must raise IntegrityError, and a
   valid decode right after must still succeed.

Each phase prints one JSON line. The last three lines are the kernels
summary, the card line of nvidia-smi, and {"ok": true, "device": ...}.
Imports nothing of JAX: the port and the jax-free host code it uses.
"""

import json
import subprocess
import sys
import time

SHIP = dict(block_size=32768, dict_size=32768, depth_cap=8)  # bench.py primary config
FRONTIER = dict(block_size=131072, dict_size=131072, depth_cap=12)
SHIP_BYTES = 8_000_000
FRONTIER_BYTES = 4_000_000
REPS = 5  # end-to-end timings: best of REPS
KERNEL_REPS = 20  # kernel timings: mean of KERNEL_REPS back-to-back launches


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def mean_ms(fn, reps: int) -> float:
    """CUDA-event time of `reps` back-to-back calls of fn() over reps,
    after one warm-up call: the launches queue up, so host overhead
    hides behind device time wherever the device is the slower side."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def best_ms(fn, reps: int) -> float:
    """Best of `reps` CUDA-event timings of fn(), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching tensors (or tuples of them);
    raises on a shape or dtype mismatch."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want, strict=True))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
                             f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def stage(container: bytes, device):
    """Parse a container and stage its buckets on `device` as the decode
    path does: (info, [(staged, block_index_list)])."""
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import block_payloads, parse_container

    info = parse_container(container)
    return info, wd.stage_buckets(block_payloads(container, info), info.wide_priors,
                                  info.total_reads, info.dictionary, device=device)


def check_kernels(buckets, block_size: int) -> dict:
    """Each kernel against its plain version on the same device tensors,
    bucket by bucket; returns {name: (max_abs_err, ms, plain_ms)} with
    times summed over the buckets (each a mean_ms)."""
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    res = {n: [0, 0.0, 0.0] for n in ("stage_windows", "plane_scan", "assemble", "lz_expand")}

    def hold(name, kernel, plain, reps_plain=KERNEL_REPS):
        got, want = kernel(), plain()
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        r = res[name]
        r[1] += mean_ms(kernel, KERNEL_REPS)
        r[2] += mean_ms(plain, reps_plain)
        return want

    for staged, _ in buckets:
        sw = (staged["hw_cat"], staged["offs"], staged["ends"], staged["WHs"])
        wins = hold("stage_windows", lambda: wd.stage_windows_fused(*sw),
                    lambda: wd.stage_windows_fused_ref(*sw))
        ps = (staged["seeds_cat"], wins, staged["n_sym"], staged["steps"], staged["priors"])
        ys = hold("plane_scan", lambda: wd.plane_scan_fused(*ps),
                  lambda: wd.plane_scan_fused_ref(*ps), reps_plain=2)
        if block_size <= wd.CAP15:
            ys = tuple(a[:, : min(a.shape[1], wd.CAP15)] for a in ys)
        tok_y, lit_y, len_y, lex_y, slot_y = ys
        asm = (tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
               staged["n_sym"][:, 0].contiguous())
        op_len, op_val = hold("assemble", lambda: wd.assemble_ops(*asm),
                              lambda: wd.assemble_ops_ref(*asm))
        ex = (op_len, op_val, block_size, staged["rounds_hint"], staged["dict_arr"])
        hold("lz_expand", lambda: xo.lz_expand_parallel(*ex),
             lambda: xo.lz_expand_parallel_ref(*ex))
    return {n: tuple(v) for n, v in res.items()}


def counters():
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    return {
        "stage_windows": wd.stage_windows_fused,
        "plane_scan": wd.plane_scan_fused,
        "assemble": wd.assemble_ops,
        "lz_expand": xo.lz_expand_parallel,
    }


def decode_path(label: str, data: bytes, container: bytes, card: str, device) -> dict:
    """Decode on `device` with the launch counts zeroed just before and
    read just after; check the bytes; time the decode. Returns the counts."""
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import decode_container

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    out = decode_container(container, device=device)
    launches = {n: fn.launches for n, fn in fns.items()}
    if out != data:
        raise AssertionError(f"{label}: decoded bytes differ from the input")
    missing = [n for n, k in launches.items() if k <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the main path: {missing}")

    e2e = best_ms(lambda: decode_container(container, device=device), REPS)
    info, buckets = stage(container, device)
    block_size = info.block_size

    def staged_run():
        for staged, _ in buckets:
            wd.decode_wide_staged(staged, block_size)

    dev_ms = best_ms(staged_run, REPS)
    emit({
        "phase": label, "ok": True, "bytes": len(data), "container_bytes": len(container),
        "blocks": len(info.comp_sizes), "buckets": len(buckets), "launches": launches,
        "e2e_ms": e2e, "e2e_MBps": len(data) / e2e / 1e3,
        "staged_ms": dev_ms, "staged_MBps": len(data) / dev_ms / 1e3,
        "timing": f"CUDA events, best of {REPS}", "card": card,
    })
    return launches


def corrupt_copy(container: bytes) -> bytes:
    """The container with the first tok-plane renorm pair of block 0
    flipped (the live-stream flip of tests/test_dict.py)."""
    from nlzm_tpu_torch.ops.wide_decode import NP, PLANES, chunk_schedule, padded_steps
    from nlzm_tpu_torch.parallel.blocks import block_payloads, parse_container

    hdr_bytes = 8 * NP + 4  # per plane: u32 count, u32 stream bytes; then u32 bits bytes
    info = parse_container(container)
    payload = block_payloads(container, info)[0]
    tables = 0
    for i in range(NP):
        sym_count = int.from_bytes(payload[8 * i : 8 * i + 4], "big")
        tables += 2 * (len(chunk_schedule(padded_steps(sym_count, PLANES[i].lanes))) - 1)
    blob = bytearray(container)
    blob[info.payload_off + hdr_bytes + tables + 4 * PLANES[0].lanes] ^= 0xFF
    return bytes(blob)


def run(device, ship_bytes: int, frontier_bytes: int, card: str):
    """Phases 3-6 on `device`; returns (kernel results, main-path launches)."""
    from bench import build_corpus
    from nlzm_tpu_torch.parallel.blocks import (
        IntegrityError, decode_container, encode_container, native)

    if not native.available():
        native.load()  # raises with the build error of the host encoder

    # 3. kernels at the main-path shapes
    t0 = time.perf_counter()
    data = build_corpus(ship_bytes)
    container = encode_container(data, parser="optimal", profile="wide", **SHIP)
    encode_s = time.perf_counter() - t0
    info, buckets = stage(container, device)
    res = check_kernels(buckets, info.block_size)
    emit({"phase": "kernels", "ok": True, "encode_s": encode_s,
          "buckets": [len(idx) for _, idx in buckets],
          "ms": {n: v[1] for n, v in res.items()},
          "plain_ms": {n: v[2] for n, v in res.items()},
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls (plain "
                    f"plane_scan: 2) per bucket, summed over buckets", "card": card})
    del buckets

    # 4. end to end: the main path
    launches = decode_path("e2e_ship", data, container, card, device)

    # 5. frontier config
    fdata = build_corpus(frontier_bytes)
    fcont = encode_container(fdata, parser="optimal", profile="wide", **FRONTIER)
    decode_path("e2e_frontier", fdata, fcont, card, device)

    # 6. corrupt input, then a valid decode on the same context
    try:
        decode_container(corrupt_copy(container), device=device)
    except IntegrityError as e:
        caught = str(e)
    else:
        raise AssertionError("corrupt container decoded without IntegrityError")
    if decode_container(container, device=device) != data:
        raise AssertionError("valid decode after the corrupt one failed")
    emit({"phase": "corrupt", "ok": True, "raised": caught})

    return res, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    # the whole program must be here before anything is reported
    import bench  # noqa: F401  (the corpus generator)
    from nlzm_tpu_torch import _build

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "ok": True, "seconds": secs, "built": sorted(reports),
          "ptxas": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
                    for n, log in reports.items()}})

    res, launches = run("cuda", SHIP_BYTES, FRONTIER_BYTES, card)

    src = "nlzm_tpu_torch/csrc/"
    replaces = {
        "stage_windows": "nlzm_tpu/ops/wide_decode.py:726",
        "plane_scan": "nlzm_tpu/ops/wide_decode.py:318",
        "assemble": "nlzm_tpu/ops/wide_decode.py:597",
        "lz_expand": "nlzm_tpu/ops/expand_ops.py:227",
    }
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": f"{src}{n}.cu", "replaces": replaces[n],
         "launches": launches[n], "max_abs_err": res[n][0], "ms": res[n][1],
         "plain_ms": res[n][2]}
        for n in replaces
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
