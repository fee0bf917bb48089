#!/usr/bin/env python3
"""Where the time of one container decode goes, on one GPU.

    python3 perf_breakdown.py

Decodes the 8 MB bench corpus (chip_smoke.build_corpus) from container
bytes in host memory, at the wide shipping config and at the bench's v1
config, stage by stage through the functions decode_container runs:
host clock around each stage, with a torch.cuda.synchronize() at every
boundary, min and median over REPS runs. Then one decode of each under
torch.profiler: device time by kernel, and the device's busy share of the
wall time. Prints one JSON
line per measurement and the card line of nvidia-smi. Needs a CUDA
device; imports the port and chip_smoke.py only.
"""

import json
import re
import statistics
import time

import torch

import chip_smoke
from nlzm_tpu_torch.ops import wide_decode as wd
from nlzm_tpu_torch.ops.expand_ops import scatter_blocks
from nlzm_tpu_torch.parallel import blocks

REPS = 6


class Clock:
    """Named host-clock intervals, each closed by a device synchronise."""

    def __init__(self):
        self.t = time.perf_counter()
        self.ms = {}

    def lap(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self.t) * 1e3
        self.t = now


def wide_stages(container: bytes, data: bytes, dev) -> dict:
    c = Clock()
    info = blocks.parse_container(container)
    c.lap("parse_container (incl. dictionary decompress)")
    payloads = blocks.block_payloads(container, info)
    c.lap("block_payloads")
    dict_arr = wd.dict_tensor(info.dictionary, dev)
    buckets = wd.stage_buckets(payloads, info.wide_priors, info.total_reads, dict_arr, device=dev)
    c.lap("stage_buckets (host staging + upload)")
    parts = [(wd.decode_wide_staged(staged, info.block_size)[0], idx) for staged, idx in buckets]
    c.lap("decode_wide_staged (4 kernels per bucket)")
    plain = scatter_blocks(parts, len(payloads), info.block_size, info.total_len, dev)
    c.lap("scatter_blocks (scatter + device-to-host copy)")
    check(plain, data, info)
    c.lap("CRC32 verify")
    return c.ms


def v1_stages(container: bytes, data: bytes, dev) -> dict:
    c = Clock()
    info = blocks.parse_container(container)
    c.lap("parse_container")
    payloads = blocks.block_payloads(container, info)
    c.lap("block_payloads")
    buckets = blocks.stage_v1_payloads(payloads, info.num_cmds, device=dev)
    c.lap("stage_v1_payloads (host staging + upload)")
    parts = [(blocks.decode_v1_staged(streams, num_steps, info.block_size)[0], idx)
             for streams, num_steps, idx in buckets]
    c.lap("decode_v1_staged (fsm_decode + lz_expand per bucket)")
    plain = scatter_blocks(parts, len(payloads), info.block_size, info.total_len, dev)
    c.lap("scatter_blocks (scatter + device-to-host copy)")
    check(plain, data, info)
    c.lap("CRC32 verify")
    return c.ms


def check(plain: bytes, data: bytes, info) -> None:
    """The decode's CRC verification (blocks._verified), then the bytes."""
    if blocks._verified(plain, info) != data:
        raise AssertionError("decoded bytes differ from the input")


def profile(container: bytes, dev) -> dict:
    """One decode_container under torch.profiler: device ms by kernel."""
    from torch.profiler import ProfilerActivity, profile as prof

    for _ in range(2):  # the first profile also starts the tracer: keep the second
        blocks.decode_container(container, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            blocks.decode_container(container, device=dev)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {}
    for e in p.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        if dt and str(getattr(e, "device_type", "")).endswith("CUDA"):
            name = re.split(r"[(<]", e.key.replace("(anonymous namespace)::", ""))[0]
            by[name] = by.get(name, 0.0) + dt / 1e3
    kernels = sum(by.values())
    return {"wall_ms_under_profiler": wall, "device_ms_by_name": by,
            "device_busy_ms": kernels, "busy_share": kernels / wall if wall else None}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("perf_breakdown: needs a CUDA device")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    data = chip_smoke.build_corpus(chip_smoke.SHIP_BYTES)
    cases = {
        "wide_ship": (blocks.encode_container(data, parser="optimal", profile="wide",
                                              **chip_smoke.SHIP), wide_stages),
        "v1_bench": (blocks.encode_container(data, **chip_smoke.V1_BENCH), v1_stages),
    }
    for name, (container, fn) in cases.items():
        fn(container, data, dev)  # warm: kernel builds, allocator
        runs = [fn(container, data, dev) for _ in range(REPS)]
        stages = {k: {"min": min(r[k] for r in runs),
                      "median": statistics.median(r[k] for r in runs)} for k in runs[0]}
        total = [sum(r.values()) for r in runs]
        print(json.dumps({"case": name, "bytes": len(data), "stages_ms": stages,
                          "total_ms": {"min": min(total), "median": statistics.median(total)},
                          "timing": f"host clock, synchronise at each boundary, {REPS} runs",
                          "card": card}), flush=True)
        print(json.dumps({"case": name, "profile": profile(container, dev), "card": card}),
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
