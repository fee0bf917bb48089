#!/usr/bin/env python3
"""stage_windows' and bits_forward's kernels against other builds of them,
on one GPU.

    python3 pack_compare.py OTHER_CSRC [TAG=CSRC ...]

OTHER_CSRC is a directory holding another stage_windows.cu and
bits_forward.cu (with their common.cuh), for example nlzm_tpu_torch/csrc of
an earlier commit unpacked with git archive; both take this checkout's
arguments, so the port's wrappers launch them unchanged. Each TAG=CSRC
adds such a directory as one more build, named TAG (for example a copy of
this checkout's sources with one choice changed). This checkout's sources
are built as the port builds them ("this").

stage_windows runs on the shipping buckets (8 MB at 32 KiB blocks), the two
quantile buckets of one 2 MiB file bucket, the frontier buckets (4 MB at
128 KiB blocks) and every chip_smoke.fuzz_windows pattern
(chip_smoke.sw_inputs); bits_forward on the v1 fields of the first 1024,
512, 256, 128, 64, 32 and 8 blocks of the v1 bench's 8 MiB at 8 KiB blocks
(T = 8192; 256 blocks are a 2 MiB file bucket's, 8 a 64 KiB file's) and
every chip_smoke.fuzz_bits(card=True) pattern (chip_smoke.bits_inputs). On
each input every build is held exactly against the plain version (this
build raises after every input is reported; the others' mismatches are
reported), then timed in turns (forward, then back; CUDA events, mean of
chip_smoke.KERNEL_REPS back-to-back calls each) and alone on the device
(chip_smoke.kernel_device_ms, torch.profiler, forward and back), beside the
bound (chip_smoke.sw_work, bits_work) and the launch shape. Beside
stage_windows, as a yardstick only: torch.gather and torch.where on the
same inputs (the clamped indices and the masks made beforehand; [B, cells]
out, not the windows' layout), device ms. Prints one JSON line an input,
then the card's name and power limit. Imports nothing of JAX or of
nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

SW_ENTRIES = (("nlzm_stage_windows", 4, 8),)
BITS_ENTRIES = (("nlzm_bits_forward", 6, 3),)
BITS_BLOCKS = (1024, 512, 256, 128, 64, 32, 8)


def gather_where(sw):
    """(call, args): torch.gather of hw_cat at every cell's clamped index
    and torch.where of the pair-count mask, as one [B, cells] output; the
    indices and masks are made here, outside the timed call."""
    import torch

    hw, offs, ends, WHs = sw
    B, H = hw.shape
    src = (hw.long() & 0xFFFF).to(torch.int32)
    nxt = torch.cat([offs[:, :, 1:], ends[:, :, None]], dim=2)
    pc = (nxt - offs).long()
    idx, mask = [], []
    for p, w in enumerate(WHs):
        k = torch.arange(w, device=hw.device)
        q = ((offs[:, p, :, None].long() + k + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        idx.append(q.clamp(0, max(H - 1, 0)).reshape(B, -1))
        mask.append((k < pc[:, p, :, None]).reshape(B, -1))
    idx, mask = torch.cat(idx, 1), torch.cat(mask, 1)
    zero = torch.zeros((), dtype=torch.int32, device=hw.device)
    return lambda: torch.where(mask, torch.gather(src, 1, idx), zero)


def compare(label: str, kernel, plain, builds: dict, source: str, key: str, timed: bool,
            extra=None) -> dict:
    """Hold each build of `builds` ({name: entries or None}) against
    plain(), then, when timed, time them in turns and alone on the device."""
    import torch

    want = plain()
    exact = {}
    for name, fns in builds.items():
        with using(fns, source):
            got = kernel()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
    line = {"kernel": key, "input": label, "exact": exact}
    if not timed:
        return line
    order = [*builds, *reversed(builds)]
    times = {name: [] for name in builds}
    device = {name: [] for name in builds}
    for name in order:
        with using(builds[name], source):
            kernel()
            times[name].append(cs.timed_mean(kernel, cs.KERNEL_REPS))
    for name in order:
        with using(builds[name], source):
            device[name].append(cs.kernel_device_ms(kernel, key))
    line.update({f"{n}_ms": t for n, t in times.items()})
    line.update({f"{n}_device_ms": t for n, t in device.items()})
    if extra:
        line.update(extra())
    return line


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not all("=" in a for a in sys.argv[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("pack_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import encode_container

    others = {"other": Path(sys.argv[1]),
              **{t: Path(d) for t, d in (a.split("=", 1) for a in sys.argv[2:])}}
    reports = _build.build(("stage_windows", "bits_forward", "plane_scan", "find_matches",
                            "greedy_cover", "repify", "emit_model"))
    ptxas = {f"this_{n}": [ln for ln in reports.get(n, "").splitlines()
                           if "registers" in ln or "spill" in ln]
             for n in ("stage_windows", "bits_forward")}
    sw_builds, bits_builds = {}, {}
    for tag, src in others.items():
        sw_builds[tag], ptxas[f"{tag}_stage_windows"] = build_other(
            src, "stage_windows", SW_ENTRIES, (), tag)
        bits_builds[tag], ptxas[f"{tag}_bits_forward"] = build_other(
            src, "bits_forward", BITS_ENTRIES, (), tag)
    sw_builds["this"] = bits_builds["this"] = None
    print(json.dumps({"builds": {t: str(d) for t, d in others.items()}, "ptxas": ptxas}),
          flush=True)

    data = cs.build_corpus(max(cs.SHIP_BYTES, cs.V1_ENC_BYTES))
    ship = encode_container(data[: cs.SHIP_BYTES], parser="optimal", profile="wide", **cs.SHIP)
    front = encode_container(data[: cs.FRONTIER_BYTES], parser="optimal", profile="wide",
                             **cs.FRONTIER)
    inexact = []
    for label, sw, _ in cs.sw_inputs(ship, front, "cuda"):
        yard = gather_where(sw)
        B, NC = sw[0].shape[0], sw[1].shape[2]
        extra = lambda: {"bound_ms": cs.bound(*cs.sw_work(sw))[0],
                         "gather_where_device_ms": cs.kernel_device_ms(yard, "gather")
                         + (cs.kernel_device_ms(yard, "where") or 0.0),
                         "shape": cs.sw_shape(B, NC)}
        line = compare(label, lambda: wd.stage_windows_fused(*sw),
                       lambda: wd.stage_windows_fused_ref(*sw), sw_builds, "stage_windows",
                       "stage_windows", True, extra)
        print(json.dumps(line), flush=True)
        inexact += [f"stage_windows:{label}"] if not line["exact"]["this"] else []
        del sw, yard
    for label, (fields, cap), _ in cs.bits_inputs(data[: cs.V1_ENC_BYTES], "cuda",
                                                  blocks=BITS_BLOCKS):
        T, B = fields[1].shape
        extra = lambda: {"bound_ms": cs.bound(*cs.bits_work(fields, cap))[0],
                         "shape": cs.bits_shape(B, cap)}
        line = compare(label, lambda: eo.bits_forward(fields, cap),
                       lambda: eo.bits_forward_ref(fields, cap), bits_builds, "bits_forward",
                       "bits_forward", True, extra)
        line.update(steps=T, blocks=B, cap=cap)
        print(json.dumps(line), flush=True)
        inexact += [f"bits_forward:{label}"] if not line["exact"]["this"] else []
        del fields
    print(cs.card_line(), flush=True)
    if inexact:
        raise AssertionError(f"this checkout's build differs from the plain version on {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
