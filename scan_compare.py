#!/usr/bin/env python3
"""plane_scan_fused's kernel against another build of it, on one GPU.

    python3 scan_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding another plane_scan.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags; its nlzm_plane_scan takes
the same arguments, so the port's wrapper launches it unchanged. This
checkout's plane_scan.cu is built too, as the port builds it and with each
variant of VARIANTS, which run one plane's CTAs alone (NLZM_PS_ONLY=1 << q,
slot order tok|len|dst|lit|lex); these are timed, never held. On the shipping buckets (8 MB at 32 KiB
blocks), the frontier buckets (4 MB at 128 KiB blocks) and
chip_smoke.ps_inputs (the two quantile buckets of a 2 MiB file bucket,
every fuzz_scan pattern) this build and the others are held against
plane_scan_fused_ref (the others' mismatches are reported, not raised: the
design before this one clamped a pair index to its own plane's window
where JAX reads the next planes' windows), then all are timed in turns
through the main path's entry (forward, then back; CUDA events, mean of
chip_smoke.KERNEL_REPS back-to-back calls each) and alone on the device
(chip_smoke.kernel_device_ms, torch.profiler), with ns a step of the
bucket's steps. Prints one JSON line an input, then the card's name and
power limit. Imports nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_plane_scan", 14, 8),)
VARIANTS = {f"only_{n}": (f"NLZM_PS_ONLY={1 << q}",)
            for q, n in enumerate(("tok", "len", "dst", "lit", "lex"))}


def compare(label: str, args, builds: dict) -> dict:
    """Hold every held build of `builds` ({name: (entries, held)}; entries
    None for the port's own) against plane_scan_fused_ref, then time them
    in turns, forward and back, and alone on the device."""
    import torch

    from nlzm_tpu_torch.ops import wide_decode as wd

    sp = wd.slot_priors(args[4])  # staged once, as the main path stages it
    call = lambda: wd._plane_scan_fused(*args, sp)
    want = wd.plane_scan_fused_ref(*args)
    exact = {}
    for name, (fns, held) in builds.items():
        if not held:
            continue
        with using(fns, "plane_scan"):
            got = call()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
        if fns is None and not exact[name]:
            raise AssertionError(f"{label}: this kernel differs from the plain version")
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name][0], "plane_scan"):
            call()
            times[name].append(cs.timed_mean(call, cs.KERNEL_REPS))
    device = {}
    for name in builds:
        with using(builds[name][0], "plane_scan"):
            device[name] = cs.kernel_device_ms(call, "plane_scan")
    seeds, wins, n_sym, steps, _ = args
    live = (n_sym.long().clamp(min=0) + n_sym.new_tensor(cs.PS_WIRE_LANES) - 1)
    live = (live // n_sym.new_tensor(cs.PS_WIRE_LANES)).clamp(max=steps).max(0).values
    return {"input": label, "blocks": seeds.shape[0], "steps": steps,
            "live_steps": dict(zip(("tok", "lit", "len", "lex", "dst"), live.tolist())),
            "window_ints": [int(w.shape[2]) for w in wins],
            "bound_ms": cs.bound(*cs.ps_work(args))[0], "exact": exact,
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_device_ms": t for n, t in device.items()},
            **{f"{n}_device_ns_per_step": None if t is None else t * 1e6 / max(steps, 1)
               for n, t in device.items()},
            "shape": cs.ps_shape(seeds.shape[0])}


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.parallel.blocks import encode_container

    reports = _build.build(("plane_scan", "stage_windows"))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("plane_scan", "").splitlines()
                                  if "registers" in ln]}
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        fns, ptxas[name] = build_other(Path(src), "plane_scan", ENTRIES, (), name)
        builds[name] = (fns, True)
    builds["this"] = (None, True)
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        fns, ptxas[name] = build_other(here, "plane_scan", ENTRIES, defines, name)
        builds[name] = (fns, False)
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas}), flush=True)

    data = cs.build_corpus(cs.SHIP_BYTES)
    ship = encode_container(data, parser="optimal", profile="wide", **cs.SHIP)
    front = encode_container(data[: cs.FRONTIER_BYTES], parser="optimal", profile="wide",
                             **cs.FRONTIER)
    for tag, container in (("ship", ship), ("frontier", front)):
        _, buckets = cs.stage(container, "cuda")
        for i, (staged, _) in enumerate(buckets):
            print(json.dumps(compare(f"{tag}_b{i}", cs.ps_args(staged), builds)), flush=True)
        del buckets
    for label, args in cs.ps_inputs(ship, "cuda"):
        print(json.dumps(compare(label, args, builds)), flush=True)
        del args
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
