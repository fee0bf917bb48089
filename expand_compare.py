#!/usr/bin/env python3
"""lz_expand's kernel against another build of it, on one GPU.

    python3 expand_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding an earlier lz_expand.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags; its nlzm_lz_expand takes
the earlier arguments (op_len, op_val, dict, pa, pb, lit_at, lit_mask,
out, produced; T, B, N, D, rounds, max_rounds) and is launched here with
its own scratch, allocated at each call as its wrapper did. This
checkout's lz_expand.cu is built too, as the port builds it and with each
variant of VARIANTS, which end after the commands, the parents or the
rounds (NLZM_LZ_STOP=1, 2, 3); these are timed, never held. On the
shipping buckets (8 MB at 32 KiB blocks) and the frontier buckets (4 MB at
128 KiB blocks), each at its hint and at 0 and 1, the v1 bench buckets
(8 MB at 32 KiB blocks, no hint) and chip_smoke.ex_inputs (a 2 MiB file
bucket's two, the 512 KiB buckets, rle_deep_chains, 1 MiB blocks, every
fuzz_expand pattern) this build and the others are held against
lz_expand_parallel_ref (the others' mismatches are reported, not raised:
the earlier design departs from JAX on the fault classes of
chip_smoke.fuzz_expand, and this build raises only after every input is
reported), then all are timed in turns on each input ex_inputs times
(forward, then back; CUDA events, mean of chip_smoke.KERNEL_REPS
back-to-back calls each) and alone on the device
(chip_smoke.kernel_device_ms, torch.profiler), with ns a position. Prints
one JSON line an input, then the card's name and power limit. Imports
nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_lz_expand", 6, 6),)
OTHER_ENTRIES = (("nlzm_lz_expand", 9, 6),)
VARIANTS = {"stop_commands": (("NLZM_LZ_STOP=1",), False),
            "stop_parents": (("NLZM_LZ_STOP=2",), False),
            "stop_rounds": (("NLZM_LZ_STOP=3",), False),
            "emulate_all": (("NLZM_LZ_EMULATE_ALL=1",), True)}


def other_call(fn):
    """A call of an earlier build's entry with its own scratch, as its
    wrapper made it."""
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import expand_ops as xo

    def call(op_len, op_val, N, hint, dict_arr):
        T, B = op_len.shape
        D = 0 if dict_arr is None else dict_arr.numel()
        dev = op_len.device
        pa = torch.empty(B, N, dtype=torch.int32, device=dev)
        pb = torch.empty_like(pa)
        lit_at = torch.empty(B, N, dtype=torch.uint8, device=dev)
        lit_mask = torch.empty(B, (N + 31) // 32, dtype=torch.int32, device=dev)
        out = torch.empty(B, N, dtype=torch.uint8, device=dev)
        produced = torch.empty(B, dtype=torch.int32, device=dev)
        _build.launch(fn, [op_len.data_ptr(), op_val.data_ptr(),
                           None if dict_arr is None else dict_arr.data_ptr(), pa.data_ptr(),
                           pb.data_ptr(), lit_at.data_ptr(), lit_mask.data_ptr(),
                           out.data_ptr(), produced.data_ptr()],
                      [T, B, N, D, -1 if hint is None else int(hint), xo._max_rounds(N)], dev)
        return out, produced

    return call


def compare(label: str, args, builds: dict, timed: bool) -> dict:
    """Hold every held build of `builds` ({name: (call or None, library
    entries or None, held)}; None, None for the port's own) against
    lz_expand_parallel_ref, then, when timed, time them in turns, forward
    and back, and alone on the device."""
    import torch

    from nlzm_tpu_torch.ops import expand_ops as xo

    want = xo.lz_expand_parallel_ref(*args)

    def runner(name):
        call, fns, _ = builds[name]
        if call is not None:
            return lambda: call(*args)
        return lambda: xo.lz_expand_parallel(*args)

    exact = {}
    for name, (call, fns, held) in builds.items():
        if not held:
            continue
        with using(fns, "lz_expand"):
            got = runner(name)()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
    op_len, _, N, hint, dict_arr = args
    T, B = op_len.shape
    line = {"input": label, "blocks": B, "T": T, "N": N,
            "D": 0 if dict_arr is None else dict_arr.numel(), "hint": hint, "exact": exact}
    if not timed:
        return line
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name][1], "lz_expand"):
            fn = runner(name)
            fn()
            times[name].append(cs.timed_mean(fn, cs.KERNEL_REPS))
    device, main = {}, {}
    for name in builds:
        with using(builds[name][1], "lz_expand"):
            device[name] = cs.kernel_device_ms(runner(name), "lz_expand")
            main[name] = cs.kernel_device_ms(runner(name), "lz_expand_kernel")
    pos = max(B * N, 1)
    line.update({"bound_ms": cs.bound(*cs.expand_work(op_len, N, hint, dict_arr))[0],
                 **{f"{n}_ms": t for n, t in times.items()},
                 **{f"{n}_device_ms": t for n, t in device.items()},
                 **{f"{n}_main_device_ms": t for n, t in main.items()},
                 **{f"{n}_device_ns_per_position": None if t is None else t * 1e6 / pos
                    for n, t in device.items()},
                 "shape": cs.ex_shape(T, B, N, line["D"])})
    return line


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("expand_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops.decode_v2 import fsm_decode_v2
    from nlzm_tpu_torch.parallel.blocks import encode_container, parse_container, stage_v1_buckets

    reports = _build.build(("lz_expand", "stage_windows", "plane_scan", "assemble", "fsm_decode"))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("lz_expand", "").splitlines()
                                  if "registers" in ln]}
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        fns, ptxas[name] = build_other(Path(src), "lz_expand", OTHER_ENTRIES, (), name)
        builds[name] = (other_call(fns["nlzm_lz_expand"]), None, True)
    builds["this"] = (None, None, True)
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, (defines, held) in VARIANTS.items():
        fns, ptxas[name] = build_other(here, "lz_expand", ENTRIES, defines, name)
        builds[name] = (None, fns, held)
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas}), flush=True)

    data = cs.build_corpus(cs.SHIP_BYTES)
    ship = encode_container(data, parser="optimal", profile="wide", **cs.SHIP)
    front = encode_container(data[: cs.FRONTIER_BYTES], parser="optimal", profile="wide",
                             **cs.FRONTIER)
    v1 = encode_container(data, **cs.V1_BENCH)
    big = encode_container(data[: cs.V1_BIG_BYTES], **cs.V1_BIG)
    inexact = []

    def report(label, args, timed=True):
        line = compare(label, args, builds, timed)
        print(json.dumps(line), flush=True)
        if not line["exact"]["this"]:
            inexact.append(label)

    for tag, container in (("ship", ship), ("frontier", front)):
        info, buckets = cs.stage(container, "cuda")
        for i, (staged, _) in enumerate(buckets):
            ops = cs.wide_commands(staged, info.block_size)
            for h in (staged["rounds_hint"], 0, 1):
                report(f"{tag}_b{i}_h{h}", (*ops, info.block_size, h, staged["dict_arr"]))
        del buckets
    info = parse_container(v1)
    for i, (streams, steps, _) in enumerate(stage_v1_buckets(v1, info, device="cuda")):
        report(f"v1_bench_b{i}", (*fsm_decode_v2(streams, steps), info.block_size, None, None))
    for label, args, timed in cs.ex_inputs(ship, big, "cuda"):
        report(label, args, timed)
        del args
    print(cs.card_line(), flush=True)
    if inexact:
        raise AssertionError(f"this kernel differs from the plain version on {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
