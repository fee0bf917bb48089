#!/usr/bin/env python3
"""assemble's kernel against another build of it, on one GPU.

    python3 asm_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding another assemble.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags. A build with
nlzm_assemble_shape takes this checkout's arguments and runs through the
port's wrapper; an earlier one (its nlzm_assemble: tok, len, lex, lit, slot,
bit_half, n_cmds, dscratch, op_len, op_val; B, five (width, stride) pairs,
hb) is launched here with its own [B, Tc] scratch and [Tc, B] outputs, as its
wrapper made them. This checkout's assemble.cu is built as the port
builds it. On the shipping buckets (8 MB at 32 KiB blocks), the two quantile buckets of one 2
MiB file bucket, the frontier buckets (4 MB at 128 KiB blocks, big) and
every chip_smoke.fuzz_assemble(card=True) pattern at wide_delta false and
true, every held build is held against assemble_ops_ref (the others'
mismatches are reported, not raised: the earlier design departs from JAX
on the spill classes; this build raises after every input is reported), then all are timed in turns (forward, then back; CUDA events,
mean of chip_smoke.KERNEL_REPS back-to-back calls each) and alone on the
device (chip_smoke.kernel_device_ms, torch.profiler), with ns a slot. On
the buckets the hand-off is timed too: lz_expand on this build's [B, TP]
pairs (_lz_expand_rows) against lz_expand_parallel on the same commands as
[T, B] (its transpose kernel and the expansion), device ms in turns. Prints
one JSON line an input, then the card's name and power limit. Imports
nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_assemble", 8, 14),)
OTHER_ENTRIES = (("nlzm_assemble", 10, 12),)


def other_call(fn):
    """A call of an earlier build's entry with its own scratch and [Tc, B]
    outputs, as its wrapper made them: (op_len, op_val)."""
    import torch

    from nlzm_tpu_torch import _build

    def call(tok, len_, lex, lit, slot, bit_half, n_cmds, big, wide_delta):
        B, Tc = tok.shape
        dev = tok.device
        dscratch = torch.empty(B, Tc, dtype=torch.int32, device=dev)
        op_len = torch.empty(Tc, B, dtype=torch.int32, device=dev)
        op_val = torch.empty(Tc, B, dtype=torch.int32, device=dev)
        planes = (tok, len_, lex, lit, slot)
        geom = [x for a in planes for x in (a.shape[1], a.stride(0))]
        _build.launch(fn, [*(a.data_ptr() for a in planes), bit_half.data_ptr(),
                           n_cmds.data_ptr(), dscratch.data_ptr(), op_len.data_ptr(),
                           op_val.data_ptr()], [B, *geom, bit_half.shape[1]], dev)
        return op_len, op_val

    return call


def build_any(src: Path, name: str):
    """(call or None, library entries or None, ptxas lines) of the
    assemble.cu in src: this checkout's arguments when it defines
    nlzm_assemble_shape, else the earlier ones."""
    if "nlzm_assemble_shape" in (src / "assemble.cu").read_text():
        fns, regs = build_other(src, "assemble", ENTRIES, (), name)
        return None, fns, regs
    fns, regs = build_other(src, "assemble", OTHER_ENTRIES, (), name)
    return other_call(fns["nlzm_assemble"]), None, regs


def compare(label: str, asm, ex, builds: dict, timed: bool) -> dict:
    """Hold every build of `builds` ({name: (call or None, library entries
    or None)}; None, None for the port's own) against assemble_ops_ref,
    then, when timed, time them in turns, forward and back, and alone on
    the device (a build of this design through _assemble_rows, the main
    path's entry); with ex (block size, hint, dictionary), the hand-off."""
    import torch

    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    want = wd.assemble_ops_ref(*asm)

    def runner(name, rows=False):
        call = builds[name][0]
        if call is not None:
            return lambda: call(*asm)
        return (lambda: wd._assemble_rows(*asm)) if rows else (lambda: wd.assemble_ops(*asm))

    exact = {}
    for name, (call, fns) in builds.items():
        with using(fns, "assemble"):
            got = runner(name)()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
    B, Tc = asm[0].shape
    line = {"input": label, "blocks": B, "Tc": Tc, "big": asm[7], "wide_delta": asm[8],
            "exact": exact}
    if not timed:
        return line
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name][1], "assemble"):
            fn = runner(name, rows=True)
            fn()
            times[name].append(cs.timed_mean(fn, cs.KERNEL_REPS))
    device = {}
    for name in builds:
        with using(builds[name][1], "assemble"):
            device[name] = cs.kernel_device_ms(runner(name, rows=True), "assemble")
    slots = max(B * Tc, 1)
    line.update({"bound_ms": cs.bound(*cs.asm_work(asm))[0],
                 **{f"{n}_ms": t for n, t in times.items()},
                 **{f"{n}_device_ms": t for n, t in device.items()},
                 **{f"{n}_device_ns_per_slot": None if t is None else t * 1e6 / slots
                    for n, t in device.items()},
                 "shape": cs.asm_shape(Tc, asm[5].shape[1], B)})
    if ex is not None:
        cmds = wd._assemble_rows(*asm)
        cols = (cmds[:, :Tc, 0].t().contiguous(), cmds[:, :Tc, 1].t().contiguous())
        calls = {"rows": lambda: xo._lz_expand_rows(cmds, Tc, *ex),
                 "cols": lambda: xo.lz_expand_parallel(*cols, *ex)}
        hand = {n: [] for n in calls}
        for n in ("rows", "cols", "cols", "rows"):
            hand[n].append(cs.kernel_device_ms(calls[n], "lz_expand"))
        line["lz_expand_device_ms"] = hand
    return line


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("asm_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.parallel.blocks import encode_container

    reports = _build.build(("assemble", "lz_expand", "stage_windows", "plane_scan"))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("assemble", "").splitlines()
                                  if "registers" in ln or "spill" in ln]}
    others = []
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        call, fns, ptxas[name] = build_any(Path(src), name)
        builds[name] = (call, fns)
        others.append(name)
    builds["this"] = (None, None)
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas}), flush=True)

    data = cs.build_corpus(cs.SHIP_BYTES)
    ship = encode_container(data, parser="optimal", profile="wide", **cs.SHIP)
    front = encode_container(data[: cs.FRONTIER_BYTES], parser="optimal", profile="wide",
                             **cs.FRONTIER)
    inexact = []
    for label, asm, ex, timed in cs.asm_inputs(ship, front, "cuda"):
        timed = timed or ex is None and asm[8] and not label.startswith("spill")
        line = compare(label, asm, ex, builds, timed)
        print(json.dumps(line), flush=True)
        inexact += [f"{label}:{n}" for n, ok in line["exact"].items()
                    if not ok and n not in others]
        del asm
    print(cs.card_line(), flush=True)
    if inexact:
        raise AssertionError(f"this kernel differs from the plain version on {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
