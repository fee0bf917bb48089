#!/usr/bin/env python3
"""plane_decode's kernel against an earlier build of it, on one GPU.

    python3 plane_compare.py OTHER_CSRC

OTHER_CSRC is a directory holding an earlier plane_decode.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive. It is launched through its own C signature,
nlzm_plane_decode (a [R, 4] int64 descriptor tensor uploaded at each
call, seeds, wins, n_sym, ctx and the chunk schedule on the device; B, L,
R, steps, NC, WH, is_dst and the shared bytes). This checkout's source is
built as the port builds it ("this"), and launched through the entry
without the prior check (wide_decode._plane_scan), also with every plane
sent down the general path ("general").

Inputs: the ten wire planes of the shipping buckets (chip_smoke.pd_ship_jobs:
the bench's 8 MB at the wide shipping config) with the container's priors
and without them, one call of the ten a timing; each spec of
chip_smoke.SYNTH_PLANES (its round trip through plane_encode,
chip_smoke.pd_round_trip), and the same under hostile context rows
(chip_smoke.hostile_rows). On each input every build is held exactly
against plane_scan_ref (this build raises after every input is reported;
the earlier build's mismatches are reported), then timed in turns
(forward, then back): CUDA events, mean of chip_smoke.KERNEL_REPS calls,
and device ms a call under torch.profiler (every launch of a call
summed), beside the bound (chip_smoke.plane_decode_work), ns a step (device
ms over the steps of the call's planes) and this build's launch shapes;
on the wire planes also each plane's device ms a launch, both builds.
Prints one JSON line an input, then the card's name and power limit.
Imports nothing of JAX or of nlzm_tpu.
"""

import functools
import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other
from enc_compare import compare

PD_OLD = (("nlzm_plane_decode", 6, 8),)


def old_plane_scan(fn, args):
    """One plane through the earlier signature (one launch)."""
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops.wide_decode import _schedule_tensor

    seeds, wins, n_sym, ctx, idx, steps, prior = args
    spec = wide.PLANES[idx]
    L, R, B = spec.lanes, spec.reads, seeds.shape[0]
    prior = (None,) * R if prior is None else prior
    dev = seeds.device
    outs = [torch.empty(B, steps * L, dtype=torch.int32, device=dev) for _ in range(R)]
    desc = torch.tensor(
        [[0 if p is None else p.data_ptr(), o.data_ptr(), spec.alphabets[r], spec.rows[r]]
         for r, (p, o) in enumerate(zip(prior, outs))], dtype=torch.int64, device=dev)
    smem = 4 * sum(spec.rows[r] * (3 * spec.alphabets[r] + 1) for r in range(R))
    _build.launch(fn, [desc.data_ptr(), seeds.data_ptr(), wins.data_ptr(), n_sym.data_ptr(),
                       ctx.data_ptr(), _schedule_tensor(steps, dev).data_ptr()],
                  [B, L, R, steps, len(wide.chunk_schedule(steps)), wins.shape[2],
                   int(spec.name == "dst"), smem], dev)
    return tuple(outs)


def with_layouts(layout_of, fn):
    """fn() with wide_decode.plane_decode_layout replaced by layout_of."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    def call():
        saved = wd.plane_decode_layout
        wd.plane_decode_layout = layout_of
        try:
            return fn()
        finally:
            wd.plane_decode_layout = saved
    return call


def general_layout(base, spec, WH):
    """base(spec, WH) with the plane sent down the kernel's general path."""
    lay = base(spec, WH)
    smem = 4 * sum(spec.rows[r] * (3 * spec.alphabets[r] + 1) for r in range(spec.reads))
    return lay._replace(warp=False, lpt=1, smem=smem, kinds=(), tables=(),
                        ctx_at=0 if lay.ctx_at >= 0 else -1)


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("plane_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import encode_container

    other = Path(sys.argv[1])
    reports = _build.build(("plane_decode", "plane_encode", "plane_scan", "stage_windows",
                            "assemble", "lz_expand"))
    ptxas = {"this": [ln for ln in reports.get("plane_decode", "").splitlines()
                      if "registers" in ln or "spill" in ln]}
    old, ptxas["other"] = build_other(other, "plane_decode", PD_OLD, (), "other")
    print(json.dumps({"other": str(other), "ptxas": ptxas}), flush=True)

    data = cs.build_corpus(cs.SHIP_BYTES)
    ship = encode_container(data, parser="optimal", profile="wide", **cs.SHIP)
    jobs = [a for a, _ in cs.pd_ship_jobs(ship, "cuda")]
    inputs = [("ship_priors", None, jobs),
              ("ship_no_priors", None, [a[:6] + (None,) for a in jobs])]
    for seed, (name, fields) in enumerate(cs.SYNTH_PLANES.items()):
        spec, args, _, _ = cs.pd_round_trip(fields, seed, "cuda")
        inputs.append((name, spec, [args]))
        inputs.append((f"{name}_hostile", spec, [cs.hostile_rows(args, seed)]))

    base = wd.plane_decode_layout
    general = functools.lru_cache(None)(lambda spec, WH: general_layout(base, spec, WH))
    inexact = []
    for label, spec, arg_list in inputs:
        with cs.dst_spec(spec or wide.PLANES[4]):
            this = lambda: [wd._plane_scan(*a) for a in arg_list]
            calls = {"other": lambda: [old_plane_scan(old["nlzm_plane_decode"], a)
                                       for a in arg_list],
                     "this": this,
                     "general": with_layouts(general, this)}
            steps = sum(a[5] for a in arg_list)
            work = [cs.plane_decode_work(a) for a in arg_list]
            extra = lambda: {"bound_ms": cs.bound(sum(w[0] for w in work),
                                                  sum(w[1] for w in work))[0],
                             "steps": [a[5] for a in arg_list],
                             "blocks": [a[0].shape[0] for a in arg_list],
                             "symbols": sum(int(a[2].long().sum()) for a in arg_list),
                             "shapes": [cs.pd_shape(a) for a in arg_list]}
            line = compare(label, calls, lambda: [wd.plane_scan_ref(*a) for a in arg_list],
                           "plane_decode", extra)
            if len(arg_list) > 1:  # each plane alone: device ms a launch, parent and this
                line["planes"] = [
                    {"plane": a[4], "steps": a[5], "blocks": a[0].shape[0],
                     **{f"{n}_device_ms": cs.calls_device_ms(f, "plane_decode") for n, f in (
                         ("other", lambda: old_plane_scan(old["nlzm_plane_decode"], a)),
                         ("this", lambda: wd._plane_scan(*a)))}}
                    for a in arg_list]
        for name in calls:
            dev_ms = [t for t in line[f"{name}_device_ms"] if t is not None]
            line[f"{name}_ns_step"] = min(dev_ms) * 1e6 / steps if dev_ms else None
        print(json.dumps(line), flush=True)
        inexact += [f"{name}:{label}" for name, ok in line["exact"].items()
                    if not ok and name != "other"]
    print(cs.card_line(), flush=True)
    if inexact:
        raise AssertionError(f"this checkout's build differs from the plain version on {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
