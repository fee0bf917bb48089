#!/usr/bin/env python3
"""plane_encode's and measure_costs' kernels against an earlier build of
them, on one GPU.

    python3 enc_compare.py OTHER_CSRC

OTHER_CSRC is a directory holding an earlier plane_encode.cu and
measure_costs.cu (with their common.cuh), for example nlzm_tpu_torch/csrc
of an earlier commit unpacked with git archive. They are launched through
their own C signatures: nlzm_plane_encode one plane a launch (a [R, 5]
int64 descriptor tensor, the chunk schedule and a [B, steps * R * L] span
scratch on the device), so its time for the five planes is the sum of
five launches; nlzm_measure_costs (spans, op_len, op_val, op_rep, table,
defaults, costs, T, B). This checkout's sources are built as the port
builds them ("this").

plane_encode runs on chip_smoke.pe_inputs (the bench's 8 MB commands at 32
KiB blocks and 1 MiB of random bytes at 128 KiB blocks, whose lit plane
takes the large path, each with and without priors); measure_costs on the first
round's spans and commands of an optimal parse (chip_smoke.mc_round1) at 8
MiB in 8 KiB blocks (1024 x 8192), at the wide optimal shape (8 MB at 32
KiB blocks, 245 x 32768) and on the first 256 blocks of the first (a 2 MiB
file bucket, 256 x 8192), and every chip_smoke.fuzz_opt commands set. On
each input both builds are held exactly against the plain version (this
build raises after every input is reported; the earlier build's
mismatches are reported), then timed in turns (forward, then back): CUDA events, mean of
chip_smoke.KERNEL_REPS calls, and device ms a call under torch.profiler
(every launch of the kernel in a call summed), beside the bound
(chip_smoke.pe_work, mc_work) and this build's launch shape. Last, the
device-encode pipeline's run() (encode_pipeline_device: the five planes of
the 8 MB and a checksum fetch), host clock, best of chip_smoke.REPS, with
each build's plane encode, in turns. Prints one JSON line an input, then
the card's name and power limit. Imports nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other

PE_OLD = (("nlzm_plane_encode", 7, 7),)
MC_OLD = (("nlzm_measure_costs", 7, 2),)


def old_plane_encode(fn, args):
    """One plane through the earlier signature (one launch)."""
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops.wide_decode import _schedule_tensor

    syms, rows, n_sym, plane_idx, steps, prior = args
    spec = wide.PLANES[plane_idx]
    L, R, B = spec.lanes, spec.reads, n_sym.shape[0]
    prior = (None,) * R if prior is None else prior
    dev = syms[0].device
    desc = torch.tensor(
        [[s.data_ptr(), 0 if w is None else w.data_ptr(), 0 if p is None else p.data_ptr(),
          spec.alphabets[r], spec.rows[r]]
         for r, (s, w, p) in enumerate(zip(syms, rows, prior))], dtype=torch.int64, device=dev)
    K = steps * R * L
    span = torch.empty(B, K, dtype=torch.int32, device=dev)
    seeds = torch.empty(B, L, dtype=torch.int32, device=dev)
    pairs = torch.empty(B, K, dtype=torch.int32, device=dev)
    mask = torch.empty(B, K, dtype=torch.bool, device=dev)
    smem = 4 * sum(spec.rows[r] * (3 * spec.alphabets[r] + 1) for r in range(R))
    _build.launch(fn, [desc.data_ptr(), n_sym.data_ptr(), _schedule_tensor(steps, dev).data_ptr(),
                       span.data_ptr(), seeds.data_ptr(), pairs.data_ptr(), mask.data_ptr()],
                  [B, L, R, steps, len(wide.chunk_schedule(steps)),
                   int(syms[0].dtype == torch.uint8), smem], dev)
    return seeds, pairs, mask


def old_measure_costs(fn, mc):
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    spans, op_len, op_val, op_rep = mc
    T, B, _ = spans.shape
    dev = spans.device
    costs = torch.empty(B, 6, dtype=torch.int32, device=dev)
    _build.launch(fn, [spans.data_ptr(), op_len.data_ptr(), op_val.data_ptr(), op_rep.data_ptr(),
                       eo.bits16_table(dev).data_ptr(), eo._default_costs_on(dev).data_ptr(),
                       costs.data_ptr()], [T, B], dev)
    return costs


def compare(label: str, calls: dict, plain, key: str, extra=None) -> dict:
    """Hold each build's call of `calls` ({name: fn}) against plain(), then
    time them in turns, with CUDA events and on the device."""
    import torch

    want = plain()
    exact = {}
    for name, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
    line = {"kernel": key, "input": label, "exact": exact}
    order = [*calls, *reversed(calls)]
    times = {name: [] for name in calls}
    dev = {name: [] for name in calls}
    for name in order:
        calls[name]()
        times[name].append(cs.timed_mean(calls[name], cs.KERNEL_REPS))
    for name in order:
        dev[name].append(cs.calls_device_ms(calls[name], key))
    line.update({f"{n}_ms": t for n, t in times.items()})
    line.update({f"{n}_device_ms": t for n, t in dev.items()})
    if extra:
        line.update(extra())
    return line


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("enc_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    other = Path(sys.argv[1])
    reports = _build.build(("plane_encode", "measure_costs", "find_matches", "dp_parse",
                            "greedy_cover", "repify", "emit_model"))
    ptxas = {f"this_{n}": [ln for ln in reports.get(n, "").splitlines()
                           if "registers" in ln or "spill" in ln]
             for n in ("plane_encode", "measure_costs")}
    old_pe, ptxas["other_plane_encode"] = build_other(other, "plane_encode", PE_OLD, (), "other")
    old_mc, ptxas["other_measure_costs"] = build_other(other, "measure_costs", MC_OLD, (), "other")
    print(json.dumps({"other": str(other), "ptxas": ptxas}), flush=True)

    corpus = cs.build_corpus(max(cs.SHIP_BYTES, cs.V1_ENC_BYTES))
    inexact = []
    pe_inputs = cs.pe_inputs(corpus[: cs.SHIP_BYTES], "cuda")
    for label, staged in pe_inputs:
        calls = {"other": lambda: [old_plane_encode(old_pe["nlzm_plane_encode"], a)
                                   for a in staged],
                 "this": lambda: we._plane_encode_planes(staged)}
        extra = lambda: {"bound_ms": cs.bound(*cs.pe_work(staged))[0],
                         "shape": cs.pe_shape(staged),
                         "steps": [a[4] for a in staged],
                         "blocks": staged[0][2].shape[0],
                         "symbols": [int(a[2].long().sum()) for a in staged]}
        line = compare(label, calls, lambda: [we.plane_encode_ref(*a) for a in staged],
                       "plane_encode", extra)
        print(json.dumps(line), flush=True)
        inexact += [f"plane_encode:{label}"] if not line["exact"]["this"] else []

    data = corpus[: cs.V1_ENC_BYTES]
    v1 = cs.mc_round1(data, cs.V1_OPT["block_size"], cs.V1_ENC_HIST_BITS, "cuda")
    mcs = [("1024x8192", v1),
           ("245x32768", cs.mc_round1(corpus[: cs.SHIP_BYTES], cs.WIDE_OPT["block_size"],
                                      cs.ENC_HIST_BITS, "cuda")),
           ("256x8192", tuple(a[:, :256].contiguous() for a in v1))]
    fz = cs.fuzz_opt(7)["commands"]
    mcs.append(("fuzz_opt", tuple(torch.as_tensor(a, device="cuda") for a in fz)))
    for label, mc in mcs:
        calls = {"other": lambda: old_measure_costs(old_mc["nlzm_measure_costs"], mc),
                 "this": lambda: eo.measure_costs(*mc)}
        T, B = mc[1].shape
        extra = lambda: {"bound_ms": cs.bound(*cs.mc_work(mc))[0], "shape": cs.mc_shape(T, B),
                         "live_rows": int((mc[1] >= 0).sum())}
        line = compare(label, calls, lambda: eo.measure_costs_ref(*mc), "measure_costs", extra)
        print(json.dumps(line), flush=True)
        inexact += [f"measure_costs:{label}"] if not line["exact"]["this"] else []

    # the pipeline's run(): the five planes of the 8 MB and a checksum fetch
    staged = pe_inputs[0][1]
    checksum = lambda outs: int(sum((s.long() & 0xFFFFFFFF).sum() + (p.long() * m).sum()
                                    for s, p, m in outs))
    runs = {"other": lambda: checksum([old_plane_encode(old_pe["nlzm_plane_encode"], a)
                                       for a in staged]),
            "this": lambda: checksum(we._plane_encode_planes(staged))}
    best = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        runs[name]()
        best[name].append(cs.host_best(runs[name], cs.REPS) * 1e3)
    print(json.dumps({"input": "pipeline_run", "host_ms_best": best,
                      "timing": f"host clock, best of {cs.REPS}, forward then back"}), flush=True)
    print(cs.card_line(), flush=True)
    if inexact:
        raise AssertionError(f"this checkout's build differs from the plain version on {inexact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
