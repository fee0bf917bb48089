#!/usr/bin/env python3
"""Where the time of one container decode, and of one device encode,
goes on one GPU.

    python3 perf_breakdown.py [CASE ...]

Decodes the 8 MB bench corpus (chip_smoke.build_corpus) from container
bytes in host memory, at the wide shipping config and at the bench's v1
config, stage by stage through the functions decode_container runs; and
encodes it with the wide device encode (32 KiB blocks) and, on 8 MiB
(chip_smoke.V1_ENC_BYTES), the v1 device encode (8 KiB blocks), each with
the greedy and the optimal parse, stage by stage through the functions
encode_container(engine="device") runs; and decodes the NLZC research
container of 4 MiB at 16 KiB blocks (chip_smoke.NLZC) stage by stage
through the functions ppm_tpu.decompress runs, and the huff0 container of
the 8 MB at 32 KiB blocks (chip_smoke.HUFF0) through the functions
huff0.decode runs: host clock around each
stage, with a torch.cuda.synchronize() at every boundary, min and median
over REPS runs. Then one decode of each, and one encode_container(engine=
"device") of each profile, under torch.profiler: device time by kernel,
and the device's busy share of the wall time. Prints one JSON line per
measurement and the card line of nvidia-smi. CASE names limit the run to
those cases (wide_ship, v1_bench, wide_greedy_encode, wide_optimal_encode,
v1_device_encode, v1_optimal_encode, nlzc_decode, huff0_decode; default
all). Needs a CUDA device; imports the port and chip_smoke.py only.
"""

import json
import re
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke
from nlzm_tpu_torch import native
from nlzm_tpu_torch.format import wide
from nlzm_tpu_torch.ops import encode_ops as eo
from nlzm_tpu_torch.ops import wide_decode as wd
from nlzm_tpu_torch.ops import wide_encode_dev as we
from nlzm_tpu_torch.ops.expand_ops import scatter_blocks
from nlzm_tpu_torch.parallel import blocks
from nlzm_tpu_torch.research import huff0, ppm_tpu
from nlzm_tpu_torch.utils.crc32 import crc32

REPS = 6
OPT_ROUNDS = 3  # the calibrated parse's rounds (encode_ops._calibrated_parse)


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
    parts = [(wd.decode_wide_staged(staged, info.block_size), idx) for staged, idx in buckets]
    c.lap("decode_wide_staged (4 kernels per bucket)")
    plain = blocks.block_bytes([scatter_blocks(parts, len(payloads), info.block_size, dev)],
                               info.total_len)
    c.lap("scatter_blocks + block_bytes (scatter + device-to-host copy)")
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
    parts = [(blocks.decode_v1_staged(streams, num_steps, info.block_size), idx)
             for streams, num_steps, idx in buckets]
    c.lap("decode_v1_staged (fsm_decode + lz_expand per bucket)")
    plain = blocks.block_bytes([scatter_blocks(parts, len(payloads), info.block_size, dev)],
                               info.total_len)
    c.lap("scatter_blocks + block_bytes (scatter + device-to-host copy)")
    check(plain, data, info)
    c.lap("CRC32 verify")
    return c.ms


def parse_stages(c: Clock, dt, nv, reach: int, T: int, parser: str):
    """The device parse of encode_ops._device_parse, a lap per kernel
    launch (laps of one name add up). Returns (op_len, op_val)."""
    if parser == "greedy":
        delta, mlen = eo.find_matches(dt, nv, reach)
        c.lap("find_matches")
        out = eo.greedy_cover(dt, delta, mlen, nv, T)
        c.lap("greedy_cover")
        return out
    delta, mlen = eo.find_matches(dt, nv, reach, num_cands=3)
    c.lap("find_matches (3 candidates)")
    costs = None
    for i in range(OPT_ROUNDS):
        choice = eo.dp_parse(delta, mlen, nv, costs)
        c.lap(f"dp_parse ({OPT_ROUNDS} launches)")
        op_len, op_val = eo.dp_cover(dt, delta, *choice, nv, T)
        c.lap(f"dp_cover ({OPT_ROUNDS} launches)")
        if i < OPT_ROUNDS - 1:
            op_rep = eo.repify(op_len, op_val)
            c.lap("repify (calibration)")
            spans, _, _ = eo.emit_model(op_len, op_val, op_rep)
            c.lap("emit_model (calibration)")
            costs = eo.measure_costs(spans, op_len, op_val, op_rep)
            c.lap(f"measure_costs ({OPT_ROUNDS - 1} launches)")
    return op_len, op_val


def encode_stages(data: bytes, dev, cfg: dict) -> dict:
    """The wide device encode, stage by stage: parse_blocks_device (the
    parse's kernels, the copy back, lift_deep, repify), then
    encode_wide_blocks_device (plane batching, priors, upload, the five
    planes' plane_encode launch, the host assembly). cfg: chip_smoke.ENC_GREEDY
    or WIDE_OPT."""
    N, hist_bits = cfg["block_size"], chip_smoke.ENC_HIST_BITS
    c = Clock()
    arr, n_valid = eo._blocks_arrays(data, N)
    dt, nv = torch.as_tensor(arr, device=dev), torch.as_tensor(n_valid, device=dev)
    c.lap("_blocks_arrays + upload")
    op_len, op_val = parse_stages(c, dt, nv, (1 << hist_bits) - 1, (N + 255) // 256 * 256,
                                  cfg["parser"])
    op_len = np.array(op_len.cpu().numpy(), np.int32, order="C")
    op_val = np.array(op_val.cpu().numpy(), np.int32, order="C")
    c.lap("copy back (two [T, B] int32)")
    native.lift_deep(op_len, op_val, N)
    c.lap("lift_deep (native, host)")
    op_rep = eo.repify(torch.as_tensor(op_len, device=dev),
                       torch.as_tensor(op_val, device=dev)).cpu().numpy()
    c.lap("repify (upload, kernel, copy back)")
    per_block, batched, counts = wide.batch_plane_arrays(op_len, op_val, op_rep)
    c.lap("batch_plane_arrays (host)")
    priors = wide.build_priors_from_batched(batched)
    blob = wide.serialize_priors(priors)
    c.lap("priors (host)")
    args = [we.stage_plane(batched, priors, i, dev) for i in range(wide.N_PLANES)]
    c.lap("stage_plane (upload, 5 planes)")
    outs = we._plane_encode_planes(args)  # priors checked by stage_plane
    c.lap("plane_encode_planes (one launch)")
    planes = [we.plane_streams(spec, a[4], *o) for spec, a, o in zip(wide.PLANES, args, outs)]
    c.lap("plane_streams (copy back, per-block streams)")
    payloads = wide.assemble_payloads(per_block, counts, [p[0] for p in planes],
                                      [p[1] for p in planes])
    c.lap("assemble_payloads (host)")
    if (payloads, blob) != native.wide_encode(op_len, op_val, op_rep):
        raise AssertionError("device plane encode differs from native.wide_encode")
    c.t = time.perf_counter()  # the check is not a stage
    blocks.encode_container(data, device=dev, engine="device", **cfg)
    c.lap("encode_container(engine='device'), whole, for comparison")
    return c.ms


def v1_encode_stages(data: bytes, dev, cfg: dict) -> dict:
    """The v1 device encode, stage by stage: encode_blocks_device's
    upload, its kernels (encode_pipeline_device), frame_payloads (copy
    back, payload bytes), then the container's CRC. cfg: chip_smoke.V1_ENC
    or V1_OPT."""
    N, hist_bits = cfg["block_size"], chip_smoke.V1_ENC_HIST_BITS
    T = (N + 255) // 256 * 256
    rans_cap, bits_cap = ((3 * N + 64 + 255) // 256) * 256, ((N + 64 + 255) // 256) * 256
    c = Clock()
    arr, n_valid = eo._blocks_arrays(data, N)
    dt, nv = torch.as_tensor(arr, device=dev), torch.as_tensor(n_valid, device=dev)
    c.lap("_blocks_arrays + upload")
    op_len, op_val = parse_stages(c, dt, nv, (1 << hist_bits) - 1, T, cfg["parser"])
    op_rep = eo.repify(op_len, op_val)
    c.lap("repify")
    spans, fields, nops = eo.emit_model(op_len, op_val, op_rep)
    c.lap("emit_model")
    stream, rans_bytes = eo.rans_backward(spans, rans_cap)
    c.lap("rans_backward")
    bits, bits_n = eo.bits_forward(fields, bits_cap)
    ncmds = (op_len >= 0).sum(dim=0, dtype=torch.int32)
    c.lap("bits_forward (+ command count)")
    payloads, _, _ = eo.frame_payloads(stream, rans_bytes, bits, bits_n, nops, ncmds)
    c.lap("frame_payloads (copy back, payload bytes)")
    crc32(data)
    c.lap("CRC32 of the input")
    if payloads != eo.encode_blocks_device(data, N, hist_bits, cfg["parser"], device=dev)[0]:
        raise AssertionError("the stages' payloads differ from encode_blocks_device's")
    c.t = time.perf_counter()  # the check is not a stage
    blocks.encode_container(data, device=dev, engine="device", **cfg)
    c.lap("encode_container(engine='device'), whole, for comparison")
    return c.ms


def nlzc_stages(blob: bytes, data: bytes, dev) -> dict:
    """The NLZC decode, stage by stage: ppm_tpu.decompress's parse, prior
    decode, staging, kernel and reassembly."""
    c = Clock()
    block_size, total_len, prior_bytes, streams = ppm_tpu.parse_container(blob)
    c.lap("parse_container")
    prior = ppm_tpu.decode_prior(prior_bytes, dev)
    c.lap("decode_prior (huff0 device decode: tables, upload, huff_scan, copy back)")
    (args,), layout = ppm_tpu.stage_streams(streams, block_size, total_len, prior, [dev])
    c.lap("stage_streams (host staging + upload)")
    ppm_tpu._check_prior(args[2])
    c.lap("the prior's 0..255 check alone (torch.aminmax), for comparison")
    out = ppm_tpu._decode_blocks(*args)
    c.lap("_decode_blocks (ppm_decode)")
    plain = ppm_tpu.reassemble(out, layout)
    c.lap("reassemble (copy back + segment order)")
    if plain != data:
        raise AssertionError("NLZC decoded bytes differ from the input")
    return c.ms


def huff0_stages(container: bytes, data: bytes, dev) -> dict:
    """The huff0 device decode, stage by stage: huff0.decode's parse,
    staging (per-block tables, upload), kernel, and copy back and trim."""
    c = Clock()
    parsed = huff0._parse(container)
    c.lap("_parse")
    streams, base_l, limit_l, offs, syms, n_out, T = huff0.stage_blocks(container, *parsed, dev)
    c.lap("stage_blocks (tables, upload)")
    out = huff0._huff_scan(streams, base_l, limit_l, offs, syms, T)
    c.lap("_huff_scan (huff_scan)")
    out = out.cpu().numpy()
    plain = out[np.arange(T)[None, :] < n_out[:, None]].tobytes()[: parsed[1]]
    c.lap("copy back and trim")
    if plain != data:
        raise AssertionError("huff0 decoded bytes differ from the input")
    return c.ms


def check(plain: bytes, data: bytes, info) -> None:
    """The decode's CRC verification (blocks._verified), then the bytes."""
    if blocks._verified(plain, info) != data:
        raise AssertionError("decoded bytes differ from the input")


def device_ms(p) -> dict:
    """{full kernel key: device ms} of a finished torch.profiler run."""
    out = {}
    for e in p.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        if dt and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = out.get(e.key, 0.0) + dt / 1e3
    return out


def profile(fn) -> dict:
    """One fn() (a decode or an encode) under torch.profiler: device ms by
    kernel. A short device warm-up (float adds, which the codec never
    launches; their kernels are told apart by a trace of the warm-up
    alone) opens the traced window, so the tracer is running before fn's
    first launch; the wall time is fn's alone."""
    from torch.profiler import ProfilerActivity, profile as prof

    warm = torch.zeros(1 << 20, device="cuda")

    def warm_up():
        for _ in range(8):
            warm.add_(1.0)
        torch.cuda.synchronize()

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        warm_up()
    warm_keys = set(device_ms(p))
    for _ in range(2):  # the first profile also starts the tracer: keep the second
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            warm_up()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    by, warm_ms = {}, 0.0
    for key, ms in device_ms(p).items():
        if key in warm_keys:
            warm_ms += ms
            continue
        name = re.split(r"[(<]", key.replace("(anonymous namespace)::", ""))[0]
        by[name] = by.get(name, 0.0) + ms
    kernels = sum(by.values())
    return {"wall_ms_under_profiler": wall, "device_ms_by_name": by,
            "device_busy_ms": kernels, "busy_share": kernels / wall if wall else None,
            "warm_up_ms_dropped": warm_ms}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("perf_breakdown: needs a CUDA device")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    corpus = chip_smoke.build_corpus(max(chip_smoke.SHIP_BYTES, chip_smoke.V1_ENC_BYTES))
    data, v1_data = corpus[: chip_smoke.SHIP_BYTES], corpus[: chip_smoke.V1_ENC_BYTES]
    want = set(sys.argv[1:])
    cases = {
        "wide_ship": (lambda: blocks.encode_container(data, parser="optimal", profile="wide",
                                                      **chip_smoke.SHIP), wide_stages),
        "v1_bench": (lambda: blocks.encode_container(data, **chip_smoke.V1_BENCH), v1_stages),
    }
    runs_of = {}
    for name, (make, fn) in cases.items():
        if not want or name in want:
            c = make()
            runs_of[name] = (lambda c=c, fn=fn: fn(c, data, dev),
                             lambda c=c: blocks.decode_container(c, device=dev), len(data))
    for name, cfg in (("wide_greedy_encode", chip_smoke.ENC_GREEDY),
                      ("wide_optimal_encode", chip_smoke.WIDE_OPT)):
        runs_of[name] = (
            lambda cfg=cfg: encode_stages(data, dev, cfg),
            lambda cfg=cfg: blocks.encode_container(data, device=dev, engine="device", **cfg),
            len(data))
    for name, cfg in (("v1_device_encode", chip_smoke.V1_ENC),
                      ("v1_optimal_encode", chip_smoke.V1_OPT)):
        runs_of[name] = (
            lambda cfg=cfg: v1_encode_stages(v1_data, dev, cfg),
            lambda cfg=cfg: blocks.encode_container(v1_data, device=dev, engine="device", **cfg),
            len(v1_data))
    if not want or "nlzc_decode" in want:
        ndata = corpus[: chip_smoke.NLZC["bytes"]]
        nblob = ppm_tpu.compress(ndata, chip_smoke.NLZC["block_size"])
        runs_of["nlzc_decode"] = (lambda: nlzc_stages(nblob, ndata, dev),
                                  lambda: ppm_tpu.decompress(nblob, device=dev), len(ndata))
    if not want or "huff0_decode" in want:
        hdata = corpus[: chip_smoke.HUFF0["bytes"]]
        hblob = huff0.encode(hdata, chip_smoke.HUFF0["block_size"])
        runs_of["huff0_decode"] = (lambda: huff0_stages(hblob, hdata, dev),
                                   lambda: huff0.decode(hblob, device=dev), len(hdata))
    for name, (stages_fn, whole, nbytes) in runs_of.items():
        if want and name not in want:
            continue
        stages_fn()  # warm: kernel builds, allocator
        runs = [stages_fn() for _ in range(REPS)]
        stages = {k: {"min": min(r[k] for r in runs),
                      "median": statistics.median(r[k] for r in runs)} for k in runs[0]}
        total = [sum(v for k, v in r.items() if "for comparison" not in k) for r in runs]
        print(json.dumps({"case": name, "bytes": nbytes, "stages_ms": stages,
                          "total_ms": {"min": min(total), "median": statistics.median(total)},
                          "timing": f"host clock, synchronise at each boundary, {REPS} runs",
                          "card": card}), flush=True)
        print(json.dumps({"case": name, "profile": profile(whole), "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
