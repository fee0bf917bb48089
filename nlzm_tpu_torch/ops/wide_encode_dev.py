"""Wide-profile plane encode on a PyTorch device, with a CUDA kernel.

Counterpart of nlzm_tpu/ops/wide_encode_dev.py. plane_encode runs the
decoder's chunk-adaptive tables forward against the known symbols,
recording each symbol's (start, freq), then advances L interleaved rANS
lanes backward, emitting 16-bit renorm pairs where the host encoder
does; csrc/plane_encode.cu is the kernel, plane_encode_ref its plain
PyTorch version (CPU tensors run the plain version, CUDA tensors launch
the kernel). The payloads are byte-identical to the host encoders'
(nlzm_tpu's numpy format.wide.encode_wide_blocks and native.wide_encode).

The rANS state is u32 throughout; the renorm predicate x >= freq << 18 is
evaluated as (x >> 18) >= freq, which cannot overflow at freq = 2^14.
Lane seeds come back as int32 tensors holding the u32 bits.
"""

import time

import numpy as np
import torch

from .. import _build, native
from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..format import wide
from .wide_decode import _build_cdf, _schedule_tensor

_U32 = 0xFFFFFFFF


def plane_encode_ref(syms, rows, n_sym, plane_idx: int, steps: int, prior=None):
    """Plain version of plane_encode: one vectorised pass per chunk
    forward, one loop iteration per step backward; u32 states carried as
    int64 masked to 32 bits."""
    spec = wide.PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    B = syms[0].shape[0]
    dev = syms[0].device
    nsym = n_sym.long()
    lane = torch.arange(L, device=dev)
    active = (torch.arange(steps, device=dev)[:, None] * L + lane)[None] < nsym[:, None, None]

    carries, fences = [], []
    for r in range(R):
        nr, a = spec.rows[r], spec.alphabets[r]
        if prior is None:
            carries.append(torch.zeros(B, nr, a, dtype=torch.long, device=dev))
            f = torch.arange(a + 1, device=dev) * (CDF_SCALE_TOTAL // a)
            f[a] = CDF_SCALE_TOTAL
            fences.append(f.expand(B, nr, a + 1))
        else:
            carries.append(prior[r].long().reshape(1, nr, a).expand(B, nr, a).clone())
            fences.append(_build_cdf(carries[r], a))

    starts = torch.zeros(B, steps, R, L, dtype=torch.long, device=dev)
    freqs = torch.ones(B, steps, R, L, dtype=torch.long, device=dev)
    s0 = 0
    for clen in wide.chunk_schedule(steps):
        act = active[:, s0 : s0 + clen]  # [B, clen, L]
        for r in range(R):
            nr, a = spec.rows[r], spec.alphabets[r]
            y = syms[r].long().reshape(B, steps, L)[:, s0 : s0 + clen].clamp(0, a - 1)
            row = torch.zeros_like(y)
            if rows[r] is not None:
                row = rows[r].long().reshape(B, steps, L)[:, s0 : s0 + clen].clamp(0, nr - 1)
            fen = fences[r].reshape(B, nr * (a + 1))
            at = (row * (a + 1) + y).reshape(B, -1)
            st = fen.gather(1, at).reshape(y.shape)
            fq = fen.gather(1, at + 1).reshape(y.shape) - st
            starts[:, s0 : s0 + clen, r] = torch.where(act, st, 0)
            freqs[:, s0 : s0 + clen, r] = torch.where(act, fq, 1)
            cnt = torch.zeros(B, nr * a, dtype=torch.long, device=dev)
            cnt.scatter_add_(1, (row * a + y).reshape(B, -1), act.long().reshape(B, -1))
            carries[r] = (carries[r] >> 1) + cnt.reshape(B, nr, a)
            fences[r] = _build_cdf(carries[r], a)
        s0 += clen

    x = torch.full((B, L), 1 << 16, dtype=torch.long, device=dev)
    pairs = torch.empty(B, steps, R, L, dtype=torch.int32, device=dev)
    mask = torch.empty(B, steps, R, L, dtype=torch.bool, device=dev)
    for s in range(steps - 1, -1, -1):
        act = active[:, s]
        for r in range(R - 1, -1, -1):
            fq, st = freqs[:, s, r], starts[:, s, r]
            over = act & ((x >> 18) >= fq)
            pairs[:, s, r] = (x & 0xFFFF).to(torch.int32)
            mask[:, s, r] = over
            x1 = torch.where(over, x >> 16, x)
            x2 = (((x1 // fq) << CDF_SCALE_BITS) + x1 % fq + st) & _U32
            x = torch.where(act, x2, x)
    seeds = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)  # the u32 bits
    return seeds, pairs.reshape(B, steps * R * L), mask.reshape(B, steps * R * L)


def plane_encode(syms, rows, n_sym, plane_idx: int, steps: int, prior=None):
    """Encode one plane for all blocks.

    syms: per read r, [B, steps * L] symbols (uint8 or int32, one dtype);
    rows: per read r, [B, steps * L] int32 context rows, or None for row 0;
    n_sym [B] int32 symbol counts; prior: None, or per read [rows, alph]
    int32 warm-start counts. Returns (seeds [B, L] int32 holding the u32
    final lane states, pairs [B, steps * R * L] int32 renorm pair values,
    mask [B, steps * R * L] bool emission mask), in decode order.
    """
    if syms[0].device.type == "cpu":
        return plane_encode_ref(syms, rows, n_sym, plane_idx, steps, prior)
    spec = wide.PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    prior = (None,) * R if prior is None else prior
    rows = tuple(rows)
    _build.check_cuda("plane_encode", *syms, *rows, n_sym, *prior)
    B = syms[0].shape[0]
    dtypes = {s.dtype for s in syms}
    if (len(syms) != R or len(rows) != R or len(prior) != R or len(dtypes) != 1
            or not dtypes <= {torch.uint8, torch.int32}
            or any(s.shape != (B, steps * L) for s in syms)
            or any(w is not None and (w.shape != (B, steps * L) or w.dtype != torch.int32)
                   for w in rows)
            or any(p is not None and (p.numel() != spec.rows[r] * spec.alphabets[r]
                                      or p.dtype != torch.int32) for r, p in enumerate(prior))
            or n_sym.shape != (B,) or n_sym.dtype != torch.int32):
        raise ValueError("plane_encode: per read [B, steps*L] uint8 or int32 symbols, int32 "
                         "rows or None, int32 [rows, alph] priors or None; n_sym [B] int32")
    dev = syms[0].device
    desc = torch.tensor(
        [[s.data_ptr(), 0 if w is None else w.data_ptr(), 0 if p is None else p.data_ptr(),
          spec.alphabets[r], spec.rows[r]]
         for r, (s, w, p) in enumerate(zip(syms, rows, prior))],
        dtype=torch.int64, device=dev)
    sched = _schedule_tensor(steps, dev)
    K = steps * R * L
    span = torch.empty(B, K, dtype=torch.int32, device=dev)
    seeds = torch.empty(B, L, dtype=torch.int32, device=dev)
    pairs = torch.empty(B, K, dtype=torch.int32, device=dev)
    mask = torch.empty(B, K, dtype=torch.bool, device=dev)
    smem = 4 * sum(spec.rows[r] * (3 * spec.alphabets[r] + 1) for r in range(R))
    fn = _build.entry("plane_encode", "nlzm_plane_encode", 7, 7)
    _build.launch(fn, [desc.data_ptr(), n_sym.data_ptr(), sched.data_ptr(), span.data_ptr(),
                       seeds.data_ptr(), pairs.data_ptr(), mask.data_ptr()],
                  [B, L, R, steps, len(wide.chunk_schedule(steps)),
                   int(syms[0].dtype == torch.uint8), smem], dev)
    plane_encode.launches += 1
    return seeds, pairs, mask


plane_encode.launches = 0


# ------------------------------------------------------------ entry points


def stage_plane(batched, priors, plane_idx: int, device):
    """One plane's plane_encode arguments from batch_plane_arrays output,
    uploaded to `device`: (syms, rows, n_sym, plane_idx, steps, prior)."""
    spec = wide.PLANES[plane_idx]
    dev = torch.device(device)
    syms_p, rows_p, counts, _ = batched[spec.name]
    steps = syms_p[0].shape[1] // spec.lanes
    prior = None
    if priors is not None:
        prior = tuple(torch.as_tensor(np.asarray(priors[spec.name][r], np.int32), device=dev)
                      for r in range(spec.reads))
    sym_dtype = np.uint8 if max(spec.alphabets) <= 256 else np.int32  # a byte where it fits
    return (
        tuple(torch.as_tensor(np.asarray(s).astype(sym_dtype), device=dev) for s in syms_p),
        tuple(None if spec.rows[r] == 1 else
              torch.as_tensor(np.asarray(rows_p[r], np.int32), device=dev)
              for r in range(spec.reads)),
        torch.as_tensor(np.asarray(counts, np.int32), device=dev),
        plane_idx, steps, prior,
    )


def plane_streams(spec, steps: int, seeds, pairs, mask):
    """Host assembly of one plane: per block the stream bytes (u32le lane
    seeds, then the emitted pairs as u16be) and the chunk byte offsets
    [B, NC] (exclusive pair-count prefix x2 at each chunk start)."""
    seeds = seeds.cpu().numpy().view(np.uint32)
    pa = pairs.cpu().numpy()
    ma = mask.cpu().numpy()
    B = seeds.shape[0]
    sched = wide.chunk_schedule(steps)
    chunk_start_steps = np.cumsum((0,) + sched[:-1])
    pair_per_step = ma.reshape(B, steps, spec.reads * spec.lanes).sum(axis=2)
    cum = np.zeros((B, steps + 1), np.int64)
    np.cumsum(pair_per_step, axis=1, out=cum[:, 1:])
    offsets = 2 * cum[:, chunk_start_steps]
    seed_bytes = seeds.astype("<u4").view(np.uint8).reshape(B, 4 * spec.lanes)
    streams = [seed_bytes[b].tobytes() + pa[b][ma[b]].astype(">u2").tobytes()
               for b in range(B)]
    return streams, offsets


def encode_planes_device(batched, priors=None, *, device="cuda"):
    """Every plane's encode on `device`; returns per-plane (streams
    list[bytes], offsets [B, NC]) lists."""
    all_streams, all_offsets = [], []
    for i, spec in enumerate(wide.PLANES):
        args = stage_plane(batched, priors, i, device)
        streams, offsets = plane_streams(spec, args[4], *plane_encode(*args))
        all_streams.append(streams)
        all_offsets.append(offsets)
    return all_streams, all_offsets


def encode_wide_blocks_device(op_len, op_val, op_rep, with_priors: bool = True, *,
                              device="cuda"):
    """Encode [T, B] command arrays into per-block wide payloads, the
    plane encodes on `device`. Returns (payloads, priors_blob); the blob
    is b"" without priors. Byte-identical to the host encoders."""
    per_block, batched, plane_counts = wide.batch_plane_arrays(op_len, op_val, op_rep)
    priors, blob = None, b""
    if with_priors:
        priors = wide.build_priors_from_batched(batched)
        blob = wide.serialize_priors(priors)
    all_streams, all_offsets = encode_planes_device(batched, priors, device=device)
    return wide.assemble_payloads(per_block, plane_counts, all_streams, all_offsets), blob


def encode_pipeline_device(data: bytes, block_size: int, hist_bits: int = 15, *,
                           device="cuda"):
    """Timed device-encode pipeline: native parse, depth lift and rep
    classification on the host (parse_s), then stage() - plane batching,
    priors and upload, symbols as uint8 - and run(), the five plane
    encodes on `device` with completion forced by a checksum fetch.

    Returns (run, parse_s, stage, staging_first_s): the end-to-end rate is
    parse_s + best_of(stage) + best_of(run); staging_first_s is the first
    stage() call, which pays numpy's first-touch page faults.
    """
    t0 = time.perf_counter()
    op_len, op_val = native.parse_blocks(data, block_size, hist_bits)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    native.lift_deep(op_len, op_val, block_size)
    op_rep = native.classify_reps(op_len, op_val)
    parse_s = time.perf_counter() - t0

    staged = []

    def stage():
        staged.clear()
        _, batched, _ = wide.batch_plane_arrays(op_len, op_val, op_rep)
        priors = wide.build_priors_from_batched(batched)
        staged.extend(stage_plane(batched, priors, i, device) for i in range(wide.N_PLANES))

    t0 = time.perf_counter()
    stage()
    staging_first_s = time.perf_counter() - t0

    def run():
        acc = 0
        for args in staged:
            seeds, pairs, mask = plane_encode(*args)
            acc = acc + (seeds.long() & _U32).sum() + (pairs.long() * mask).sum()
        return int(acc)

    return run, parse_s, stage, staging_first_s
