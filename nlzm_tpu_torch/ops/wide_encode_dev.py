"""Wide-profile plane encode on a PyTorch device, with a CUDA kernel.

Counterpart of nlzm_tpu/ops/wide_encode_dev.py. plane_encode runs the
decoder's chunk-adaptive tables forward against the known symbols,
recording each symbol's (start, freq), then advances L interleaved rANS
lanes backward, emitting 16-bit renorm pairs where the host encoder
does; csrc/plane_encode.cu is the kernel, plane_encode_ref its plain
PyTorch version (CPU tensors run the plain version, CUDA tensors launch
the kernel). plane_encode_planes encodes a batch's five planes in one
launch; the device encodes run it. The payloads are byte-identical to the
host encoders' (nlzm_tpu's numpy format.wide.encode_wide_blocks and
native.wide_encode).

The rANS state is u32 throughout; the renorm predicate x >= freq << 18 is
evaluated as (x >> 18) >= freq, which cannot overflow at freq = 2^14.
Lane seeds come back as int32 tensors holding the u32 bits.
"""

import functools
import time

import numpy as np
import torch

from .. import _build, native
from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..format import wide
from .wide_decode import _build_cdf, _check_priors

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


PE_SMEM_MAX = 224 * 1024  # shared bytes a plane's keys and tables may take (csrc/plane_encode.cu)
PE_MAX_READS = 8
PE_THREADS = 256  # threads a CTA; a lane a thread in the backward pass
PE_MAX_LANES = PE_THREADS


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def plane_layout(spec, steps: int) -> tuple[int, bool, int]:
    """Where csrc/plane_encode.cu keeps a plane of `steps` steps: (shared
    bytes a CTA, large, device scratch bytes a block). A plane fits when
    its keys (a byte each, two past 256 entries a read) and every chunk's
    counts (i32) and fences (u16) take at most PE_SMEM_MAX; a large plane
    keeps counts and fences in device scratch and needs shared memory
    only for a window of chunks' fences (at least one chunk)."""
    R, L = spec.reads, spec.lanes
    nc = len(wide.chunk_schedule(steps))
    kc = sum(spec.rows[r] * spec.alphabets[r] for r in range(R))
    kf = sum(spec.rows[r] * (spec.alphabets[r] + 1) for r in range(R))
    maxkey = max(spec.rows[r] * spec.alphabets[r] for r in range(R))
    keys = _align16(steps * L * R * (2 if maxkey > 256 else 1))
    tables = _align16(nc * kc * 4) + _align16(nc * kf * 2)
    if maxkey <= 1 << 16 and keys + tables <= PE_SMEM_MAX:
        return keys + tables, False, 0
    if 2 * kf > PE_SMEM_MAX:
        raise ValueError(f"plane_encode: one chunk's fences ({2 * kf} bytes) pass shared memory")
    return min(_align16(nc * kf * 2), PE_SMEM_MAX), True, tables


def _check_plane(args):
    """plane_encode's argument checks for one plane's (syms, rows, n_sym,
    plane_idx, steps, prior); returns them with rows and prior as tuples."""
    syms, rows, n_sym, plane_idx, steps, prior = args
    spec = wide.PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    prior = (None,) * R if prior is None else tuple(prior)
    rows = tuple(rows)
    _build.check_cuda("plane_encode", *syms, *rows, n_sym, *prior)
    B = syms[0].shape[0]
    dtypes = {s.dtype for s in syms}
    if (len(syms) != R or len(rows) != R or len(prior) != R or len(dtypes) != 1
            or not dtypes <= {torch.uint8, torch.int32}
            or not 1 <= R <= PE_MAX_READS or not 1 <= L <= PE_MAX_LANES
            or steps < 0 or steps * L * R >= 1 << 31
            or any(s.shape != (B, steps * L) for s in syms)
            or any(w is not None and (w.shape != (B, steps * L) or w.dtype != torch.int32)
                   for w in rows)
            or any(p is not None and (p.numel() != spec.rows[r] * spec.alphabets[r]
                                      or p.dtype != torch.int32) for r, p in enumerate(prior))
            or n_sym.shape != (B,) or n_sym.dtype != torch.int32):
        raise ValueError("plane_encode: per read [B, steps*L] uint8 or int32 symbols, int32 "
                         "rows or None, int32 [rows, alph] priors or None; n_sym [B] int32; "
                         f"at most {PE_MAX_READS} reads and {PE_MAX_LANES} lanes")
    return syms, rows, n_sym, plane_idx, steps, prior


def launch_plan(shapes):
    """csrc/plane_encode.cu's grid for planes given as (spec, steps, B):
    ([(plane, first CTA, large, scratch offset)] in launch order, the
    launch's shared bytes a CTA, the scratch bytes). A CTA a (block,
    plane); the planes with the longest chains (steps x reads) first."""
    order = sorted(range(len(shapes)), key=lambda i: -shapes[i][1] * shapes[i][0].reads)
    plan, cta, smem, scratch = [], 0, 0, 0
    for i in order:
        spec, steps, B = shapes[i]
        need, large, per_block = plane_layout(spec, steps)
        plan.append((i, cta, large, scratch))
        cta += B
        smem = max(smem, need)
        scratch += B * per_block
    return plan, smem, scratch


def _launch_planes(planes):
    """One launch of csrc/plane_encode.cu for checked planes; returns their
    (seeds, pairs, mask) in the given order, pieces of one int32 and one
    bool buffer (each 16-element, so 16-byte, aligned). The kernel reads
    each plane's 51 int64 fields (csrc/plane_encode.cu PE_FIELDS) from the
    host."""
    dev = planes[0][0][0].device
    plan, smem, scratch_bytes = launch_plan(
        [(wide.PLANES[p[3]], p[4], p[2].shape[0]) for p in planes])
    shapes, n32, n8 = [], [], []  # per plane (B, L, K); the buffers' pieces
    for p in planes:
        spec = wide.PLANES[p[3]]
        B, L = p[2].shape[0], spec.lanes
        K = p[4] * spec.reads * L
        shapes.append((B, L, K))
        n32 += [B * L, _align16(B * L) - B * L, B * K, _align16(B * K) - B * K]
        n8 += [B * K, _align16(B * K) - B * K]
    ints = torch.empty(sum(n32), dtype=torch.int32, device=dev).split(n32)
    flags = torch.empty(sum(n8), dtype=torch.bool, device=dev).split(n8)
    outs = [(ints[4 * i].view(B, L), ints[4 * i + 2].view(B, K), flags[2 * i].view(B, K))
            for i, (B, L, K) in enumerate(shapes)]
    fields = []
    for i, _, large, offset in plan:
        syms, rows, n_sym, plane_idx, steps, prior = planes[i]
        spec = wide.PLANES[plane_idx]
        pad = [0] * (8 - spec.reads)
        fields.append([s.data_ptr() for s in syms] + pad
                      + [0 if w is None else w.data_ptr() for w in rows] + pad
                      + [0 if q is None else q.data_ptr() for q in prior] + pad
                      + list(spec.alphabets) + pad + list(spec.rows) + pad
                      + [t.data_ptr() for t in (*outs[i], n_sym)]
                      + [n_sym.shape[0], spec.lanes, spec.reads, steps,
                         int(syms[0].dtype == torch.uint8), int(large), offset])
    fields = np.array(fields, np.int64)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    fn = _build.entry("plane_encode", "nlzm_plane_encode", 2, 2)
    _build.launch(fn, [fields.ctypes.data, 0 if scratch is None else scratch.data_ptr()],
                  [len(planes), smem], dev)
    plane_encode.launches += 1
    return outs


def plane_encode(syms, rows, n_sym, plane_idx: int, steps: int, prior=None):
    """Encode one plane for all blocks.

    syms: per read r, [B, steps * L] symbols (uint8 or int32, one dtype);
    rows: per read r, [B, steps * L] int32 context rows, or None for row 0;
    n_sym [B] int32 symbol counts; prior: None, or per read [rows, alph]
    int32 warm-start counts, each value in 0..65535 as a container holds
    them (else ValueError). Returns (seeds [B, L] int32 holding the u32
    final lane states, pairs [B, steps * R * L] int32 renorm pair values,
    mask [B, steps * R * L] bool emission mask), in decode order.
    """
    if syms[0].device.type == "cpu":
        _check_priors(prior, "plane_encode")
        return plane_encode_ref(syms, rows, n_sym, plane_idx, steps, prior)
    plane = _check_plane((syms, rows, n_sym, plane_idx, steps, prior))
    _check_priors(plane[5], "plane_encode")
    return _launch_planes([plane])[0]


plane_encode.launches = 0


def plane_encode_planes(staged):
    """Encode several planes of one batch (stage_plane's argument tuples,
    at most five, one device) in one launch; returns their (seeds, pairs,
    mask) triples in order. Counted in plane_encode.launches. The plain
    version (CPU tensors) is plane_encode_ref on each plane. A prior value
    outside 0..65535 raises ValueError (one copy back for CUDA priors)."""
    return _plane_encode_planes(staged, check_priors=True)


def _plane_encode_planes(staged, check_priors: bool = False):
    """plane_encode_planes; without check_priors, for planes whose priors
    stage_plane checked on the host before their upload (the wide device
    encodes: no device-to-host copy)."""
    staged = list(staged)
    if not 1 <= len(staged) <= wide.N_PLANES or any(len(a) != 6 for a in staged):
        raise ValueError(f"plane_encode_planes: 1 to {wide.N_PLANES} planes of plane_encode "
                         f"arguments")
    priors = lambda planes: [p for a in planes if a[5] is not None for p in a[5]]
    devs = {a[0][0].device.type for a in staged}
    if devs == {"cpu"}:
        if check_priors:
            _check_priors(priors(staged), "plane_encode_planes")
        return [plane_encode_ref(*a) for a in staged]
    planes = [_check_plane(a) for a in staged]
    if len({p[0][0].device for p in planes}) != 1:
        raise ValueError("plane_encode_planes: every plane on one device")
    if check_priors:
        _check_priors(priors(planes), "plane_encode_planes")
    return _launch_planes(planes)


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
        host = [np.asarray(priors[spec.name][r]) for r in range(spec.reads)]
        _check_priors(host, "stage_plane")  # on the host, before the upload
        prior = tuple(torch.as_tensor(a.astype(np.int32), device=dev) for a in host)
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
    staged = [stage_plane(batched, priors, i, device) for i in range(wide.N_PLANES)]
    all_streams, all_offsets = [], []
    for spec, args, out in zip(wide.PLANES, staged, _plane_encode_planes(staged)):
        streams, offsets = plane_streams(spec, args[4], *out)
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
    priors and upload, symbols as uint8 - and run(), the five planes'
    encode on `device` (one launch) with completion forced by a checksum
    fetch.

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
        for seeds, pairs, mask in _plane_encode_planes(staged):
            acc = acc + (seeds.long() & _U32).sum() + (pairs.long() * mask).sum()
        return int(acc)

    return run, parse_s, stage, staging_first_s
