"""Batched PPM-class codec (NLZC): the host encoder and the device decode,
in PyTorch with a CUDA kernel.

Counterpart of nlzm_tpu/research/ppm_tpu.py, whose docstring describes
the format: each block splits into 32 contiguous segments, one per rANS
lane; a byte is two nibble reads, against 4096-row order-2-class tables
(hi nibble keyed by the previous byte and the hi nibble of the one before
it, lo nibble by the hi nibble and the previous byte); the tables are
chunk-static, rebuilt every 16 steps after a 2/2/4/8 warmup from the
halved carry of realized counts, half the sum of the row's 16-row group,
8x the container prior and 2; the prior ships huff0-coded when the input
is at least PRIOR_MIN bytes.

The host side (constants, schedule, layout, prior, encode_blocks,
compress) is a copy of the original, pinned by tests/test_torch_host.py:
compress writes its bytes exactly, with the port's huff0.encode and
format/wide.py build_cdf. The decode stages a container's streams
over a list of devices (stage_sharded, which decodes the prior with
huff0's device engine; stage_container for one device) and runs
_decode_blocks on each: CPU tensors the plain version _decode_blocks_ref,
CUDA tensors csrc/ppm_decode.cu. Entry points run on "cuda" unless the
caller names another device, or shard the blocks over a mesh
(decompress(mesh=), as nlzm_tpu's; parallel/mesh.py).
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..format.wide import build_cdf
from ..ops.wide_decode import _build_cdf
from ..utils.shards import pad_blocks, shard_rows
from . import huff0

# NLZC's own adaptation cadence (decoupled from the wide profile's,
# which retunes as its lane counts evolve): rebuild every 16 steps after
# a 2/2/4/8-step warmup.
CHUNK_STEPS = 16
WARMUP_CHUNKS = (2, 2, 4, 8)


def chunk_schedule(steps_needed: int) -> tuple:
    sched, total = [], 0
    for w in WARMUP_CHUNKS:
        sched.append(w)
        total += w
        if total >= steps_needed:
            return tuple(sched)
    while total < steps_needed:
        sched.append(CHUNK_STEPS)
        total += CHUNK_STEPS
    return tuple(sched)


def padded_steps(n_sym: int, lanes: int) -> int:
    need = max(1, -(-n_sym // lanes))
    return sum(chunk_schedule(need))


MAGIC = b"NLZC"
VERSION = 4  # v4: 4096-row order-2-class contexts + container prior + backoff
LANES = 32
DEFAULT_BLOCK = 32768
ROWS = 4096
GROUP = 16  # rows per backoff group (same prev byte / same hi+prev-hi)
PRIOR_W = 8  # prior weight at every rebuild
PRIOR_QUANT = 64  # per-row max-norm scale of the shipped u8 prior
BLEND = 2  # uniform prior mass per cell at each rebuild (guards noise rows)
PRIOR_MIN = 65536  # ship the prior only for inputs at least this long


def _seg_lens(nb: int):
    """Per-lane segment lengths for a block of nb bytes."""
    S = -(-nb // LANES) if nb else 0
    lens = np.clip(nb - np.arange(LANES) * S, 0, max(S, 1)).astype(np.int64)
    return S, lens


def _rows_of(prev, prev2, hi):
    """(row0, row1) context rows: hi nibble keyed by full prev byte + prev2
    hi nibble; lo nibble keyed by current hi + full prev byte."""
    return (prev << 4) | (prev2 >> 4), (hi << 8) | prev


def _effective_counts(carry, prior):
    """Shared rebuild rule: carry + backoff group-sum + weighted prior.

    carry: [..., ROWS, 16] int64; prior: [ROWS, 16] int64 (quantized).
    Integer arithmetic only - must stay mirror-exact with the device
    rebuild of _decode_blocks.
    """
    shp = carry.shape[:-2]
    gs = carry.reshape(shp + (ROWS // GROUP, GROUP, 16)).sum(axis=-2)
    gs = np.repeat(gs, GROUP, axis=-2)
    return carry + gs // 2 + PRIOR_W * prior


def _layout(data_blocks):
    """Stack blocks -> per-(step, block, lane) symbol/context arrays."""
    B = len(data_blocks)
    lens = [len(b) for b in data_blocks]
    S_b = [-(-nb // LANES) if nb else 0 for nb in lens]
    steps = padded_steps(max(S_b) if S_b else 1, 1)
    sym = np.zeros((B, LANES, steps), np.int64)
    act = np.zeros((B, LANES, steps), bool)
    for b, blk in enumerate(data_blocks):
        arr = np.frombuffer(blk, np.uint8)
        Sb = S_b[b]
        for l in range(LANES):
            seg = arr[l * Sb : (l + 1) * Sb]
            sym[b, l, : len(seg)] = seg
            act[b, l, : len(seg)] = True
    prev = np.concatenate([np.zeros((B, LANES, 1), np.int64), sym[:, :, :-1]], axis=2)
    prev2 = np.concatenate([np.zeros((B, LANES, 2), np.int64), sym[:, :, :-2]], axis=2)
    tr = lambda a: np.ascontiguousarray(a.transpose(2, 0, 1))  # [steps, B, L]
    return tr(sym), tr(prev), tr(prev2), tr(act), steps


def build_prior(sym, prev, prev2, act):
    """Pass 1: global per-row counts, u8-quantized (max-norm * 64)."""
    hi, lo = sym >> 4, sym & 15
    r0, r1 = _rows_of(prev, prev2, hi)
    prior = np.zeros((2, ROWS, 16), np.int64)
    np.add.at(prior[0], (r0[act], hi[act]), 1)
    np.add.at(prior[1], (r1[act], lo[act]), 1)
    mx = np.maximum(prior.max(axis=2, keepdims=True), 1)
    return (prior * PRIOR_QUANT) // mx  # [2, ROWS, 16], values 0..64


def encode_blocks(data_blocks, prior):
    """Pass 2: batched table simulation + backward rANS for all blocks.

    -> list of per-block stream bytes (seeds + renorm pairs, decode
    order)."""
    B = len(data_blocks)
    sym, prev, prev2, act, steps = _layout(data_blocks)
    hi, lo = sym >> 4, sym & 15
    r0, r1 = _rows_of(prev, prev2, hi)

    t = [np.broadcast_to(
            build_cdf(PRIOR_W * prior[r] + BLEND, 16), (B, ROWS, 17)).copy()
         for r in range(2)]
    c = [np.zeros((B, ROWS, 16), np.int64) for _ in range(2)]
    carry = [np.zeros((B, ROWS, 16), np.int64) for _ in range(2)]
    bounds = set(np.cumsum(chunk_schedule(steps)) - 1)
    bidx = np.repeat(np.arange(B), LANES)

    starts = np.zeros((steps, 2, B, LANES), np.int64)
    freqs = np.ones((steps, 2, B, LANES), np.int64)
    for tstep in range(steps):
        a = act[tstep].ravel()
        for r, (rr, yy) in enumerate(((r0[tstep], hi[tstep]), (r1[tstep], lo[tstep]))):
            rrf, yyf = rr.ravel(), yy.ravel()
            st = t[r][bidx, rrf, yyf]
            fq = t[r][bidx, rrf, yyf + 1] - st
            starts[tstep, r] = np.where(a, st, 0).reshape(B, LANES)
            freqs[tstep, r] = np.where(a, fq, 1).reshape(B, LANES)
            np.add.at(c[r], (bidx[a], rrf[a], yyf[a]), 1)
        if tstep in bounds:
            for r in range(2):
                carry[r] = (carry[r] >> 1) + c[r]
                c[r][:] = 0
                t[r] = build_cdf(_effective_counts(carry[r], prior[r]) + BLEND, 16)

    # backward interleaved rANS, batched over blocks
    x = np.full((B, LANES), 1 << 16, np.uint64)
    pair_all = np.zeros((steps * 2, B, LANES), np.uint16)
    mask_all = np.zeros((steps * 2, B, LANES), bool)
    for tstep in range(steps - 1, -1, -1):
        a = act[tstep]
        for r in (1, 0):
            fq = freqs[tstep, r].astype(np.uint64)
            st = starts[tstep, r].astype(np.uint64)
            over = a & (x >= (fq << 18))
            pair_all[tstep * 2 + r] = (x & 0xFFFF).astype(np.uint16)
            mask_all[tstep * 2 + r] = over
            x1 = np.where(over, x >> 16, x)
            x2 = ((x1 // fq) << CDF_SCALE_BITS) + (x1 % fq) + st
            x = np.where(a, x2, x)

    out = []
    for b in range(B):
        s = x[b].astype("<u4").view(np.uint8).tobytes()
        s += pair_all[:, b][mask_all[:, b]].astype(">u2").tobytes()
        out.append(s)
    return out


def compress(data: bytes, block_size: int = DEFAULT_BLOCK) -> bytes:
    nblocks = -(-len(data) // block_size) if data else 0
    blocks = [data[b * block_size : (b + 1) * block_size] for b in range(nblocks)]
    prior = np.zeros((2, ROWS, 16), np.int64)
    if nblocks:
        if len(data) >= PRIOR_MIN:
            sym, prev, prev2, act, _ = _layout(blocks)
            prior = build_prior(sym, prev, prev2, act)
        streams = encode_blocks(blocks, prior)
    else:
        streams = []
    out = bytearray()
    out += MAGIC
    out += bytes([VERSION, LANES])
    out += block_size.to_bytes(4, "big")
    out += len(data).to_bytes(8, "big")
    out += nblocks.to_bytes(4, "big")
    if len(data) >= PRIOR_MIN:
        # v4 priors are dense (4096 rows of u8 quantized counts): RLE
        # expands them ~1.5x; the repo's huff0 gets raw 128 KiB -> ~60 KiB
        enc = huff0.encode(prior.astype(np.uint8).tobytes())
        out += len(enc).to_bytes(4, "big")
        out += enc
    for s in streams:
        out += len(s).to_bytes(4, "big")
    for s in streams:
        out += s
    return bytes(out)


# ---------------------------------------------------------------- device decode


def parse_container(blob: bytes):
    """Header fields and sections of an NLZC v4 container: (block_size,
    total_len, prior_bytes (the huff0 container of the prior, or None
    below PRIOR_MIN), per-block stream bytes). Raises ValueError on a
    wrong magic, version or lane count."""
    if blob[:4] != MAGIC or blob[4] != VERSION or blob[5] != LANES:
        raise ValueError("not an NLZC v4 stream (bad magic/version/lanes)")
    block_size = int.from_bytes(blob[6:10], "big")
    total_len = int.from_bytes(blob[10:18], "big")
    nblocks = int.from_bytes(blob[18:22], "big")
    off = 22
    prior_bytes = None
    if total_len >= PRIOR_MIN:
        enc_n = int.from_bytes(blob[off : off + 4], "big")
        off += 4
        prior_bytes = blob[off : off + enc_n]
        off += enc_n
    sizes = []
    for _ in range(nblocks):
        sizes.append(int.from_bytes(blob[off : off + 4], "big"))
        off += 4
    streams = []
    for sz in sizes:
        streams.append(blob[off : off + sz])
        off += sz
    return block_size, total_len, prior_bytes, streams


def decode_prior(prior_bytes, device) -> np.ndarray:
    """The container prior [2, ROWS, 16] int64: huff0-decoded on `device`
    (its device engine), or zeros when the container ships none."""
    if prior_bytes is None:
        return np.zeros((2, ROWS, 16), np.int64)
    raw = huff0.decode(prior_bytes, engine="device", device=device)
    if len(raw) != 2 * ROWS * 16:
        raise ValueError("corrupt NLZC prior (bad huff0 payload size)")
    return np.frombuffer(raw, np.uint8).astype(np.int64).reshape(2, ROWS, 16)


class Layout(NamedTuple):
    """What reassemble needs besides the decoded bytes: seg [B, 32] the
    segment lengths (numpy; None with no blocks) and the byte count."""

    seg: np.ndarray | None
    total_len: int


def stage_streams(streams, block_size: int, total_len: int, prior, shards):
    """-> (args, layout): args a list, shard i's arguments of _decode_blocks
    on shards[i] (words [R, W] int32 holding each block's stream as
    little-endian u32 words, zero-padded by at least 2 words; seg_lens
    [R, 32] int32; prior [2, ROWS, 16] int32; steps), layout the Layout of
    reassemble. Each block segments by its own length (the last may be
    short).

    shards: a sequence of devices, [device] for one, or a mesh
    (parallel/mesh.py::make_mesh). The rows pad to a multiple of its
    length with zero words and zero segment lengths, and shard i holds
    rows utils/shards.py::shard_rows (W and steps those of all the
    blocks; the prior uploaded once a distinct device)."""
    B = len(streams)
    n = len(shards)
    wmax = (max(len(s) for s in streams) + 3) // 4 + 2
    arr = np.zeros((B, 4 * wmax), np.uint8)
    for b, s in enumerate(streams):
        arr[b, : len(s)] = np.frombuffer(s, np.uint8)
    arr, _ = pad_blocks(arr, n)
    a4 = arr.reshape(arr.shape[0], wmax, 4).astype(np.uint32)
    words = (a4[:, :, 0] | (a4[:, :, 1] << 8) | (a4[:, :, 2] << 16) | (a4[:, :, 3] << 24)
             ).view(np.int32)

    nb = np.minimum(np.full(B, block_size, np.int64), total_len - np.arange(B) * block_size)
    S_b = -(-nb // LANES)
    seg = np.clip(nb[:, None] - np.arange(LANES)[None, :] * S_b[:, None], 0, S_b[:, None])
    seg_rows, _ = pad_blocks(seg.astype(np.int32), n)
    steps = padded_steps(int(S_b.max()), 1)
    prior = np.asarray(prior, np.int32)
    priors, args = {}, []
    for i, d in enumerate(shards):
        dev = torch.device(d)
        if dev not in priors:
            priors[dev] = torch.as_tensor(prior, device=dev)
        lo, hi = shard_rows(words.shape[0], n, i)
        args.append((torch.as_tensor(words[lo:hi], device=dev),
                     torch.as_tensor(seg_rows[lo:hi], device=dev), priors[dev], steps))
    return args, Layout(seg, total_len)


def stage_sharded(blob: bytes, shards):
    """Parse an NLZC container and stage its decode over `shards` (as in
    stage_streams; nlzm_tpu's stage_container(mesh=)): -> (args, layout),
    args None with no blocks. The prior decodes on shards[0]."""
    block_size, total_len, prior_bytes, streams = parse_container(blob)
    prior = decode_prior(prior_bytes, shards[0])
    if not streams:
        return None, Layout(None, total_len)
    return stage_streams(streams, block_size, total_len, prior, shards)


def stage_container(blob: bytes, device="cuda"):
    """Parse an NLZC container and stage its decode on `device`:
    stage_sharded over [device], args the arguments of _decode_blocks
    there (None with no blocks)."""
    args, layout = stage_sharded(blob, [device])
    return (None if args is None else args[0]), layout


def reassemble(out, layout: Layout) -> bytes:
    """Plain bytes from _decode_blocks' [B, steps, LANES] output: block by
    block, lane by lane, the first seg[b, l] bytes of each segment."""
    o = out.cpu().numpy().transpose(0, 2, 1)  # [B, LANES, steps]
    keep = np.arange(o.shape[2])[None, None, :] < layout.seg[:, :, None]
    return o[keep].tobytes()[: layout.total_len]


def decompress(blob: bytes, device="cuda", mesh=None) -> bytes:
    """Batched device decode of an NLZC container on `device`, or with its
    blocks sharded over a mesh (a sequence of devices,
    parallel/mesh.py::make_mesh; nlzm_tpu's decompress(mesh=)): each
    shard decodes on its device and the blocks come back in order."""
    args, layout = stage_sharded(blob, [device] if mesh is None else mesh)
    if args is None:
        return b""
    outs = [_decode_blocks(*a) for a in args]
    return reassemble(torch.cat([o.cpu() for o in outs])[: len(layout.seg)], layout)


_U32 = 0xFFFFFFFF
WIN_H = 2 * ((2 * LANES * 2) // 4 + 2)  # halfwords of JAX's per-step window


def _tables_of(carry, prior):
    """Fences [B, 2, ROWS, 17] from carries [B, 2, ROWS, 16] (int64): the
    rebuild rule, eff = carry + groupsum // 2 + 8 * prior + 2, then the
    fence rule of build_cdf with 16 symbols."""
    B = carry.shape[0]
    gs = carry.reshape(B, 2, ROWS // GROUP, GROUP, 16).sum(3).repeat_interleave(GROUP, dim=2)
    return _build_cdf(carry + gs // 2 + PRIOR_W * prior + BLEND, 16)


def _check_prior(prior) -> None:
    """Raise ValueError unless every prior value is in 0..255 (one
    torch.aminmax). A container's prior is u8 (decode_prior), and the
    kernel's u16 tables and 32-bit division hold for that domain; past it
    JAX's int32 sums wrap and tot + 1 can reach 0, whose quotient XLA
    leaves undefined, so there is no single answer to match."""
    if prior.numel():
        lo, hi = torch.aminmax(prior)
        if bool((lo < 0) | (hi > 255)):  # one copy back
            raise ValueError("ppm_decode: prior values must be in 0..255")


def _decode_blocks_ref(words, seg_lens, prior, steps: int):
    """Plain version of _decode_blocks: one loop iteration per step and
    read, blocks and lanes as tensors, u32 states carried as int64; every
    chunk rebuilds every row of both tables, as JAX does. Raises
    ValueError for a prior outside 0..255."""
    _check_prior(prior)
    B, W = words.shape
    dev = words.device
    w = words.long() & _U32
    seg = seg_lens.long()
    pri = prior.long().reshape(2, ROWS, 16)
    carry = torch.zeros(B, 2, ROWS, 16, dtype=torch.long, device=dev)
    tables = _tables_of(carry, pri)
    x = w[:, :LANES].clone()
    cursor = torch.full((B, 1), 4 * LANES, dtype=torch.long, device=dev)
    prev = torch.zeros(B, LANES, dtype=torch.long, device=dev)
    prev2 = torch.zeros_like(prev)
    out = torch.zeros(B, steps, LANES, dtype=torch.uint8, device=dev)
    fidx = torch.arange(17, device=dev)

    def read(r, row, a, base, counts):
        nonlocal x, cursor
        tbl = tables[:, r].reshape(B, ROWS * 17).gather(
            1, (row[:, :, None] * 17 + fidx).reshape(B, LANES * 17)).reshape(B, LANES, 17)
        f = x & 0x3FFF
        y = (f[:, :, None] >= tbl[:, :, 1:]).sum(-1)
        start = tbl.gather(2, y[:, :, None])[:, :, 0]
        freq = tbl.gather(2, (y + 1)[:, :, None])[:, :, 0] - start
        x2 = (freq * (x >> CDF_SCALE_BITS) + (f - start)) & _U32
        ren = a & (x2 < (1 << 16))
        rr = ren.long()
        rank = rr.cumsum(1) - rr
        # the big-endian pair at byte cursor + 2 * rank, from the window of
        # words base .. base + 33 (clamped to the stream) read at step start
        h = ((cursor + 2 * rank - 4 * base) >> 1).clamp(0, WIN_H - 1)
        word = w.gather(1, (base + (h >> 1)).clamp(0, W - 1))
        half = (word >> (16 * (h & 1))) & 0xFFFF
        pair = ((half & 0xFF) << 8) | (half >> 8)
        x = torch.where(a, torch.where(ren, ((x2 << 16) | pair) & _U32, x2), x)
        cursor = cursor + 2 * rr.sum(1, keepdim=True)
        y = torch.where(a, y, 0)
        counts[:, r].scatter_add_(1, row * 16 + y, a.long())
        return y

    s = 0
    for clen in chunk_schedule(steps):
        counts = torch.zeros(B, 2, ROWS * 16, dtype=torch.long, device=dev)
        for _ in range(clen):
            a = s < seg
            base = cursor >> 2
            hi = read(0, (prev << 4) | (prev2 >> 4), a, base, counts)
            lo = read(1, (hi << 8) | prev, a, base, counts)
            byte = (hi << 4) | lo
            prev2 = torch.where(a, prev, prev2)
            prev = torch.where(a, byte, prev)
            out[:, s] = byte.to(torch.uint8)
            s += 1
        carry = (carry >> 1) + counts.reshape(B, 2, ROWS, 16)
        tables = _tables_of(carry, pri)
    return out


# csrc/ppm_decode.cu's TABLES_INTS: a block's tables scratch in int32, the
# slots built past the shared-memory cache (1024 x 16 u16) and its counters
TABLES_INTS = 1024 * 16 // 2 + 8
BUILT = ("rows", "groups", "group_sums", "batches", "spilled_rows")


def _decode_blocks(words, seg_lens, prior, steps: int):
    """Decode every block's 32 lanes in lockstep -> bytes [B, steps, 32]
    uint8 (nlzm_tpu's _decode_blocks gives the same values as int32).

    words [B, W] int32 (u32 bits, W >= 32: the first 32 words are the
    lane seeds); seg_lens [B, 32] int32; prior [2, ROWS, 16] int32, every
    value in 0..255 (else ValueError); steps a sum of chunk_schedule. A
    lane at or past its segment length emits 0. The renorm pair of a lane
    is the big-endian u16 at byte cursor + 2 * rank of its block's stream
    (rank: the lane's place among the block's renorming lanes), read from
    a window of 34 words clamped to the stream as JAX clamps it.
    """
    if words.device.type == "cpu":
        return _decode_blocks_ref(words, seg_lens, prior, steps)
    return _decode_blocks_cuda(words, seg_lens, prior, steps)[0]


def _decode_blocks_cuda(words, seg_lens, prior, steps: int):
    """_decode_blocks on CUDA tensors: csrc/ppm_decode.cu, one launch ->
    (out, built): built [B, len(BUILT)] int32, each block's counters of
    the launch (rows built, distinct groups summed, group sums, batches,
    rows built into device memory)."""
    _check_prior(prior)
    sched = chunk_schedule(steps)
    if sum(sched) != steps:  # the kernel writes every step of the schedule
        raise ValueError(f"ppm_decode: steps {steps} is not a sum of chunk_schedule")
    _build.check_cuda("ppm_decode", words, seg_lens, prior)
    B, W = words.shape
    if (words.dtype != torch.int32 or W < LANES or seg_lens.dtype != torch.int32
            or seg_lens.shape != (B, LANES) or prior.dtype != torch.int32
            or prior.shape != (2, ROWS, 16)):
        raise ValueError("ppm_decode: words [B,W>=32] int32, seg_lens [B,32] int32, prior "
                         "[2,4096,16] int32")
    dev = words.device
    sched = torch.tensor(sched, dtype=torch.int32, device=dev)
    carry = torch.empty(B, 2 * ROWS, 16, dtype=torch.int16, device=dev)
    tables = torch.empty(B, TABLES_INTS, dtype=torch.int32, device=dev)
    out = torch.empty(B, steps, LANES, dtype=torch.uint8, device=dev)
    fn = _build.entry("ppm_decode", "nlzm_ppm_decode", 7, 4)
    _build.launch(fn, [words.data_ptr(), seg_lens.data_ptr(), prior.data_ptr(), sched.data_ptr(),
                       carry.data_ptr(), tables.data_ptr(), out.data_ptr()],
                  [B, W, steps, sched.numel()], dev)
    _decode_blocks.launches += 1
    return out, tables[:, TABLES_INTS - 8 : TABLES_INTS - 8 + len(BUILT)]


_decode_blocks.launches = 0
