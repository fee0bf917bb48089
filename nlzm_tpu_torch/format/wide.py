"""NLZP wide profile: the format tables, payload parsing, and the host
side of the device encode.

A copy of the parts of nlzm_tpu/format/wide.py the port runs, which
defines the format (the numpy plane encoder, the host reference decoder
and the format description stay there; the port's plane encoder is
ops/wide_encode_dev.py). tests/test_torch_host.py pins every piece here
to the original: the plane table, the chunk schedule, the fence rule
(build_cdf, which the NLZC encoder of research/ppm_tpu.py also runs), the
parsed payloads and priors of real containers, the command
classification into plane arrays, the priors and the payload assembly.

Block payload layout (big-endian): per plane u32 sym_count, u32
stream_bytes; u32 bits_bytes; per plane u16 x (NC - 1) chunk pair-count
deltas; the five plane streams (L x u32le lane seeds, then renorm pairs in
decode order); the raw-bit plane (MSB-first).
"""

from dataclasses import dataclass

import numpy as np

from ..constants import CDF_SCALE_TOTAL

CHUNK_STEPS = 8  # steady-state table rebuild cadence (in scan steps)
WARMUP_CHUNKS = (2, 2, 4, 8)  # short early chunks: fast model warmup


def chunk_schedule(steps_needed: int) -> tuple:
    """Chunk lengths covering >= steps_needed (warmup then steady)."""
    sched = []
    total = 0
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
    """Total scan steps (= sum of the chunk schedule) for n_sym symbols."""
    need = max(1, -(-n_sym // lanes))
    return sum(chunk_schedule(need))


@dataclass(frozen=True)
class PlaneSpec:
    name: str
    lanes: int
    reads: int  # CDF reads per symbol
    alphabets: tuple  # per read
    rows: tuple  # context rows per read


# Wire v4: every plane is single-read over a joint alphabet, no context rows.
PLANES = (
    PlaneSpec("tok", 64, 1, (4,), (1,)),
    PlaneSpec("lit", 64, 1, (256,), (1,)),
    PlaneSpec("len", 32, 1, (8,), (1,)),
    PlaneSpec("lex", 16, 1, (256,), (1,)),
    PlaneSpec("dst", 32, 1, (64,), (1,)),
)
N_PLANES = len(PLANES)
HDR_BYTES = 8 * N_PLANES + 4

TOK_LIT, TOK_DICT, TOK_REP = 0, 1, 2


def build_cdf(counts: np.ndarray, nsym: int) -> np.ndarray:
    """Deterministic fence table from symbol counts.

    counts: [..., nsym] -> fences [..., max(nsym, 16) + 1] with
    fence[0]=0 and fence[nsym..]=2^14; every symbol keeps freq >= 1 (the
    last symbol absorbs rounding slack). Width floors at 17 for the
    16-symbol consumers (research/ppm_tpu).
    """
    width = max(nsym, 16) + 1
    tot = counts.sum(axis=-1, keepdims=True)
    freq = 1 + (counts * (CDF_SCALE_TOTAL - nsym)) // (tot + 1)
    fences = np.zeros(counts.shape[:-1] + (width,), np.int32)
    np.cumsum(freq, axis=-1, out=fences[..., 1 : nsym + 1])
    fences[..., nsym:] = CDF_SCALE_TOTAL
    return fences


def parse_priors(blob: bytes):
    """Container priors blob -> {plane name: per read [rows, alphabet] int64}."""
    priors = {}
    off = 0
    for spec in PLANES:
        pr = []
        for r in range(spec.reads):
            n = spec.rows[r] * spec.alphabets[r]
            a = np.frombuffer(blob, ">u2", n, off).astype(np.int64)
            pr.append(a.reshape(spec.rows[r], spec.alphabets[r]))
            off += 2 * n
        priors[spec.name] = pr
    return priors


def priors_blob_size() -> int:
    return 2 * sum(
        spec.rows[r] * spec.alphabets[r]
        for spec in PLANES
        for r in range(spec.reads)
    )


PRIOR_ROW_BUDGET = 256  # per-row prior mass (carry-scale counts)


def build_priors(syms_all, rows_all, masks_all):
    """Global per-plane (row, symbol) prior counts from batched arrays.

    syms_all/rows_all: {plane: per-read [B, T_pad] arrays}; masks_all:
    {plane: [B, T_pad] active}. rows_all entries may be None for
    single-row reads. Rows scale to PRIOR_ROW_BUDGET total.
    """
    priors = {}
    for spec in PLANES:
        pr = []
        for r in range(spec.reads):
            h = np.zeros((spec.rows[r], spec.alphabets[r]), np.int64)
            m = masks_all[spec.name]
            sy = syms_all[spec.name][r][m]
            rows = rows_all[spec.name][r]
            if rows is None or spec.rows[r] == 1:
                h[0] = np.bincount(sy, minlength=spec.alphabets[r])[: spec.alphabets[r]]
            else:
                np.add.at(h, (rows[m], sy), 1)
            tot = h.sum(axis=1, keepdims=True)
            pr.append((h * PRIOR_ROW_BUDGET) // np.maximum(tot, 1))
        priors[spec.name] = pr
    return priors


def build_priors_from_batched(batched):
    """Container-level warm-start priors from batch_plane_arrays output."""
    return build_priors(
        {n: v[0] for n, v in batched.items()},
        {n: v[1] for n, v in batched.items()},
        {n: v[3] for n, v in batched.items()},
    )


def serialize_priors(priors) -> bytes:
    out = bytearray()
    for spec in PLANES:
        for r in range(spec.reads):
            out += priors[spec.name][r].astype(">u2").tobytes()
    return bytes(out)


def _pack_bits(widths: np.ndarray, values: np.ndarray) -> bytes:
    """MSB-first bit packing of (width, value) fields (single block)."""
    total = int(widths.sum())
    if total == 0:
        return b""
    offs = np.cumsum(widths) - widths
    w_rep = np.repeat(widths, widths)
    v_rep = np.repeat(values, widths)
    idx_within = np.arange(total) - np.repeat(offs, widths)
    bits = (v_rep >> (w_rep - 1 - idx_within)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def mmin_of(delta: np.ndarray) -> np.ndarray:
    """Distance-dependent minimum match length (dtype-preserving)."""
    one = delta.dtype.type(1)
    return (
        2 * one
        + (delta > 0xFF).astype(delta.dtype)
        + (delta > 0xFFF).astype(delta.dtype)
        + (delta > 0xFFFFF).astype(delta.dtype)
    )


def dist_slot_of(dv: np.ndarray):
    """(slot, add_bits, extra) per the reference slot code (NLZM.cpp:1311-1318).

    dtype-preserving; nbits via float64 log2 (exact for dv < 2^24)."""
    dt = dv.dtype
    nbits = np.zeros_like(dv)
    nz = dv > 0
    nbits[nz] = np.floor(np.log2(dv[nz].astype(np.float64))).astype(dt) + dt.type(1)
    big = dv >= 4
    ab = np.where(big, nbits - dt.type(2), dt.type(0))
    top = dv >> np.maximum(ab, 0)
    slot = np.where(big, ((nbits - dt.type(1)) << 1) + (top & 1), dv)
    extra = dv & ((dt.type(1) << np.maximum(ab, 0)) - dt.type(1))
    return slot, ab, extra


def batch_plane_arrays(op_len, op_val, op_rep):
    """Per-block classification + batched plane arrays, vectorized over
    the whole [T, B] command batch.

    Returns (per_block, batched, plane_counts): per_block holds each
    block's (None, raw bits); batched maps plane name ->
    (syms [reads][B, T_pad] i32, rows (None per single-row read),
    counts [B], mask [B, T_pad]).
    """
    op_len = np.asarray(op_len, np.int32)
    op_val = np.asarray(op_val, np.int32)
    op_rep = np.asarray(op_rep, np.int32)
    T, B = op_len.shape
    neg = op_len < 0
    n_b = np.where(neg.any(axis=0), neg.argmax(axis=0), T)  # [B]
    valid = np.arange(T)[:, None] < n_b[None, :]

    is_lit = valid & (op_len == 0)
    is_match = valid & (op_len > 0)
    is_rep = is_match & (op_rep >= 0)
    is_dict = is_match & (op_rep < 0)

    tok = np.where(is_lit, TOK_LIT, np.where(is_rep, TOK_REP, TOK_DICT)).astype(np.int32)

    delta = np.where(is_match, op_val, 1).astype(np.int32)
    lv = np.where(is_match, op_len - mmin_of(delta), 0).astype(np.int32)
    assert (lv[is_match] >= 0).all() and (lv[is_match] <= 262).all()
    len_sym = np.minimum(lv, 7)
    is_ext = is_match & (lv >= 7)
    ext = np.maximum(lv - 7, 0)  # <= 255: one joint extension byte

    slot, ab, extra = dist_slot_of(delta - np.int32(1))

    # raw-bit plane, command order: rep -> 2-bit index; dict -> ab bits
    widths = np.zeros((T, B), np.int32)
    widths[is_rep] = 2
    widths[is_dict] = ab[is_dict]
    values = np.zeros((T, B), np.int32)
    values[is_rep] = op_rep[is_rep]
    values[is_dict] = extra[is_dict]
    per_block = [
        (None, _pack_bits(widths[: n_b[b], b], values[: n_b[b], b]))
        for b in range(B)
    ]

    plane_data = {
        "tok": (tok, valid),
        "lit": (op_val, is_lit),
        "len": (len_sym, is_match),
        "lex": (ext, is_ext),
        "dst": (slot, is_dict),
    }
    batched = {}
    plane_counts = []
    b_iota = np.broadcast_to(np.arange(B)[None, :], (T, B))
    for spec in PLANES:
        sym, m = plane_data[spec.name]
        counts = m.sum(axis=0).astype(np.int64)
        T_pad = padded_steps(int(counts.max()), spec.lanes) * spec.lanes
        packed = np.zeros((B, T_pad), np.int32)
        pos = np.cumsum(m, axis=0, dtype=np.int32) - 1
        packed[b_iota[m], pos[m]] = sym[m]
        mask = np.arange(T_pad)[None, :] < counts[:, None]
        batched[spec.name] = ([packed], [None] * spec.reads, counts, mask)
        plane_counts.append(counts)
    return per_block, batched, plane_counts


def assemble_payloads(per_block, plane_counts, plane_streams, plane_offsets):
    """Per-block payload bytes from plane streams + chunk offsets."""
    payloads = []
    for b in range(len(per_block)):
        out = bytearray()
        for i in range(N_PLANES):
            out += int(plane_counts[i][b]).to_bytes(4, "big")
            out += len(plane_streams[i][b]).to_bytes(4, "big")
        bits = per_block[b][1]
        out += len(bits).to_bytes(4, "big")
        for i in range(N_PLANES):
            # the block's own chunk count (a prefix of the batch schedule)
            nc = len(chunk_schedule(padded_steps(int(plane_counts[i][b]), PLANES[i].lanes)))
            offs = plane_offsets[i][b, : nc + 1]
            # the last chunk's count is implied by the stream length
            deltas = (offs[1:nc] - offs[: nc - 1]) // 2
            out += deltas.astype(">u2").tobytes()
        for i in range(N_PLANES):
            out += plane_streams[i][b]
        out += bits
        payloads.append(bytes(out))
    return payloads


def parse_payload(payload: bytes):
    """Split one wide block payload into its sections.

    Returns (counts, streams, offsets, bits): per-plane symbol counts,
    stream bytes (seeds + pairs), chunk-offset arrays, and the raw-bit
    plane bytes.
    """
    counts, sizes = [], []
    off = 0
    for _ in range(N_PLANES):
        counts.append(int.from_bytes(payload[off : off + 4], "big"))
        sizes.append(int.from_bytes(payload[off + 4 : off + 8], "big"))
        off += 8
    bits_len = int.from_bytes(payload[off : off + 4], "big")
    off += 4
    offsets = []
    for i in range(N_PLANES):
        nc = len(chunk_schedule(padded_steps(counts[i], PLANES[i].lanes)))
        deltas = np.frombuffer(payload, ">u2", nc - 1, off).astype(np.int64)
        off += 2 * (nc - 1)
        o = np.zeros(nc, np.int64)
        np.cumsum(2 * deltas, out=o[1:])
        offsets.append(o)
    streams = []
    for s in sizes:
        streams.append(payload[off : off + s])
        off += s
    bits = payload[off : off + bits_len]
    return counts, streams, offsets, bits
