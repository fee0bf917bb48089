"""Device encode, in PyTorch with CUDA kernels.

Counterpart of the greedy branch of nlzm_tpu/ops/encode_ops.py:

1. find_matches: for every position, the k nearest earlier positions with
   the same 4-byte hash, with byte-exact match lengths (<= 264);
2. greedy_cover: one LZ command per step per block, [T, B];
3. repify: the rep-slot replay that marks matches whose distance is live
   in the 4-slot table;
4. emit_model: the v1 model run forward over the commands, giving every
   CDF read's (start, freq) span and every command's raw-bit fields;
5. rans_backward: the 4-lane interleaved rANS over the spans, backward,
   into the frame's rANS section;
6. bits_forward: the raw-bit fields packed MSB-first into the frame's bit
   section.

The wide profile runs 1-3 (parse_blocks_device, with the host depth lift,
native.lift_deep, between 2 and 3) and then ops/wide_encode_dev.py; the v1
profile runs 1-6 on the device (encode_blocks_device), one NLZM frame per
block.

Each kernel (csrc/find_matches.cu, greedy_cover.cu, repify.cu,
emit_model.cu, rans_backward.cu, bits_forward.cu) has a plain PyTorch
version beside it (the *_ref functions); the public function runs the
plain version for CPU tensors and launches the kernel for CUDA tensors.
Both are exact integer code and agree with the JAX functions array for
array.

The optimal device parse (dp_parse, dp_cover, measure_costs) is not
ported: ROADMAP.md queue A item 10b.
"""

import numpy as np
import torch

from .. import _build, native
from ..constants import CDF_ADAPT_BITS, CDF_SCALE_TOTAL, HASH4_MULT, chunk_size_for, frame_bits_for
from .cdf_ops import (
    CDF_WIDTH, CTX_CMD, CTX_DIST_HI, CTX_DIST_LO, CTX_LEN_DIRECT, CTX_LEN_EXT_HI, CTX_LEN_EXT_LO,
    CTX_LIT_HI, CTX_LIT_LO, NUM_CTX, initial_bank,
)

MAX_MLEN = 264  # reference MATCH_MAX (NLZM.cpp:737)
_WORDS = MAX_MLEN // 4
_SMEM_MAX_N = 32768  # csrc kernels keep a block's keys / steps in shared memory up to here


def _i32(name, *tensors):
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError(f"{name}: int32 tensors expected")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# ------------------------------------------------------------ find_matches


def _extend_matches_ref(wordp, cand, ok, n_valid, pos, N: int):
    """Byte-exact match length (<= MAX_MLEN) of each candidate: equal
    leading words, then equal bytes of the first unequal word."""
    full = torch.zeros_like(cand)
    alive = ok
    mism = torch.zeros_like(cand)
    csafe = cand.clamp(min=0)
    for k in range(_WORDS):
        off = 4 * k
        a = wordp[:, off : off + N]
        b = wordp.gather(1, (csafe + off).clamp(max=N + MAX_MLEN))
        x = a ^ b
        eq = alive & (x == 0)
        full = full + eq.long()
        mism = torch.where(alive & ~eq & (mism == 0) & (x != 0), x, mism)
        alive = eq
    tz = torch.where(
        (mism & 0xFF) != 0, 0,
        torch.where((mism & 0xFFFF) != 0, 1, torch.where((mism & 0xFFFFFF) != 0, 2, 3)),
    )
    mlen = (full * 4 + torch.where(mism == 0, 0, tz)).clamp(max=MAX_MLEN)
    limit = (n_valid.long()[:, None] - pos).clamp(min=0)
    return torch.minimum(mlen, limit)


def find_matches_ref(data, n_valid, reach: int, num_cands: int = 1):
    """Plain version of find_matches."""
    B, N = data.shape
    dev = data.device
    d = torch.cat([data.long(), torch.zeros(B, 4, dtype=torch.long, device=dev)], dim=1)
    word = d[:, :N] | (d[:, 1 : N + 1] << 8) | (d[:, 2 : N + 2] << 16) | (d[:, 3 : N + 3] << 24)
    h = ((word * HASH4_MULT) & 0xFFFFFFFF) >> 16  # 16-bit hash
    # equal hashes adjacent, positions ascending within a hash
    h_s, order = torch.sort(h, dim=1, stable=True)
    pos = torch.arange(N, device=dev).expand(B, N)
    wordp = torch.cat([word, torch.zeros(B, MAX_MLEN + 4, dtype=torch.long, device=dev)], dim=1)
    deltas, mlens = [], []
    for k in range(1, num_cands + 1):
        same = torch.zeros(B, N, dtype=torch.bool, device=dev)
        prev = torch.zeros(B, N, dtype=torch.long, device=dev)
        if k < N:
            same[:, k:] = h_s[:, k:] == h_s[:, :-k]
            prev[:, k:] = order[:, :-k]
        cand = torch.empty_like(prev).scatter_(1, order, torch.where(same, prev, -1))
        delta = pos - cand
        ok = (cand >= 0) & (delta > 0) & (delta <= reach)
        deltas.append(torch.where(ok, delta, 0).to(torch.int32))
        mlens.append(_extend_matches_ref(wordp, cand, ok, n_valid, pos, N).to(torch.int32))
    if num_cands == 1:
        return deltas[0], mlens[0]
    return torch.stack(deltas, dim=2), torch.stack(mlens, dim=2)


def find_matches(data, n_valid, reach: int, num_cands: int = 1):
    """Previous occurrences of each position's 4-byte prefix.

    data [B, N] uint8 (zero padded past n_valid), n_valid [B] int32.
    Candidate k of position p is the k-th nearest q < p with the same
    16-bit hash ((word * HASH4_MULT) mod 2^32) >> 16 of the little-endian
    word at p (zeros past N), dropped when p - q > reach. Its length is the
    count of equal leading bytes at p and q, capped at MAX_MLEN and at
    n_valid - p. Returns (delta, mlen) int32 [B, N, C] (0 = none),
    [B, N] when num_cands == 1.
    """
    if data.device.type == "cpu":
        return find_matches_ref(data, n_valid, reach, num_cands)
    _build.check_cuda("find_matches", data, n_valid)
    B, N = data.shape
    if data.dtype != torch.uint8 or n_valid.shape != (B,) or num_cands < 1:
        raise ValueError("find_matches: data [B, N] uint8, n_valid [B] int32, num_cands >= 1")
    _i32("find_matches", n_valid)
    C = num_cands
    M = _next_pow2(N)
    shape = (B, N) if C == 1 else (B, N, C)
    delta = torch.empty(shape, dtype=torch.int32, device=data.device)
    mlen = torch.empty(shape, dtype=torch.int32, device=data.device)
    keys = None
    if N > _SMEM_MAX_N:
        keys = torch.empty(B, M, dtype=torch.int64, device=data.device)
    fn = _build.entry("find_matches", "nlzm_find_matches", 5, 5)
    _build.launch(fn, [data.data_ptr(), n_valid.data_ptr(), delta.data_ptr(), mlen.data_ptr(),
                       None if keys is None else keys.data_ptr()],
                  [B, N, M, int(reach), C], data.device)
    find_matches.launches += 1
    return delta, mlen


find_matches.launches = 0


# ------------------------------------------------------------ greedy_cover


def _mmin(d):
    return 2 + (d > 0xFF).long() + (d > 0xFFF).long() + (d > 0xFFFFF).long()


def greedy_cover_ref(data, delta, mlen, n_valid, num_steps: int):
    """Plain version of greedy_cover: one loop iteration per step, blocks
    as tensors. Once every block is past its end the state no longer
    changes, and the remaining rows are filled at once."""
    B, N = data.shape
    dev = data.device
    data_i = data.long()
    delta, mlen = delta.long(), mlen.long()
    nv = n_valid.long()
    op_len = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    op_val = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    for s in range(num_steps):
        at = pos.clamp(0, N - 1)[:, None]
        d = delta.gather(1, at)[:, 0]
        l = mlen.gather(1, at)[:, 0]
        byte = data_i.gather(1, at)[:, 0]
        active = pos < nv
        if s % 64 == 0 and not bool(active.any()):
            op_len[s:] = -1
            op_val[s:] = byte.to(torch.int32)
            break
        use = active & (d > 0) & (l >= _mmin(d))
        length = torch.where(use, l, 0)
        op_len[s] = torch.where(active, length, -1).to(torch.int32)
        op_val[s] = torch.where(use, d, byte).to(torch.int32)
        pos = pos + torch.where(active, length.clamp(min=1), 0)
    return op_len, op_val


def greedy_cover(data, delta, mlen, n_valid, num_steps: int):
    """Greedy parse: one command per step per block.

    data [B, N] uint8, delta / mlen [B, N] int32 (find_matches with one
    candidate), n_valid [B] int32 in [0, N]. Returns (op_len, op_val)
    [num_steps, B] int32 in the decoder's format: -1 past the end, 0 for a
    literal (op_val = the byte), else the match length with op_val = the
    distance. A match is taken where delta > 0 and mlen >= mmin(delta).
    """
    if data.device.type == "cpu":
        return greedy_cover_ref(data, delta, mlen, n_valid, num_steps)
    _build.check_cuda("greedy_cover", data, delta, mlen, n_valid)
    B, N = data.shape
    if (data.dtype != torch.uint8 or delta.shape != (B, N) or mlen.shape != (B, N)
            or n_valid.shape != (B,)):
        raise ValueError("greedy_cover: data [B, N] uint8, delta and mlen [B, N] int32, "
                         "n_valid [B] int32")
    _i32("greedy_cover", delta, mlen, n_valid)
    dev = data.device
    op_len = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    op_val = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    step = mask = None
    if N > _SMEM_MAX_N:
        step = torch.empty(B, N, dtype=torch.int32, device=dev)
        mask = torch.empty(B, (N + 31) // 32, dtype=torch.int32, device=dev)
    fn = _build.entry("greedy_cover", "nlzm_greedy_cover", 8, 3)
    _build.launch(fn, [data.data_ptr(), delta.data_ptr(), mlen.data_ptr(), n_valid.data_ptr(),
                       op_len.data_ptr(), op_val.data_ptr(),
                       None if step is None else step.data_ptr(),
                       None if mask is None else mask.data_ptr()],
                  [B, N, int(num_steps)], dev)
    greedy_cover.launches += 1
    return op_len, op_val


greedy_cover.launches = 0


# ------------------------------------------------------------------ repify


def repify_ref(op_len, op_val):
    """Plain version of repify: one loop iteration per row up to the last
    row that holds a match; every later row is -1."""
    T, B = op_len.shape
    dev = op_len.device
    op_rep = torch.full((T, B), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero((op_len > 0).any(dim=1))
    last = int(rows[-1]) + 1 if len(rows) else 0
    tab = torch.arange(1, 5, dtype=torch.long, device=dev).expand(B, 4).clone()
    for t in range(last):
        is_match = op_len[t] > 0
        v = op_val[t].long()
        eq = tab == v[:, None]
        present = is_match & eq.any(dim=1)
        op_rep[t] = torch.where(present, eq.int().argmax(dim=1), -1).to(torch.int32)
        insert = is_match & ~present
        tab = torch.where(insert[:, None], torch.cat([v[:, None], tab[:, :3]], dim=1), tab)
    return op_rep


def repify(op_len, op_val):
    """Classify matches against the decoder's rep-distance table.

    op_len / op_val [T, B] int32. Per block a 4-slot table starting at
    (1, 2, 3, 4): a match whose distance is in the table gets the index of
    its first equal slot; a fresh distance is pushed to the front. Returns
    op_rep [T, B] int32: -1 = not a rep, else the slot 0..3.
    """
    if op_len.device.type == "cpu":
        return repify_ref(op_len, op_val)
    _build.check_cuda("repify", op_len, op_val)
    if op_len.dim() != 2 or op_val.shape != op_len.shape:
        raise ValueError("repify: op_len and op_val [T, B] int32")
    _i32("repify", op_len, op_val)
    T, B = op_len.shape
    op_rep = torch.empty(T, B, dtype=torch.int32, device=op_len.device)
    fn = _build.entry("repify", "nlzm_repify", 3, 2)
    _build.launch(fn, [op_len.data_ptr(), op_val.data_ptr(), op_rep.data_ptr()], [T, B],
                  op_len.device)
    repify.launches += 1
    return op_rep


repify.launches = 0


# -------------------------------------------------------------- emit_model

_ZERO_ROW = NUM_CTX  # a bank row of zeros: the JAX one-hot of a family index out of range
_ROW_BITS, _Y_BITS = 7, 5  # descriptor: row | (y + 2) << 7 | log2(n) - 2 << 12
_M32 = 0xFFFFFFFF


def _as_i32(x):
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _emit_commands(op_len, op_val, op_rep):
    """What each command codes, from the command alone (no model state).

    Returns (desc [T, B, 6] int64: per CDF read the bank row it reads
    (_ZERO_ROW where it codes nothing or reads the JAX zero row), its symbol
    clamped to [-2, 17] and its size class, packed; active [T, B] bool;
    fields (va, nb_a, vb, nb_b) [T, B] int32; items [T, B] int64, the
    coded spans plus raw-bit fields)."""
    L, V, R = op_len.long(), op_val.long(), op_rep.long()
    active = L >= 0
    is_lit = active & (L == 0)
    is_match = active & (L > 0)
    is_rep = is_match & (R >= 0)
    is_dict = is_match & (R < 0)

    delta = V.clamp(min=1)
    lv = (L - _mmin(delta)).clamp(min=0)
    lc = lv.clamp(max=3)
    esc = is_match & (lv >= 7)
    ext = (lv - 7).clamp(min=0)
    ehi, elo = ext >> 4, ext & 15
    hi_nib = torch.where(is_lit, V >> 4, 0)
    lo_nib = V & 15

    dv = delta - 1
    nbits = torch.frexp(dv.clamp(min=1).double())[1].long().clamp(1, 31)  # bit length
    big = dv >= 4
    ab = torch.where(big, nbits - 2, 0)
    slot = torch.where(big, ((nbits - 1) << 1) + ((dv >> ab) & 1), dv)
    extra = dv & ((1 << ab) - 1)
    dhi, dlo = slot >> 3, slot & 7

    zero = torch.full_like(L, _ZERO_ROW)
    lit_lo = torch.where((hi_nib >= 0) & (hi_nib < 16), CTX_LIT_LO + hi_nib, zero)
    reads = (  # (row where coded, symbol, log2(n) - 2) of the six reads
        (torch.where(active, CTX_CMD, zero), torch.where(is_lit, 0, torch.where(is_rep, 2, 1)), 0),
        (torch.where(is_lit, CTX_LIT_HI, torch.where(active, CTX_LEN_DIRECT, zero)),
         torch.where(is_lit, hi_nib, lv.clamp(max=7)), torch.where(is_lit, 2, 1)),
        (torch.where(is_lit, lit_lo, torch.where(esc, CTX_LEN_EXT_HI, zero)),
         torch.where(is_lit, lo_nib, ehi), 2),
        (torch.where(esc & (ehi < 16), CTX_LEN_EXT_LO + ehi, zero), elo, 2),
        (torch.where(is_dict, CTX_DIST_HI + lc, zero), dhi, 1),
        (torch.where(is_dict, CTX_DIST_LO + (lc << 3) + dhi, zero), dlo, 1),
    )
    desc = torch.stack([row | ((y.clamp(-2, 17) + 2) << _ROW_BITS)
                        | (cls << (_ROW_BITS + _Y_BITS))
                        for row, y, cls in reads], dim=2)

    has_bits = is_dict & (ab > 0)
    nb_a = torch.where(is_rep, 2, torch.where(has_bits & (ab > 4), ab - 4, 0))
    va = torch.where(is_rep, R, torch.where(nb_a > 0, extra >> 4, 0))
    nb_b = torch.where(has_bits, ab.clamp(max=4), 0)
    vb = torch.where(has_bits, extra & ((1 << nb_b) - 1), 0)
    n_spans = 2 * active.long() + (is_lit | esc).long() + esc.long() + 2 * is_dict.long()
    n_bits = torch.where(is_rep, 1, torch.where(has_bits, 1 + (ab > 4).long(), 0))
    fields = tuple(_as_i32(f) for f in (va, nb_a, vb, nb_b))
    return desc, active, fields, n_spans + n_bits


def emit_model_ref(op_len, op_val, op_rep):
    """Plain version of emit_model: the command-only parts at once, then
    one loop iteration per step that any block codes in, all six reads
    of the step together (their rows are distinct)."""
    T, B = op_len.shape
    dev = op_len.device
    desc, active, fields, items = _emit_commands(op_len, op_val, op_rep)
    bank = torch.zeros(B, NUM_CTX + 1, CDF_WIDTH, dtype=torch.long, device=dev)
    bank[:, :NUM_CTX] = torch.as_tensor(initial_bank(), device=dev)
    lane = torch.arange(CDF_WIDTH, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    spans = torch.zeros(T, B, 6, dtype=torch.long, device=dev)
    for t in torch.nonzero(active.any(dim=1)).flatten().tolist():
        d = desc[t]  # [B, 6]
        row = d & ((1 << _ROW_BITS) - 1)
        y = ((d >> _ROW_BITS) & ((1 << _Y_BITS) - 1)) - 2
        n = 4 << (d >> (_ROW_BITS + _Y_BITS))
        f = bank[bidx, row]  # [B, 6, 17]

        def fence(i):  # fence i of each row, 0 outside 0..16 (the JAX one-hot)
            got = f.gather(2, i.clamp(0, CDF_WIDTH - 1)[..., None])[..., 0]
            return torch.where((i >= 0) & (i < CDF_WIDTH), got, 0)

        start = fence(y)
        spans[t] = (((fence(y + 1) - start) << 16) | start) & _M32
        yc = torch.minimum(y.clamp(min=0), n - 1)[..., None]
        n = n[..., None]
        target = torch.where(lane >= n, CDF_SCALE_TOTAL, torch.where(
            lane <= yc, lane, CDF_SCALE_TOTAL + lane + (1 << CDF_ADAPT_BITS) - 1 - n))
        bank[bidx, row] = f + ((target - f) >> CDF_ADAPT_BITS)
        bank[:, _ZERO_ROW] = 0
    return _as_i32(spans), fields, _as_i32(items.sum(dim=0))


def emit_model(op_len, op_val, op_rep):
    """Model pass over step-aligned commands.

    op_len / op_val / op_rep [T, B] int32 (op_rep: -1 = literal or
    dictionary match, else the rep slot 0..3; op_val holds the distance
    of a rep too). Runs the decoder's 72 x 17 CDF bank forward over each
    block's commands: up to six reads per command (command; literal high
    nibble or direct length; literal low nibble or length-extension high;
    length-extension low; distance slot high and low), each adapting its
    row. Returns (spans [T, B, 6] int32 holding the u32 bits of
    (freq << 16) | start, 0 = no read, (va, nb_a, vb, nb_b) [T, B] int32
    raw-bit fields, nops [B] int32 coded items: spans plus fields).
    """
    if op_len.device.type == "cpu":
        return emit_model_ref(op_len, op_val, op_rep)
    _build.check_cuda("emit_model", op_len, op_val, op_rep)
    if op_len.dim() != 2 or op_val.shape != op_len.shape or op_rep.shape != op_len.shape:
        raise ValueError("emit_model: op_len, op_val and op_rep [T, B] int32")
    _i32("emit_model", op_len, op_val, op_rep)
    T, B = op_len.shape
    dev = op_len.device
    spans = torch.empty(T, B, 6, dtype=torch.int32, device=dev)
    fields = tuple(torch.empty(T, B, dtype=torch.int32, device=dev) for _ in range(4))
    nops = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _build.entry("emit_model", "nlzm_emit_model", 9, 2)
    _build.launch(fn, [op_len.data_ptr(), op_val.data_ptr(), op_rep.data_ptr(), spans.data_ptr(),
                       *(f.data_ptr() for f in fields), nops.data_ptr()], [T, B], dev)
    emit_model.launches += 1
    return spans, fields, nops


emit_model.launches = 0


# ----------------------------------------------------------- rans_backward


def _check_cap(name: str, cap: int) -> None:
    if cap < 1:
        raise ValueError(f"{name}: cap >= 1 expected, got {cap}")


def rans_backward_ref(spans, cap: int):
    """Plain version of rans_backward: the nonzero spans compacted per
    block in forward order, then one loop iteration per group of four
    (span k codes on lane k & 3), last group first."""
    _check_cap("rans_backward", cap)
    T, B, _ = spans.shape
    dev = spans.device
    sp = (spans.long() & _M32).permute(1, 0, 2).reshape(B, T * 6)
    valid = sp != 0
    count = valid.sum(dim=1)
    K = -(-int(count.max()) // 4) * 4 if B else 0
    comp = torch.zeros(B, K, dtype=torch.long, device=dev)
    k = valid.cumsum(dim=1) - 1
    comp[torch.arange(B, device=dev)[:, None].expand_as(sp)[valid], k[valid]] = sp[valid]

    x = torch.full((B, 4), 1 << 16, dtype=torch.long, device=dev)
    pairs = torch.zeros(B, K, dtype=torch.long, device=dev)
    flags = torch.zeros(B, K, dtype=torch.bool, device=dev)
    quad = torch.arange(4, device=dev)
    for m in range(K - 4, -1, -4):
        s = comp[:, m : m + 4]
        live = (m + quad) < count[:, None]
        fq = (s >> 16).clamp(min=1)
        over = live & (x >= ((fq << 18) & _M32))  # u32: fq << 18 wraps at fq = 2^14
        pairs[:, m : m + 4] = x & 0xFFFF
        flags[:, m : m + 4] = over
        x1 = torch.where(over, x >> 16, x)
        x2 = ((((x1 // fq) << 14) & _M32) + x1 % fq + (s & 0xFFFF)) & _M32
        x = torch.where(live, x2, x)

    stream = torch.zeros(B, cap, dtype=torch.uint8, device=dev)
    for i in range(min(16, cap)):  # lane seeds, u32 little-endian, lane 0 first
        stream[:, i] = ((x[:, i >> 2] >> (8 * (i & 3))) & 0xFF).to(torch.uint8)
    pos = 16 + 2 * (flags.cumsum(dim=1) - flags.long())
    rows = torch.arange(B, device=dev)[:, None].expand_as(pos)
    for byte, at in ((pairs >> 8, pos), (pairs & 0xFF, pos + 1)):
        keep = flags & (at < cap)
        stream[rows[keep], at[keep]] = byte[keep].to(torch.uint8)
    return stream, _as_i32(16 + 2 * flags.sum(dim=1))


def rans_backward(spans, cap: int):
    """4-lane interleaved rANS over the span stream, backward.

    spans [T, B, 6] int32 holding u32 (freq << 16) | start (0 = no read).
    The k-th nonzero span of a block in forward order (t, then slot)
    codes on lane k & 3; each lane starts at 1 << 16 and, from the last
    span back, emits its low 16 bits as a renorm pair when x >= freq << 18
    (u32), then x = (x / f << 14) + x % f + start with f = max(freq, 1).
    Returns (stream [B, cap] uint8: the four final states u32
    little-endian, lane 0 first, then the pairs high byte first in
    forward order, zero filled, bytes past cap dropped; rans_bytes [B]
    int32 = 16 + 2 * pairs, not clamped to cap).
    """
    if spans.device.type == "cpu":
        return rans_backward_ref(spans, cap)
    _build.check_cuda("rans_backward", spans)
    _check_cap("rans_backward", cap)
    if spans.dim() != 3 or spans.shape[2] != 6:
        raise ValueError("rans_backward: spans [T, B, 6] int32")
    _i32("rans_backward", spans)
    T, B, _ = spans.shape
    dev = spans.device
    scratch = torch.empty(B, 6 * T, dtype=torch.int32, device=dev)
    stream = torch.empty(B, cap, dtype=torch.uint8, device=dev)
    rans_bytes = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _build.entry("rans_backward", "nlzm_rans_backward", 4, 3)
    _build.launch(fn, [spans.data_ptr(), scratch.data_ptr(), stream.data_ptr(),
                       rans_bytes.data_ptr()], [T, B, int(cap)], dev)
    rans_backward.launches += 1
    return stream, rans_bytes


rans_backward.launches = 0


# ------------------------------------------------------------ bits_forward

_BITS_SMEM_MAX = 200 * 1024  # csrc/bits_forward.cu packs a block's section in shared memory


def bits_forward_ref(fields, cap: int):
    """Plain version of bits_forward: every field's bit offset from a
    prefix sum, its bits added into at most two u32 words (fields never
    overlap, so adding is OR), the words written big-endian."""
    _check_cap("bits_forward", cap)
    T, B = fields[1].shape
    dev = fields[1].device
    va, nb_a, vb, nb_b = (f.long() for f in fields)
    nb = torch.stack([nb_a, nb_b], dim=1).permute(2, 0, 1).reshape(B, 2 * T).clamp(0, 24)
    v = (torch.stack([va, vb], dim=1).permute(2, 0, 1).reshape(B, 2 * T) & _M32) & ((1 << nb) - 1)
    off = nb.cumsum(dim=1) - nb
    total = nb.sum(dim=1)
    nw = (cap + 3) // 4
    e = (off & 31) + nb  # end of the field in its 64-bit window
    s_hi, s_lo = (32 - e).clamp(min=0), (e - 32).clamp(min=0)
    hi = (v << s_hi) >> s_lo
    lo = (v & ((1 << s_lo) - 1)) << (64 - e).clamp(max=32)
    words = torch.zeros(B, nw + 1, dtype=torch.long, device=dev)  # word nw: past cap, dropped
    w = off >> 5
    words.scatter_add_(1, w.clamp(max=nw), hi)
    words.scatter_add_(1, (w + 1).clamp(max=nw), lo)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    out = ((words[:, :nw, None] >> shifts) & 0xFF).reshape(B, 4 * nw)[:, :cap].to(torch.uint8)
    n_full = total >> 3
    # the JAX drain writes its last (zero) byte at min(n_full + 3, cap - 1)
    out[n_full + 4 >= cap, cap - 1] = 0
    return out, _as_i32(n_full + 4)


def bits_forward(fields, cap: int):
    """Pack raw-bit fields MSB-first into the frame's bit section.

    fields (va, nb_a, vb, nb_b), each [T, B] int32: per step field a,
    then field b, each the low clip(nb, 0, 24) bits of its value. Returns
    (bytes_out [B, cap] uint8: the fields' bits concatenated, zero padded,
    bytes past cap dropped and byte cap - 1 zero once the section reaches
    it (the JAX drain); n_bytes [B] int32 = total bits // 8 + 4).
    """
    va, nb_a, vb, nb_b = fields
    if nb_a.device.type == "cpu":
        return bits_forward_ref(fields, cap)
    _build.check_cuda("bits_forward", *fields)
    _check_cap("bits_forward", cap)
    if nb_a.dim() != 2 or any(f.shape != nb_a.shape for f in fields):
        raise ValueError("bits_forward: four [T, B] int32 fields")
    T, B = nb_a.shape
    _i32("bits_forward", *fields)
    if 4 * ((cap + 3) // 4 + 1) > _BITS_SMEM_MAX or 48 * T >= 1 << 31:
        raise ValueError(f"bits_forward: cap {cap} or {T} steps too large for the kernel")
    dev = nb_a.device
    out = torch.empty(B, cap, dtype=torch.uint8, device=dev)
    n_bytes = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _build.entry("bits_forward", "nlzm_bits_forward", 6, 3)
    _build.launch(fn, [va.data_ptr(), nb_a.data_ptr(), vb.data_ptr(), nb_b.data_ptr(),
                       out.data_ptr(), n_bytes.data_ptr()], [T, B, int(cap)], dev)
    bits_forward.launches += 1
    return out, n_bytes


bits_forward.launches = 0


# ------------------------------------------------------------ entry points


def _blocks_arrays(data: bytes, block_size: int):
    """Split bytes into [nblocks, N] zero-padded array + valid counts."""
    n = len(data)
    N = block_size
    nblocks = (n + N - 1) // N
    arr = np.zeros((nblocks, N), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for b in range(nblocks):
        seg = flat[b * N : (b + 1) * N]
        arr[b, : len(seg)] = seg
    n_valid = np.minimum(
        np.full(nblocks, N, np.int64), n - np.arange(nblocks) * N
    ).astype(np.int32)
    return arr, n_valid


def parse_blocks_device(data: bytes, block_size: int, hist_bits: int, parser: str = "greedy",
                        *, device="cuda"):
    """Device parse: blocks -> command arrays, on `device`.

    find_matches and greedy_cover on the device, the depth lift on the
    host (native.lift_deep, cap 15), repify on the device. Returns
    (op_len [T, B], op_val, op_rep, depths) as numpy; T = block_size
    rounded up to 256. parser="optimal" (the calibrated DP parse) is not
    ported and raises NotImplementedError.
    """
    _greedy_only(parser)
    arr, n_valid = _blocks_arrays(data, block_size)
    if arr.shape[0] == 0:
        return (np.zeros((0, 0), np.int32),) * 3 + (np.zeros(0, np.int32),)
    dev = torch.device(device)
    dt = torch.as_tensor(arr, device=dev)
    nv = torch.as_tensor(n_valid, device=dev)
    num_steps = ((block_size + 255) // 256) * 256
    reach = (1 << hist_bits) - 1
    delta, mlen = find_matches(dt, nv, reach)
    op_len, op_val = greedy_cover(dt, delta, mlen, nv, num_steps)
    # owned host copies: the lift rewrites op_val through ctypes, which must
    # never write into a tensor's memory (tensor.numpy() shares it)
    op_len_h = np.array(op_len.cpu().numpy(), np.int32, order="C")
    op_val_h = np.array(op_val.cpu().numpy(), np.int32, order="C")
    depths = native.lift_deep(op_len_h, op_val_h, block_size)
    op_rep = repify(torch.as_tensor(op_len_h, device=dev), torch.as_tensor(op_val_h, device=dev))
    return op_len_h, op_val_h, op_rep.cpu().numpy(), depths


def _greedy_only(parser: str) -> None:
    if parser != "greedy":
        raise NotImplementedError(
            f"parser={parser!r}: the optimal device parse (dp_parse, dp_cover, "
            "measure_costs) is ROADMAP.md queue A item 10b")


def encode_pipeline_device(data, n_valid, reach: int, num_steps: int, rans_cap: int,
                           bits_cap: int, parser: str = "greedy"):
    """The whole v1 block encode on the tensors' device: data [B, N] uint8
    blocks and n_valid [B] int32 in; frame sections out, nothing copied
    back. Returns (stream [B, rans_cap] uint8, rans_bytes [B], bits
    [B, bits_cap] uint8, bits_n [B], nops [B], ncmds [B]), int32 counts."""
    _greedy_only(parser)
    delta, mlen = find_matches(data, n_valid, reach)
    op_len, op_val = greedy_cover(data, delta, mlen, n_valid, num_steps)
    op_rep = repify(op_len, op_val)
    spans, fields, nops = emit_model(op_len, op_val, op_rep)
    stream, rans_bytes = rans_backward(spans, rans_cap)
    bits, bits_n = bits_forward(fields, bits_cap)
    ncmds = (op_len >= 0).sum(dim=0, dtype=torch.int32)
    return stream, rans_bytes, bits, bits_n, nops, ncmds


def encode_blocks_device(data: bytes, block_size: int, hist_bits: int, parser: str = "greedy",
                         *, device="cuda"):
    """Encode v1 blocks on `device`, one NLZM frame per block; returns
    (payloads, reads, cmds) like native.encode_blocks. Each payload is the
    12-byte frame header (u32be item count, 12 + bit-section bytes,
    rANS-section bytes), the bit section and the rANS section. Raises
    ValueError when block_size exceeds one frame's chunk at hist_bits."""
    limit = chunk_size_for(frame_bits_for(hist_bits))
    if block_size > limit:
        raise ValueError(
            f"engine=device v1 blocks encode as one frame each: block_size "
            f"{block_size} exceeds the frame chunk capacity {limit} at "
            f"hist_bits {hist_bits} (use -blocks:{limit} or less, or the "
            f"native engine)")
    arr, n_valid = _blocks_arrays(data, block_size)
    if arr.shape[0] == 0:
        return [], [], []
    N = block_size
    num_steps = ((N + 255) // 256) * 256  # worst case: all literals
    rans_cap = ((3 * N + 64 + 255) // 256) * 256
    bits_cap = ((N + 64 + 255) // 256) * 256
    dev = torch.device(device)
    return frame_payloads(*encode_pipeline_device(
        torch.as_tensor(arr, device=dev), torch.as_tensor(n_valid, device=dev),
        (1 << hist_bits) - 1, num_steps, rans_cap, bits_cap, parser))


def frame_payloads(stream, rans_bytes, bits, bits_n, nops, ncmds):
    """encode_pipeline_device's sections -> (payloads, reads, cmds): copies
    back only the bytes the payloads hold (a section's count may pass its
    cap; the payload then holds the cap's bytes, as the JAX one does)."""
    rb, bn, nops, ncmds = (t.cpu().numpy() for t in (rans_bytes, bits_n, nops, ncmds))
    stream = stream[:, : int(rb.max())].cpu().numpy()
    bits = bits[:, : int(bn.max())].cpu().numpy()
    payloads = [
        int(nops[b]).to_bytes(4, "big") + (12 + int(bn[b])).to_bytes(4, "big")
        + int(rb[b]).to_bytes(4, "big") + bits[b, : bn[b]].tobytes() + stream[b, : rb[b]].tobytes()
        for b in range(len(nops))
    ]
    return payloads, nops.tolist(), ncmds.tolist()
