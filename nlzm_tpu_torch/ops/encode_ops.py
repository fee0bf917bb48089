"""Device encode, in PyTorch with CUDA kernels.

Counterpart of nlzm_tpu/ops/encode_ops.py:

1. find_matches: for every position, the k nearest earlier positions with
   the same 4-byte hash, with byte-exact match lengths (<= 264);
2. the parse, one LZ command per step per block, [T, B]: greedy_cover
   (parser="greedy"), or the calibrated optimal parse (parser="optimal"):
   three rounds of dp_parse (a backward shortest-path DP over static
   per-block bit costs) and dp_cover (the walk along its choices), the
   costs of rounds 2 and 3 measured by measure_costs on the model spans
   of the round before;
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

Each kernel (csrc/find_matches.cu, greedy_cover.cu (greedy_cover and
dp_cover), dp_parse.cu, measure_costs.cu, repify.cu, emit_model.cu,
rans_backward.cu, bits_forward.cu) has a plain PyTorch version beside it
(the *_ref functions); the public function runs the plain version for CPU
tensors and launches the kernel for CUDA tensors. Both are exact integer
code and agree with the JAX functions array for array; measure_costs
defines its float32 average exactly (see there).
"""

import numpy as np
import torch

from .. import _build, native
from ..constants import CDF_ADAPT_BITS, CDF_SCALE_TOTAL, HASH4_MULT, chunk_size_for, frame_bits_for
from ..utils.shards import pad_blocks, shard_rows
from .cdf_ops import (
    CDF_WIDTH, CTX_CMD, CTX_DIST_HI, CTX_DIST_LO, CTX_LEN_DIRECT, CTX_LEN_EXT_HI, CTX_LEN_EXT_LO,
    CTX_LIT_HI, CTX_LIT_LO, NUM_CTX, initial_bank,
)

MAX_MLEN = 264  # reference MATCH_MAX (NLZM.cpp:737)
_WORDS = MAX_MLEN // 4
_SMEM_MAX_N = 32768  # csrc kernels keep a block's keys / steps in shared memory up to here
_FM_MAX_N = 131072  # csrc/find_matches.cu keeps a block's bytes in shared memory up to here


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
    # n_valid - pos in int32, wrapping as JAX's subtraction does
    limit = ((n_valid.long()[:, None] - pos + (1 << 31)) % (1 << 32) - (1 << 31)).clamp(min=0)
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
    max(n_valid - p, 0) (int32, wrapping). Returns (delta, mlen) int32
    [B, N, C] (0 = none), [B, N] when num_cands == 1. On the card N is at
    most 131072, the format's block cap.
    """
    if data.device.type == "cpu":
        return find_matches_ref(data, n_valid, reach, num_cands)
    _build.check_cuda("find_matches", data, n_valid)
    B, N = data.shape
    if data.dtype != torch.uint8 or n_valid.shape != (B,) or num_cands < 1:
        raise ValueError("find_matches: data [B, N] uint8, n_valid [B] int32, num_cands >= 1")
    if N > _FM_MAX_N:
        raise ValueError(f"find_matches: blocks of {N} bytes; the kernel takes at most {_FM_MAX_N}")
    _i32("find_matches", n_valid)
    C = num_cands
    shape = (B, N) if C == 1 else (B, N, C)
    delta = torch.empty(shape, dtype=torch.int32, device=data.device)
    mlen = torch.empty(shape, dtype=torch.int32, device=data.device)
    pos = None  # positions by low hash byte, then prev by position: u32 [B, 2, N]
    if N > _SMEM_MAX_N:
        pos = torch.empty(B, 2, N, dtype=torch.int32, device=data.device)
    fn = _build.entry("find_matches", "nlzm_find_matches", 5, 5)
    # every reach at or past N - 1 keeps every candidate; below 1 none
    _build.launch(fn, [data.data_ptr(), n_valid.data_ptr(), delta.data_ptr(), mlen.data_ptr(),
                       None if pos is None else pos.data_ptr()],
                  [B, N, _next_pow2(N), min(max(int(reach), 0), N), C], data.device)
    find_matches.launches += 1
    return delta, mlen


find_matches.launches = 0


# ------------------------------------------------------------ greedy_cover


def _mmin(d):
    return 2 + (d > 0xFF).long() + (d > 0xFFF).long() + (d > 0xFFFFF).long()


def _cover_ref(data, step, length, value, n_valid, num_steps: int):
    """The walk of greedy_cover_ref and dp_cover_ref, by pointer doubling.
    next[p] = min(p + step[p], N), with N and every position at or past
    n_valid absorbing; start i of a block is next^i(0), for all i <
    num_steps at once, composed from next^(2^k) by the bits of i (one
    doubled table kept at a time). A start p < n_valid emits (length[p],
    value[p]); every later row is (-1, the byte at the walk's end clamped
    to N - 1). step, length and value are int64 [B, N]."""
    B, N = data.shape
    dev = data.device
    pos = torch.arange(N + 1, device=dev).expand(B, N + 1)
    nv = n_valid.long().clamp(0, N)[:, None]
    nxt = torch.cat([(pos[:, :N] + step).clamp(max=N), pos[:, N:]], dim=1)
    nxt = torch.where(pos >= nv, pos, nxt)
    i = torch.arange(num_steps, device=dev)
    at = torch.zeros(B, num_steps, dtype=torch.long, device=dev)
    k = 0
    while (1 << k) < num_steps:
        at = torch.where(((i >> k) & 1).bool(), nxt.gather(1, at), at)
        k += 1
        if (1 << k) < num_steps:
            nxt = nxt.gather(1, nxt)
    live = at < nv
    at = at.clamp(max=N - 1)
    op_len = torch.where(live, length.gather(1, at), -1)
    op_val = torch.where(live, value.gather(1, at), data.long().gather(1, at))
    return op_len.T.to(torch.int32).contiguous(), op_val.T.to(torch.int32).contiguous()


def greedy_cover_ref(data, delta, mlen, n_valid, num_steps: int):
    """Plain version of greedy_cover: each position's command at once,
    then the walk by pointer doubling (_cover_ref)."""
    d, l = delta.long(), mlen.long()
    use = (d > 0) & (l >= _mmin(d))
    return _cover_ref(data, torch.where(use, l, 1), torch.where(use, l, 0),
                      torch.where(use, d, data.long()), n_valid, num_steps)


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


# ---------------------------------------------------------------- dp_parse

# dp_parse relaxes every length 1..64, then samples longer lengths like the
# reference's tstep sampling (NLZM.cpp:1558-1560); csrc/dp_parse.cu holds
# the same table
DP_LENS = tuple(range(1, 65)) + (72, 80, 96, 112, 128, 160, 192, 224, 264)
# Static bit costs of the DP parse in 1/16 bit, the JAX package's
# calibrated estimates of the adapted model's costs: [LIT, CMD_M,
# LEN_BASE, LEN_SLOPE, LEN_ESC, DIST_SLOT]
_DP_COSTS = (6 * 16, 2 * 16, 2 * 16, 4, 11 * 16, 5 * 16 + 8)
_DP_BIG = 1 << 28  # the cost of an invalid edge
_DP_CANDS = 3  # csrc/dp_parse.cu takes the calibrated parse's three candidates
_DP_CHUNK = 64  # dp_parse_ref: positions whose window-free edge costs are built at once


_default_rows: dict = {}


def default_dp_costs(device="cpu"):
    """[LIT, CMD_M, LEN_BASE, LEN_SLOPE, LEN_ESC, DIST_SLOT] in 1/16 bit,
    int32 [6], a fresh tensor."""
    return torch.tensor(_DP_COSTS, dtype=torch.int32, device=device)


def _default_costs_on(device):
    """default_dp_costs on `device`, made once per device and shared, so a
    call on the card uploads nothing; the wrappers only read it."""
    key = str(torch.device(device))
    t = _default_rows.get(key)
    if t is None:
        t = _default_rows[key] = default_dp_costs(device)
    return t


def _dp_lens(max_len: int):
    lens = [n for n in DP_LENS if n <= max_len]
    if not lens:
        raise ValueError(f"dp_parse: max_len >= 1 expected, got {max_len}")
    return lens


def _cost_rows(costs, B: int, device):
    """costs None, [6] or [B, 6] int32 -> [B, 6] int32, contiguous."""
    if costs is None:
        costs = _default_costs_on(device)
    if costs.shape not in ((6,), (B, 6)) or costs.dtype != torch.int32:
        raise ValueError("dp_parse: costs [6] or [B, 6] int32 expected")
    return costs.expand(B, 6).contiguous()


def dp_parse_ref(delta, mlen, n_valid, costs=None, max_len: int = MAX_MLEN):
    """Plain version of dp_parse: the edges' window-free costs and
    validity a chunk of positions at a time, then one loop iteration per
    position, last first. The window is a row of costs by position, zero
    from N on; all sums are i32 sums that wrap, done in int64."""
    B, N, C = delta.shape
    dev = delta.device
    lens = torch.tensor(_dp_lens(max_len), dtype=torch.long, device=dev)
    L = len(lens)
    c = _cost_rows(costs, B, dev).long()
    c_lit, c_cmd_m, c_len_base, c_slope, c_len_esc, c_dist_slot = c.unbind(1)
    d = delta.long()
    dv = d.clamp(min=1) - 1
    nbits = torch.frexp(dv.clamp(min=1).double())[1].long()  # bit length
    ab = torch.where(dv >= 4, nbits - 2, 0)
    dist_c = c_cmd_m[:, None, None] + c_dist_slot[:, None, None] + ab * 16  # [B, N, C]
    mmin = _mmin(d)
    flat = torch.arange(L * C, device=dev).view(L, C)
    active = torch.arange(N, device=dev)[None, :] < n_valid.long()[:, None]
    cost_at = torch.zeros(B, N + max(max_len, 1) + 1, dtype=torch.long, device=dev)
    keys = torch.empty(B, N, dtype=torch.long, device=dev)
    use = torch.empty(B, N, dtype=torch.bool, device=dev)
    for c0 in range((N - 1) // _DP_CHUNK * _DP_CHUNK, -1, -_DP_CHUNK):
        c1 = min(c0 + _DP_CHUNK, N)
        lv = lens[None, None, :, None] - mmin[:, c0:c1, None, :]  # [B, K, L, C]
        len_c = torch.where(lv < 7, c_len_base[:, None, None, None]
                            + lv.clamp(min=0) * c_slope[:, None, None, None],
                            c_len_esc[:, None, None, None])
        base = dist_c[:, c0:c1, None, :] + len_c
        valid = ((lv >= 0) & (lens[None, None, :, None] <= mlen[:, c0:c1, None, :].long())
                 & (d[:, c0:c1, None, :] > 0))
        for i in range(c1 - 1, c0 - 1, -1):
            tot = _wrap32(base[:, i - c0] + cost_at[:, i + lens, None])  # [B, L, C]
            # the first minimum of the flat (length, candidate) order
            key = (torch.where(valid[:, i - c0], tot, _DP_BIG) * (1 << 32) + flat).view(B, -1)
            best = key.min(dim=1).values
            lit_c = _wrap32(c_lit + cost_at[:, i + 1])
            mc = best >> 32
            use[:, i] = mc < lit_c
            cost_at[:, i] = torch.where(active[:, i], torch.where(use[:, i], mc, lit_c), 0)
            keys[:, i] = best
    am = keys & _M32
    choice_len = torch.where(active & use, lens[am // C], 0)
    return choice_len.to(torch.int32), (am % C).to(torch.int32)


def dp_parse(delta, mlen, n_valid, costs=None, max_len: int = MAX_MLEN):
    """Approximate-cost shortest-path parse, a backward DP per block.

    delta / mlen [B, N, C] int32 (find_matches' candidates; the kernel
    takes the calibrated parse's C = 3), n_valid [B] int32, costs None
    (default_dp_costs()), [6] or [B, 6] int32. From the
    last position back, a position's cost is 0 at or past n_valid, else
    the cheaper of its literal edge (LIT + cost[i + 1]) and its cheapest
    match edge: over every length n of DP_LENS up to max_len and every
    candidate c, CMD_M + DIST_SLOT + 16 * ab(d) + (LEN_BASE + SLOPE * lv
    if lv < 7 else LEN_ESC) + cost[i + n], with lv = n - mmin(d); the
    edge is valid when lv >= 0, n <= mlen and d > 0, else it costs
    _DP_BIG; ties go to the first in (length, candidate) order, and the
    match is taken only when strictly cheaper. Costs past N are 0; every
    sum is an i32 sum that wraps. Returns (choice_len [B, N] int32, 0 =
    literal; choice_cand [B, N] int32, the best edge's candidate even
    where the literal wins).
    """
    if delta.device.type == "cpu":
        return dp_parse_ref(delta, mlen, n_valid, costs, max_len)
    _build.check_cuda("dp_parse", delta, mlen, n_valid, costs)
    if delta.dim() != 3 or mlen.shape != delta.shape or n_valid.shape != delta.shape[:1]:
        raise ValueError("dp_parse: delta and mlen [B, N, C] int32, n_valid [B] int32")
    _i32("dp_parse", delta, mlen, n_valid)
    B, N, C = delta.shape
    if C != _DP_CANDS:
        raise ValueError(f"dp_parse: the kernel takes {_DP_CANDS} candidates, got {C}")
    dev = delta.device
    L = len(_dp_lens(max_len))
    rows = _cost_rows(costs, B, dev)
    choice_len = torch.empty(B, N, dtype=torch.int32, device=dev)
    choice_cand = torch.empty(B, N, dtype=torch.int32, device=dev)
    fn = _build.entry("dp_parse", "nlzm_dp_parse", 6, 4)
    _build.launch(fn, [delta.data_ptr(), mlen.data_ptr(), n_valid.data_ptr(), rows.data_ptr(),
                       choice_len.data_ptr(), choice_cand.data_ptr()], [B, N, C, L], dev)
    dp_parse.launches += 1
    return choice_len, choice_cand


dp_parse.launches = 0


# ---------------------------------------------------------------- dp_cover


def dp_cover_ref(data, delta, choice_len, choice_cand, n_valid, num_steps: int):
    """Plain version of dp_cover: each position's command at once, then
    the walk by pointer doubling, as greedy_cover_ref."""
    C = delta.shape[2]
    cl = choice_len.long()
    cand = choice_cand.long()
    ok = (cand >= 0) & (cand < C)
    dist = torch.where(ok, delta.long().gather(2, cand.clamp(0, C - 1)[..., None])[..., 0], 0)
    use = cl > 0
    return _cover_ref(data, cl.clamp(min=1), torch.where(use, cl, 0),
                      torch.where(use, dist, data.long()), n_valid, num_steps)


def dp_cover(data, delta, choice_len, choice_cand, n_valid, num_steps: int):
    """Follow the DP choices: one command per step per block.

    data [B, N] uint8, delta [B, N, C] int32, choice_len / choice_cand
    [B, N] int32 (dp_parse), n_valid [B] int32 in [0, N]. From position 0
    the walk advances by max(choice_len, 1); a position with choice_len > 0
    is a match of that length at delta[choice_cand] (0 when choice_cand is
    outside [0, C)), else a literal of its byte. Returns (op_len, op_val)
    [num_steps, B] int32 in greedy_cover's format; rows past the end are
    (-1, the byte at the end, clamped to N - 1).
    """
    if data.device.type == "cpu":
        return dp_cover_ref(data, delta, choice_len, choice_cand, n_valid, num_steps)
    _build.check_cuda("dp_cover", data, delta, choice_len, choice_cand, n_valid)
    B, N = data.shape
    if (data.dtype != torch.uint8 or delta.dim() != 3 or delta.shape[:2] != (B, N)
            or choice_len.shape != (B, N) or choice_cand.shape != (B, N)
            or n_valid.shape != (B,)):
        raise ValueError("dp_cover: data [B, N] uint8, delta [B, N, C], choice_len and "
                         "choice_cand [B, N], n_valid [B] int32")
    _i32("dp_cover", delta, choice_len, choice_cand, n_valid)
    dev = data.device
    op_len = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    op_val = torch.empty(num_steps, B, dtype=torch.int32, device=dev)
    step = mask = None
    if N > _SMEM_MAX_N:
        step = torch.empty(B, N, dtype=torch.int32, device=dev)
        mask = torch.empty(B, (N + 31) // 32, dtype=torch.int32, device=dev)
    fn = _build.entry("greedy_cover", "nlzm_dp_cover", 9, 4)
    _build.launch(fn, [data.data_ptr(), delta.data_ptr(), choice_len.data_ptr(),
                       choice_cand.data_ptr(), n_valid.data_ptr(), op_len.data_ptr(),
                       op_val.data_ptr(), None if step is None else step.data_ptr(),
                       None if mask is None else mask.data_ptr()],
                  [B, N, delta.shape[2], int(num_steps)], dev)
    dp_cover.launches += 1
    return op_len, op_val


dp_cover.launches = 0


# ----------------------------------------------------------- measure_costs

_FIX_BITS = 32  # measure_costs sums bit costs in fixed point, 2^-32 bit units
_bits16_tables: dict = {}


def bits16_table(device):
    """int64 [65536]: (14 - log2(max(f, 1))) * 16 * 2^32 for every 16-bit
    freq f, rounded to an integer; built once per device in float64."""
    key = str(torch.device(device))
    t = _bits16_tables.get(key)
    if t is None:
        f = np.maximum(np.arange(1 << 16), 1).astype(np.float64)
        t = np.rint((14.0 - np.log2(f)) * 16.0 * 2.0**_FIX_BITS).astype(np.int64)
        t = _bits16_tables[key] = torch.as_tensor(t, device=device)
    return t


def _round_half_even(s, cnt):
    """round(s / (cnt << _FIX_BITS)), ties to even, in integers; cnt > 0."""
    d = cnt << _FIX_BITS
    q = torch.div(s, d, rounding_mode="floor")
    r2 = 2 * (s - q * d)
    return q + ((r2 > d) | ((r2 == d) & ((q & 1) == 1))).long()


def measure_costs_ref(spans, op_len, op_val, op_rep):
    """Plain version of measure_costs, vectorised: the table lookups, five
    int64 sums and counts per block, the integer rounding."""
    T, B, _ = spans.shape
    sp = spans.long()
    bits = torch.where(sp != 0, bits16_table(spans.device)[(sp >> 16) & 0xFFFF], 0)
    L = op_len.long()
    is_lit, is_match = L == 0, L > 0
    esc = is_match & (L - _mmin(op_val.long().clamp(min=1)) >= 7)
    fams = (  # (bits, commands): literal, match command, direct length, escape, distance
        (bits[..., 0:3].sum(dim=2), is_lit),
        (bits[..., 0], is_match),
        (bits[..., 1], is_match & ~esc),
        (bits[..., 1:4].sum(dim=2), esc),
        (bits[..., 4:6].sum(dim=2), is_match & (op_rep < 0)),
    )
    out = []
    for (v, m), col in zip(fams, (0, 1, 2, 4, 5)):
        cnt = m.long().sum(dim=0)
        avg = _round_half_even((v * m).sum(dim=0), cnt.clamp(min=1))
        out.append(torch.where(cnt > 4, avg, _DP_COSTS[col]))
    out.insert(3, torch.full((B,), _DP_COSTS[3], dtype=torch.long, device=spans.device))
    return torch.stack(out, dim=1).to(torch.int32)


MC_G = 8  # csrc/measure_costs.cu: blocks a CTA (a 32-byte sector of a [T, B] row)
MC_ROWS = 32  # steps a pass of its 256 threads
MC_CTAS_PER_SM = 4  # CTAs resident an SM (its __launch_bounds__)
_sm_counts: dict = {}


def cost_split(T: int, B: int, sms: int) -> tuple[int, int, int]:
    """measure_costs' grid: (groups, splits, rows). groups = ceil(B / MC_G)
    block groups, each cut into `splits` ranges of `rows` steps (a multiple
    of MC_ROWS; the last range may be short or empty), the most that keep
    the grid within one wave of MC_CTAS_PER_SM CTAs an SM, so a few blocks
    still fill the card."""
    groups = -(-B // MC_G)
    if T <= 0 or groups == 0:
        return groups, 1, MC_ROWS
    passes = -(-T // MC_ROWS)
    splits = max(1, min(sms * MC_CTAS_PER_SM // groups, passes, 65535))
    rows = -(-passes // splits) * MC_ROWS
    return groups, -(-T // rows), rows


def _sm_count(device) -> int:
    key = str(device)
    n = _sm_counts.get(key)
    if n is None:
        n = _sm_counts[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def measure_costs(spans, op_len, op_val, op_rep):
    """Per-block realized DP costs of an emitted command stream.

    spans [T, B, 6] int32 (emit_model's u32 (freq << 16) | start bits),
    op_len / op_val / op_rep [T, B] int32. A nonzero span costs bits16(f) =
    (14 - log2(max(f, 1))) * 16 for f = its top 16 bits. Per block, the
    average cost of five families of commands: literals (spans 0-2),
    matches (span 0), matches without a length escape (span 1), escapes
    (spans 1-3), dictionary matches, op_rep < 0 (spans 4-5); a family of
    4 or fewer commands takes its default_dp_costs() entry, and the slope
    stays 4. Returns [B, 6] int32 cost rows for dp_parse.

    The JAX function averages float32 sums in XLA's order, which no other
    order reproduces where an average lies within float32 error of a .5
    edge. This one is exact by definition: bits16 from bits16_table
    (float64, in 2^-32 units), int64 sums, the average rounded half to
    even in integers. Kernel and plain version share the table, so they
    agree bit for bit.
    """
    if spans.device.type == "cpu":
        return measure_costs_ref(spans, op_len, op_val, op_rep)
    _build.check_cuda("measure_costs", spans, op_len, op_val, op_rep)
    if (spans.dim() != 3 or spans.shape[2] != 6 or op_len.shape != spans.shape[:2]
            or op_val.shape != op_len.shape or op_rep.shape != op_len.shape):
        raise ValueError("measure_costs: spans [T, B, 6], op_len, op_val and op_rep [T, B] int32")
    _i32("measure_costs", spans, op_len, op_val, op_rep)
    T, B, _ = spans.shape
    dev = spans.device
    if spans.data_ptr() % 8:  # the kernel reads spans in 8-byte pairs
        spans = spans.clone()
    groups, splits, rows = cost_split(T, B, _sm_count(dev))
    costs = torch.empty(B, 6, dtype=torch.int32, device=dev)
    # [B, 5] u64 sums, [B, 5] u32 counts, a u32 counter a block group
    scratch = torch.zeros((60 * B + 4 * groups + 7) // 8, dtype=torch.int64, device=dev)
    fn = _build.entry("measure_costs", "nlzm_measure_costs", 8, 4)
    _build.launch(fn, [spans.data_ptr(), op_len.data_ptr(), op_val.data_ptr(),
                       op_rep.data_ptr(), bits16_table(dev).data_ptr(),
                       _default_costs_on(dev).data_ptr(), costs.data_ptr(), scratch.data_ptr()],
                  [T, B, splits, rows], dev)
    measure_costs.launches += 1
    return costs


measure_costs.launches = 0


# ------------------------------------------------------------------ repify


def repify_ref(op_len, op_val):
    """Plain version of repify: every block's matches gathered in row
    order, then one loop iteration per match rank k, over the k-th match
    of every block at once; the slots scattered back to the match rows,
    every other row -1."""
    T, B = op_len.shape
    dev = op_len.device
    op_rep = torch.full((T, B), -1, dtype=torch.int32, device=dev)
    is_match = op_len > 0
    counts = is_match.sum(dim=0)
    K = int(counts.max()) if T and B else 0
    if K == 0:
        return op_rep
    # rows [K, B]: each block's match rows in order, then rows that are not
    # matches (their slot stays -1, so scattering it back is harmless)
    rows = torch.argsort((~is_match).to(torch.int8), dim=0, stable=True)[:K]
    vals = torch.gather(op_val, 0, rows).long()
    live = torch.arange(K, device=dev)[:, None] < counts[None, :]
    slots = torch.full((K, B), -1, dtype=torch.int32, device=dev)
    tab = torch.arange(1, 5, dtype=torch.long, device=dev).expand(B, 4).clone()
    for k in range(K):
        v = vals[k]
        eq = tab == v[:, None]
        present = eq.any(dim=1)
        slots[k] = torch.where(live[k] & present, eq.int().argmax(dim=1), -1)
        insert = live[k] & ~present
        tab = torch.where(insert[:, None], torch.cat([v[:, None], tab[:, :3]], dim=1), tab)
    return op_rep.scatter_(0, rows, slots)


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


def _wrap32(x):
    """int64 -> the int32 value of its low 32 bits (two's complement),
    still int64: i32 arithmetic that wraps, done in int64."""
    return ((x & _M32) ^ 0x80000000) - 0x80000000


def _as_i32(x):
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return _wrap32(x).to(torch.int32)


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

    The parse on the device (parser "greedy": find_matches and
    greedy_cover; "optimal": the calibrated DP parse, _calibrated_parse),
    the depth lift on the host (native.lift_deep, cap 15), repify on the
    device. Returns (op_len [T, B], op_val, op_rep, depths) as numpy; T =
    block_size rounded up to 256.
    """
    arr, n_valid = _blocks_arrays(data, block_size)
    if arr.shape[0] == 0:
        return (np.zeros((0, 0), np.int32),) * 3 + (np.zeros(0, np.int32),)
    dev = torch.device(device)
    dt = torch.as_tensor(arr, device=dev)
    nv = torch.as_tensor(n_valid, device=dev)
    num_steps = ((block_size + 255) // 256) * 256
    op_len, op_val = _device_parse(dt, nv, (1 << hist_bits) - 1, num_steps, parser)
    # owned host copies: the lift rewrites op_val through ctypes, which must
    # never write into a tensor's memory (tensor.numpy() shares it)
    op_len_h = np.array(op_len.cpu().numpy(), np.int32, order="C")
    op_val_h = np.array(op_val.cpu().numpy(), np.int32, order="C")
    depths = native.lift_deep(op_len_h, op_val_h, block_size)
    op_rep = repify(torch.as_tensor(op_len_h, device=dev), torch.as_tensor(op_val_h, device=dev))
    return op_len_h, op_val_h, op_rep.cpu().numpy(), depths


def _calibrated_parse(data, n_valid, reach: int, num_steps: int):
    """The optimal device parse: three candidates a position, then three
    rounds of dp_parse and dp_cover; after rounds 1 and 2 the commands'
    realized costs (repify, emit_model, measure_costs) become the next
    round's per-block cost rows."""
    delta, mlen = find_matches(data, n_valid, reach, num_cands=_DP_CANDS)
    costs = None
    for i in range(3):
        choice_len, choice_cand = dp_parse(delta, mlen, n_valid, costs)
        op_len, op_val = dp_cover(data, delta, choice_len, choice_cand, n_valid, num_steps)
        if i < 2:
            op_rep = repify(op_len, op_val)
            spans, _, _ = emit_model(op_len, op_val, op_rep)
            costs = measure_costs(spans, op_len, op_val, op_rep)
    return op_len, op_val


def _device_parse(data, n_valid, reach: int, num_steps: int, parser: str):
    """(op_len, op_val) [num_steps, B] of the named parse, on the device."""
    if parser == "optimal":
        return _calibrated_parse(data, n_valid, reach, num_steps)
    if parser != "greedy":
        raise ValueError(f"parser={parser!r}: 'greedy' or 'optimal'")
    delta, mlen = find_matches(data, n_valid, reach)
    return greedy_cover(data, delta, mlen, n_valid, num_steps)


def encode_pipeline_device(data, n_valid, reach: int, num_steps: int, rans_cap: int,
                           bits_cap: int, parser: str = "greedy"):
    """The whole v1 block encode on the tensors' device: data [B, N] uint8
    blocks and n_valid [B] int32 in; frame sections out, nothing copied
    back. Returns (stream [B, rans_cap] uint8, rans_bytes [B], bits
    [B, bits_cap] uint8, bits_n [B], nops [B], ncmds [B]), int32 counts."""
    op_len, op_val = _device_parse(data, n_valid, reach, num_steps, parser)
    op_rep = repify(op_len, op_val)
    spans, fields, nops = emit_model(op_len, op_val, op_rep)
    stream, rans_bytes = rans_backward(spans, rans_cap)
    bits, bits_n = bits_forward(fields, bits_cap)
    ncmds = (op_len >= 0).sum(dim=0, dtype=torch.int32)
    return stream, rans_bytes, bits, bits_n, nops, ncmds


def check_one_frame(block_size: int, hist_bits: int) -> None:
    """Raise ValueError unless a v1 device block fits one frame's chunk."""
    limit = chunk_size_for(frame_bits_for(hist_bits))
    if block_size > limit:
        raise ValueError(
            f"engine=device v1 blocks encode as one frame each: block_size "
            f"{block_size} exceeds the frame chunk capacity {limit} at "
            f"hist_bits {hist_bits} (use -blocks:{limit} or less, or the "
            f"native engine)")


def frame_caps(block_size: int) -> tuple[int, int, int]:
    """(num_steps, rans_cap, bits_cap) of encode_blocks_device's frames at
    blocks of block_size bytes: steps for all literals, and each section's
    worst case (3 and 1 bytes a byte, plus 64) rounded up to 256."""
    N = block_size
    return ((N + 255) // 256) * 256, ((3 * N + 64 + 255) // 256) * 256, \
        ((N + 64 + 255) // 256) * 256


def encode_blocks_device(data: bytes, block_size: int, hist_bits: int, parser: str = "greedy",
                         *, device="cuda", mesh=None):
    """Encode v1 blocks on `device`, one NLZM frame per block; returns
    (payloads, reads, cmds) like native.encode_blocks. Each payload is the
    12-byte frame header (u32be item count, 12 + bit-section bytes,
    rANS-section bytes), the bit section and the rANS section. Raises
    ValueError when block_size exceeds one frame's chunk at hist_bits.

    mesh: a sequence of devices (parallel/mesh.py::make_mesh) to shard the
    blocks over instead of `device`: the blocks are padded to a multiple
    of its length with empty ones (n_valid 0), each shard's rows go up to
    its device and through encode_pipeline_device there, and the real
    blocks' results come back in order (as nlzm_tpu's
    encode_blocks_tpu(mesh=))."""
    check_one_frame(block_size, hist_bits)
    arr, n_valid = _blocks_arrays(data, block_size)
    if arr.shape[0] == 0:
        return [], [], []
    num_steps, rans_cap, bits_cap = frame_caps(block_size)
    shards = [torch.device(device)] if mesh is None else [torch.device(d) for d in mesh]
    arr, n_blocks = pad_blocks(arr, len(shards))
    n_valid, _ = pad_blocks(n_valid, len(shards))
    sections = []
    for i, dev in enumerate(shards):
        lo, hi = shard_rows(arr.shape[0], len(shards), i)
        sections.append(encode_pipeline_device(
            torch.as_tensor(arr[lo:hi], device=dev), torch.as_tensor(n_valid[lo:hi], device=dev),
            (1 << hist_bits) - 1, num_steps, rans_cap, bits_cap, parser))
    payloads, reads, cmds = [], [], []
    for sec in sections:
        p, r, c = frame_payloads(*sec)
        payloads += p
        reads += r
        cmds += c
    return payloads[:n_blocks], reads[:n_blocks], cmds[:n_blocks]


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
