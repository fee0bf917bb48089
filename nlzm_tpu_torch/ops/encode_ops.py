"""Device parse of the wide-profile encode, in PyTorch with CUDA kernels.

Counterpart of the greedy branch of nlzm_tpu/ops/encode_ops.py:

1. find_matches: for every position, the k nearest earlier positions with
   the same 4-byte hash, with byte-exact match lengths (<= 264);
2. greedy_cover: one LZ command per step per block, [T, B];
3. (host) native.lift_deep bounds every byte's literal-ancestor depth;
4. repify: the rep-slot replay that marks matches whose distance is live
   in the 4-slot table.

Each kernel (csrc/find_matches.cu, greedy_cover.cu, repify.cu) has a plain
PyTorch version beside it (the *_ref functions); the public function runs
the plain version for CPU tensors and launches the kernel for CUDA
tensors. Both are exact integer code and agree with the JAX functions
array for array.

The optimal device parse (dp_parse, dp_cover, measure_costs, emit_model)
is not ported: ROADMAP.md queue A item 10b.
"""

import numpy as np
import torch

from .. import _build, native
from ..constants import HASH4_MULT

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
    if parser != "greedy":
        raise NotImplementedError(
            f"parser={parser!r}: the optimal device parse (dp_parse, dp_cover, "
            "measure_costs, emit_model) is ROADMAP.md queue A item 10b")
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
