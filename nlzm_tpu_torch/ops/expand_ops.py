"""Parallel LZ expansion by pointer doubling.

Counterpart of nlzm_tpu/ops/expand_ops.py. Every output byte has a
literal ancestor: byte i of a match at distance d copies i - d, and the
modular closed form m - d + ((i - m) mod d) jumps to before the command
start m in one hop. Pointer doubling over those parents resolves every
ancestor in log2(depth) rounds; one gather then fills the bytes. With a
shared dictionary of D bytes, parents run in shifted coordinates: [0, D)
is the dictionary (terminal), [D, D + N) the block. A parent still
unresolved when the rounds end (a round hint below the chain depth) is
filled as the JAX fills do, from the latest literal at or before it.

lz_expand_parallel dispatches on the device of its inputs: CUDA tensors
launch csrc/lz_expand.cu, CPU tensors run lz_expand_parallel_ref.
"""

import torch

from .. import _build

_PACK_MAX = 1 << 15  # nlzm_tpu's packed-sort block limit (ops/sort_gather.py PACK_MAX)


def _max_rounds(block_size: int) -> int:
    return max(1, (block_size - 1).bit_length())


def lz_expand_parallel_ref(op_len, op_val, block_size: int, rounds_hint=None,
                           dict_arr=None):
    """Plain PyTorch expansion; the contract of lz_expand_parallel."""
    T, B = op_len.shape
    N = block_size
    D = 0 if dict_arr is None else int(dict_arr.shape[0])
    dev = op_len.device
    ol = op_len.t().long()
    ov = op_val.t().long()
    lens = torch.where(ol < 0, 0, torch.where(ol == 0, 1, ol))
    ends = lens.cumsum(1)
    starts = ends - lens
    produced = ends[:, -1].to(torch.int32) if T else torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.arange(N, device=dev).expand(B, N).contiguous()

    # covering command of each position: the first whose end lies past it
    k = torch.searchsorted(ends.contiguous(), pos, right=True)
    covered = k < T
    kc = k.clamp(max=max(T - 1, 0))
    m = starts.gather(1, kc)
    d = torch.where(ol == 0, 0, ov).gather(1, kc)
    par = torch.where(d == 0, pos, m - d + torch.remainder(pos - m, d.clamp(min=1)))
    par = torch.where(covered, par, pos)
    parent = (par + D).clamp(0, D + N - 1)

    lit_at = torch.zeros(B, N, dtype=torch.long, device=dev)
    lit_pos = torch.full((B, N), -1, dtype=torch.long, device=dev)
    is_lit = (ol == 0) & (starts < N)
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    lit_at[rows[is_lit], starts[is_lit]] = ov[is_lit] & 0xFF
    lit_pos[rows[is_lit], starts[is_lit]] = starts[is_lit]
    # an unresolved parent (rounds_hint below the chain depth) takes the
    # byte of the latest literal at or before it, as the JAX fills do;
    # with none, the last dictionary byte on the JAX sort path with a
    # dictionary (its fill sources include the dictionary), else 0
    use_sort = N <= _PACK_MAX and D + N <= 1 << 16
    last = lit_pos.cummax(1).values
    none = dict_arr[D - 1].long() if use_sort and D else 0
    fill = torch.where(last >= 0, lit_at.gather(1, last.clamp(min=0)), none)

    def compose(p):
        g = p.gather(1, (p - D).clamp(0, N - 1))
        return torch.where(p >= D, g, p)

    rounds = _max_rounds(N)
    if rounds_hint is None:
        for _ in range(rounds):
            p2 = compose(parent)
            changed = bool((p2 != parent).any())
            parent = p2
            if not changed:
                break
    else:
        for _ in range(min(int(rounds_hint), rounds)):
            parent = compose(parent)

    # the JAX sort fill with a dictionary queries min(parent, D + N - 2)
    # (its top key collides with the sort's pad key) and patches position
    # N - 1 rooted at itself with the literal there, or 0
    q = parent.clamp(max=D + N - 2) if use_sort and D else parent
    byte = fill.gather(1, (q - D).clamp(0, N - 1))
    if D:
        dict_b = dict_arr.long()[q.clamp(0, D - 1)]
        byte = torch.where(q < D, dict_b, byte)
        if use_sort:
            corner = parent[:, N - 1] == D + N - 1
            byte[:, N - 1] = torch.where(corner, lit_at[:, N - 1], byte[:, N - 1])
    out = torch.where(pos < produced[:, None].long(), byte, 0).to(torch.uint8)
    return out, produced


def lz_expand_parallel(op_len, op_val, block_size: int, rounds_hint=None, dict_arr=None):
    """op_len/op_val: [T, B] i32 (op_len < 0 past the end, 0 literal,
    else match length; op_val the byte or the distance).

    rounds_hint: exact doubling rounds (from the container's chain
    depths), or None to run until a round changes nothing. dict_arr:
    optional [D] uint8 shared dictionary. Returns (out [B, block_size]
    uint8, produced [B] int32).
    """
    if op_len.device.type == "cpu":
        return lz_expand_parallel_ref(op_len, op_val, block_size, rounds_hint, dict_arr)
    _build.check_cuda("lz_expand_parallel", op_len, op_val, dict_arr)
    T, B = op_len.shape
    N = block_size
    D = 0 if dict_arr is None else int(dict_arr.shape[0])
    if op_val.shape != (T, B) or op_len.dtype != torch.int32 or op_val.dtype != torch.int32:
        raise ValueError("op_len/op_val must be [T, B] int32")
    if dict_arr is not None and dict_arr.dtype != torch.uint8:
        raise ValueError("dict_arr must be uint8")
    dev = op_len.device
    pa = torch.empty(B, N, dtype=torch.int32, device=dev)
    pb = torch.empty_like(pa)
    lit_at = torch.empty(B, N, dtype=torch.uint8, device=dev)
    lit_mask = torch.empty(B, (N + 31) // 32, dtype=torch.int32, device=dev)
    out = torch.empty(B, N, dtype=torch.uint8, device=dev)
    produced = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _build.entry("lz_expand", "nlzm_lz_expand", 9, 6)
    rounds = -1 if rounds_hint is None else int(rounds_hint)
    _build.launch(
        fn,
        [op_len.data_ptr(), op_val.data_ptr(),
         None if dict_arr is None else dict_arr.data_ptr(),
         pa.data_ptr(), pb.data_ptr(), lit_at.data_ptr(), lit_mask.data_ptr(), out.data_ptr(),
         produced.data_ptr()],
        [T, B, N, D, rounds, _max_rounds(N)],
        dev,
    )
    lz_expand_parallel.launches += 1
    return out, produced


lz_expand_parallel.launches = 0


def scatter_blocks(parts, n_blocks: int, block_size: int, total_len: int, device) -> bytes:
    """Decoded buckets [(out [Bk, block_size] uint8, block_index_list), ...]
    on `device` -> host bytes: block b at b * block_size, cut to total_len."""
    dev = torch.device(device)
    full = torch.zeros(n_blocks, block_size, dtype=torch.uint8, device=dev)
    for out, idx in parts:
        full[torch.as_tensor(idx, device=dev)] = out
    return full.cpu().numpy().tobytes()[:total_len]
