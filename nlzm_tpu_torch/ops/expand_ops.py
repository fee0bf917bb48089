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
On JAX's packed path (32 KiB blocks, D + N <= 65536) a block with a
command or literal word out of that path's 15/16-bit packing takes JAX's
sorts word for word, as JAX computes it.

lz_expand_parallel dispatches on the device of its inputs: CUDA tensors
launch csrc/lz_expand.cu, CPU tensors run lz_expand_parallel_ref. The wide
decode's main path hands its commands over as [B, TP] (op_len, op_val)
pairs instead (_lz_expand_rows: what csrc/assemble.cu writes, read in
place, with no transpose); it counts as a launch of lz_expand_parallel.
"""

import torch

from .. import _build

_PACK_MAX = 1 << 15  # nlzm_tpu's packed-sort block limit (ops/sort_gather.py PACK_MAX)
_M32 = 0xFFFFFFFF  # a u32 word, held in int64; also the packed sorts' pad key
_MASK_SMEM = 160 * 1024  # csrc/lz_expand.cu: masks in shared memory up to this size
_DIRECT_B = 8  # csrc/lz_expand.cu: blocks up to which one tile of [T, B] is read as it is
_TILE = 8192  # csrc/lz_expand.cu: command slots a tile (NT x CPT)


def _max_rounds(block_size: int) -> int:
    return max(1, (block_size - 1).bit_length())


def scratch_words(T: int, B: int, N: int, D: int, rows: bool = False) -> int:
    """int32 scratch words of csrc/lz_expand.cu's launch (its layout_of):
    past DIRECT_B blocks or one TILE of slots, the transposed commands
    ([B, TP] pairs, TP = T rounded up to even), none when they come as
    pairs (rows); on the packed path, in one slot of L words a block,
    those and the packed emulation's sorts (L the power of two at or above
    max(D + T + N, 2 TP)); above it two parent rows, the literal bytes
    and, past MASK_SMEM, the masks."""
    transpose = not rows and T > 0 and (B > _DIRECT_B or T > _TILE)
    TP = (T + 1) & ~1 if transpose else 0
    if packed_path(N, D):
        return B * max(2, 1 << (max(D + T + N, 2 * TP) - 1).bit_length())
    W = (N + 31) // 32
    return (2 * B * TP + 2 * B * N + (B * N + 3) // 4
            + (0 if 8 * W <= _MASK_SMEM else 2 * B * W))


def packed_path(block_size: int, dict_len: int) -> bool:
    """JAX's packed-sort path (nlzm_tpu/ops/expand_ops.py:255): one u32 word
    a record, positions and payloads packed to 15 or 16 bits."""
    return block_size <= _PACK_MAX and dict_len + block_size <= 1 << 16


def _wrap32(x):
    """int64 -> the int32 it wraps to, as int64."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _departs(ol, ov, starts, lens, D: int):
    """[B] bool: blocks with a word out of JAX's packing (so its sorts give
    what the simple fills do not). starts: int32-wrapped. A command of
    length > 0 with a start outside 0..2^16 - 1 (2^15 - 1 with a
    dictionary) or a delta outside 0..2^15 - 1 (2^16 - 1); a literal
    whose op_val is outside 0..2^15 - 1, or, with a dictionary, whose
    position D + start is past 2^16 - 1."""
    is_lit = ol == 0
    delta = torch.where(is_lit, 0, ov)
    span, pay = (1 << 15, 1 << 16) if D else (1 << 16, 1 << 15)
    bad = (lens > 0) & ((starts < 0) | (starts >= span) | (delta < 0) | (delta >= pay))
    bad |= is_lit & ((ov < 0) | (ov >= 1 << 15) | (starts + D >= 1 << 16))
    return bad.any(1)


def _sparse_fill(src, qry, post, pb: int):
    """nlzm_tpu's _sparse_fill, word for word, in int64: the merged sort of
    source and query words ([b, S], [b, Q] u32 values; invalid sources the
    pad key), the tag test, the cummax fill, post(filled, qpay), the
    route-back sort and its first Q results."""
    pmask = (1 << pb) - 1
    s = torch.cat([src, qry], 1).sort(1).values
    is_q = ((s >> pb) & 1).bool() & (s != _M32)
    filled = torch.where(is_q | (s == _M32), 0, s).cummax(1).values
    res = post(filled, s & pmask)
    key2 = torch.where(is_q, ((s & pmask) << pb) | res, _M32)
    return key2.sort(1).values[:, : qry.shape[1]] & pmask


def _packed_parents(ol, ov, starts, lens, N: int, D: int):
    """_parent_fill_sorted[_dict]'s parents (shifted by D) on these rows."""
    pb = 16 if D else 15
    delta = torch.where(ol == 0, 0, ov)
    src = torch.where(lens > 0, (((starts & _M32) << (pb + 1)) & _M32) | (delta & _M32), _M32)
    i = torch.arange(N, device=ol.device).expand(ol.shape[0], N)

    def post(filled, qpay):
        m, d = filled >> (pb + 1), filled & ((1 << pb) - 1)
        par = torch.where(d == 0, qpay, m - d + torch.remainder(qpay - m, d.clamp(min=1)))
        return (par + D).clamp(0, D + N - 1)

    return _sparse_fill(src, (((i << 1) | 1) << pb) | i, post, pb)


def _packed_bytes(ol, ov, starts, parent, dict_arr, N: int, D: int):
    """_byte_fill_sorted / _byte_fill_dict's bytes (int64) on these rows."""
    is_lit = ol == 0
    pos = _wrap32(starts + D) & _M32
    src = torch.where(is_lit, ((pos << 16) & _M32) | (ov & _M32), _M32)
    key = parent.clamp(max=D + N - 2) if D else parent
    if D:
        dpos = torch.arange(D, device=ol.device)
        src = torch.cat([((dpos << 16) | dict_arr.long()).expand(ol.shape[0], D), src], 1)
    i = torch.arange(N, device=ol.device).expand(ol.shape[0], N)
    out = _sparse_fill(src, (((key << 1) | 1) << 15) | i, lambda f, q: f & 0xFF, 15)
    if D:  # the pad-key corner: position N - 1 rooted at itself
        last = _wrap32(torch.where(is_lit & (starts == N - 1), ov, 0).sum(1))
        out[:, N - 1] = torch.where(parent[:, N - 1] == D + N - 1, last, out[:, N - 1])
    return out & 0xFF


def _doubling(parent, N: int, D: int, rounds_hint):
    """The synchronous rounds parent <- parent o parent, through parents >=
    D only: min(rounds_hint, log2 N) of them, or until one changes nothing."""

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
    return parent


def lz_expand_parallel_ref(op_len, op_val, block_size: int, rounds_hint=None,
                           dict_arr=None):
    """Plain PyTorch expansion; the contract of lz_expand_parallel.

    On JAX's packed path a block with a word out of its packing (_departs)
    runs JAX's sorts word for word instead (a host sync)."""
    T, B = op_len.shape
    N = block_size
    D = 0 if dict_arr is None else int(dict_arr.shape[0])
    dev = op_len.device
    if T == 0:  # no command: nothing produced (JAX's expansion raises here)
        return (torch.zeros(B, N, dtype=torch.uint8, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    ol = op_len.t().long()
    ov = op_val.t().long()
    lens = torch.where(ol < 0, 0, torch.where(ol == 0, 1, ol))
    ends = lens.cumsum(1)
    starts = ends - lens
    produced = ends[:, -1].to(torch.int32)
    pos = torch.arange(N, device=dev).expand(B, N).contiguous()

    # covering command of each position: the first whose end lies past it
    k = torch.searchsorted(ends.contiguous(), pos, right=True)
    covered = k < T
    kc = k.clamp(max=T - 1)
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
    use_sort = packed_path(N, D)
    last = lit_pos.cummax(1).values
    none = dict_arr[D - 1].long() if use_sort and D else 0
    fill = torch.where(last >= 0, lit_at.gather(1, last.clamp(min=0)), none)

    parent = _doubling(parent, N, D, rounds_hint)

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
    if use_sort:
        st32 = _wrap32(starts)
        bad = _departs(ol, ov, st32, lens, D).nonzero().flatten().tolist()
        if bad:
            sel = (ol[bad], ov[bad], st32[bad])
            p = _doubling(_packed_parents(*sel, lens[bad], N, D), N, D, rounds_hint)
            byte[bad] = _packed_bytes(*sel, p, dict_arr, N, D)
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
    out = torch.empty(B, N, dtype=torch.uint8, device=dev)
    produced = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_words(T, B, N, D), dtype=torch.int32, device=dev)
    fn = _build.entry("lz_expand", "nlzm_lz_expand", 6, 6)
    _build.launch(
        fn,
        [op_len.data_ptr(), op_val.data_ptr(),
         None if dict_arr is None else dict_arr.data_ptr(), scratch.data_ptr(), out.data_ptr(),
         produced.data_ptr()],
        [T, B, N, D, -1 if rounds_hint is None else int(rounds_hint), _max_rounds(N)],
        dev,
    )
    lz_expand_parallel.launches += 1
    return out, produced


lz_expand_parallel.launches = 0


def _check_rows(cmds, T: int) -> None:
    """cmds must be contiguous int32 [B, TP, 2] pairs, TP even, 0 <= T <= TP."""
    if (cmds.dtype != torch.int32 or cmds.dim() != 3 or cmds.shape[2] != 2
            or not cmds.is_contiguous() or cmds.shape[1] % 2 or not 0 <= T <= cmds.shape[1]):
        raise ValueError(f"_lz_expand_rows: cmds must be contiguous int32 [B, TP, 2] pairs with "
                         f"TP even and 0 <= T <= TP, got {cmds.dtype} {tuple(cmds.shape)} "
                         f"(contiguous {cmds.is_contiguous()}), T = {T}")


def _lz_expand_rows(cmds, T: int, block_size: int, rounds_hint=None, dict_arr=None):
    """lz_expand_parallel on cmds [B, TP, 2] int32 (op_len, op_val) pairs,
    the first T slots of each row the commands (the wide decode's main
    path: wide_decode._assemble_rows writes them). Returns (out [B,
    block_size] uint8, produced [B] int32). The pairs are checked (dtype,
    shape, contiguity, T <= TP, 16-byte alignment, one CUDA device) before
    their address reaches the kernel."""
    _check_rows(cmds, T)
    if cmds.device.type == "cpu":
        return lz_expand_parallel_ref(cmds[:, :T, 0].t(), cmds[:, :T, 1].t(), block_size,
                                      rounds_hint, dict_arr)
    _build.check_cuda("_lz_expand_rows", cmds, dict_arr)
    if cmds.data_ptr() % 16:
        raise ValueError("_lz_expand_rows: cmds must be 16-byte aligned")
    if dict_arr is not None and dict_arr.dtype != torch.uint8:
        raise ValueError("dict_arr must be uint8")
    B, TP = cmds.shape[:2]
    N = block_size
    D = 0 if dict_arr is None else int(dict_arr.shape[0])
    dev = cmds.device
    out = torch.empty(B, N, dtype=torch.uint8, device=dev)
    produced = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_words(T, B, N, D, rows=True), dtype=torch.int32, device=dev)
    fn = _build.entry("lz_expand", "nlzm_lz_expand_rows", 5, 7)
    _build.launch(
        fn,
        [cmds.data_ptr(), None if dict_arr is None else dict_arr.data_ptr(), scratch.data_ptr(),
         out.data_ptr(), produced.data_ptr()],
        [T, TP, B, N, D, -1 if rounds_hint is None else int(rounds_hint), _max_rounds(N)],
        dev,
    )
    lz_expand_parallel.launches += 1
    return out, produced


def scatter_blocks(parts, n_blocks: int, block_size: int, device):
    """Decoded buckets [((out [Bk, block_size] uint8, produced [Bk]),
    block_index_list), ...] on `device` -> (out [n_blocks, block_size]
    uint8, produced [n_blocks] int32) there, rows in block order."""
    dev = torch.device(device)
    full = torch.zeros(n_blocks, block_size, dtype=torch.uint8, device=dev)
    produced = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
    for (out, prod), idx in parts:
        rows = torch.as_tensor(idx, device=dev)
        full[rows] = out
        produced[rows] = prod.to(torch.int32)
    return full, produced
