"""v1 block entropy decoder: one LZ command per step, all blocks at once.

Counterpart of nlzm_tpu/ops/decode_v2.py::fsm_decode_v2 (NLZM.cpp:
1967-2012 command loop, 666-731 frame reads). Each step of a block runs
the frame init when the frame's op budget is spent, then up to six
predicated reads of adaptive 17-fence CDFs (4-lane interleaved 32-bit
rANS, 16-bit renorm), up to two raw-bit fields (MSB-first), the rep
move-to-front table, and emits one command (op_len, op_val).

fsm_decode_v2 dispatches on the device of its input: CUDA tensors launch
csrc/fsm_decode.cu, CPU tensors run fsm_decode_v2_ref, a step loop
vectorised across blocks like the JAX scan (on a card, one step's CUDA
graph replayed). The model state is one
[B, 72, 17] bank in the layout of ops/cdf_ops.py (the JAX decoder keeps
the same rows as eight per-family tensors). u32 rANS and bit-word
arithmetic is carried in int64 masked to 32 bits, i32 positions wrap as
in JAX (_i32).

State across the port: the decoder's only input is the staged stream
matrix [B, S] uint8 from parallel/blocks.py::pack_streams (or a bucket
of it), the same numpy array the JAX function takes, so the tests hand
one array to both and no converter is needed (unlike the wide path's
staged_from_jax).
"""

import torch

from .. import _build
from .cdf_ops import (
    CTX_CMD,
    CTX_DIST_HI,
    CTX_DIST_LO,
    CTX_LEN_DIRECT,
    CTX_LEN_EXT_HI,
    CTX_LEN_EXT_LO,
    CTX_LIT_HI,
    CTX_LIT_LO,
    NUM_CTX,
    initial_bank,
    mixin_tensor,
)

_M32 = 0xFFFFFFFF


def _i32(x):
    """int64 tensor -> the same values wrapped to signed 32 bits."""
    return ((x + 0x80000000) & _M32) - 0x80000000


_STATE = ("rans", "rans_pos", "bit_pos", "word", "word_bits", "num_ops", "frame_ptr", "done",
          "rep_tab")


def _ref_setup(data):
    """fsm_decode_v2_ref's constants and initial state on data's device:
    (k, s). k holds the constant tensors and the model bank [B * 72, 17],
    which every step updates in place; s the per-block state (_STATE),
    rans [B, 4] with column 0 the current lane."""
    B, S = data.shape
    dev = data.device
    L = torch.long
    pad = (-S) % 4
    d = torch.cat([data, data.new_zeros(B, pad)], 1).long() if pad else data.long()
    mixin = torch.as_tensor(mixin_tensor(), dtype=L, device=dev)  # [3, 16, 17]
    zero = torch.zeros(B, dtype=L, device=dev)
    k = dict(d=d, ar=torch.arange(16, device=dev), rows=torch.arange(B, device=dev),
             bank=torch.as_tensor(initial_bank(), dtype=L, device=dev).repeat(B, 1),
             mix4=mixin[0], mix8=mixin[1], mix16=mixin[2], zero=zero,
             CMD=torch.full((B,), CTX_CMD, dtype=L, device=dev),
             TWO=torch.full((B,), 2, dtype=L, device=dev))
    s = dict(rans=torch.zeros(B, 4, dtype=L, device=dev),
             done=torch.zeros(B, dtype=torch.bool, device=dev),
             rep_tab=torch.arange(1, 5, dtype=L, device=dev).repeat(B, 1))
    for name in ("rans_pos", "bit_pos", "word", "word_bits", "num_ops", "frame_ptr"):
        s[name] = zero.clone()
    return k, s


def _ref_step(k, s, lazy: bool):
    """One step of fsm_decode_v2_ref from state s: -> (the next state,
    op_len, op_val [B] int64 of this step); k["bank"] is updated in
    place. lazy: run the frame init only if a block needs it (a host
    sync on a device), else predicated."""
    d, ar, bank, zero = k["d"], k["ar"], k["bank"], k["zero"]
    B, Sp = d.shape
    W = Sp // 4
    rows72 = k["rows"] * NUM_CTX
    rans, word, word_bits = s["rans"], s["word"], s["word_bits"]
    rans_pos, bit_pos, num_ops = s["rans_pos"], s["bit_pos"], s["num_ops"]
    frame_ptr, done, rep_tab = s["frame_ptr"], s["done"], s["rep_tab"]
    st = {}  # this step's cursors: rwin/bwin windows, rel/brel offsets, reads

    def header_bytes(pos, n):
        """_byte: n bytes from pos, each index clipped to the padded row."""
        return d.gather(1, _i32(pos[:, None] + ar[:n]).clamp(0, Sp - 1))

    def window(pos, nwords):
        """_win_load2: the bytes of words clip((pos >> 2) + k), k < nwords,
        and pos's offset into them."""
        w = ((pos >> 2)[:, None] + ar[:nwords]).clamp(0, W - 1)
        return d.gather(1, ((4 * w)[:, :, None] + ar[:4]).reshape(B, 4 * nwords)), pos & 3

    def cdf_read(ctx, mix, n, pred):
        """_cdf_read on bank rows ctx [B]; mix [16, 17] or [B, 16, 17]
        adaptation targets of the row's class, n its symbol count."""
        nonlocal rans
        x = rans[:, 0]
        f = x & 0x3FFF
        flat = rows72 + ctx
        row = bank.index_select(0, flat)
        y = (f[:, None] >= row[:, 1:]).sum(1)
        # row[16] is pinned at full scale and f < 2^14, so y + 1 <= 16
        sf = row.gather(1, y[:, None] + ar[:2])
        start = sf[:, 0]
        x2 = ((sf[:, 1] - start) * (x >> 14) + (f - start)) & _M32  # u32 wrap
        renorm = x2 < (1 << 16)
        b = st["rwin"].gather(1, st["rel"][:, None] + ar[:2])
        x3 = torch.where(renorm, ((x2 << 16) | (b[:, 0] << 8) | b[:, 1]) & _M32, x2)
        rans = torch.where(pred[:, None], torch.cat([rans[:, 1:], x3[:, None]], 1), rans)
        st["rel"] = st["rel"] + 2 * (pred & renorm)
        st["reads"] = st["reads"] + pred
        yc = y.clamp(max=n - 1)
        target = mix[yc] if mix.dim() == 2 else mix[k["rows"], yc]
        upd = row + ((target - row) >> 7)
        bank.index_copy_(0, flat, torch.where(pred[:, None], upd, row))
        return y

    def bits_read(nb, pred):
        """_bits_read: MSB-first field of nb bits (nb <= 24) where pred.
        Its three refills at once: refill i runs while word_bits + 8i < 24
        and ORs into zero bits (the word holds word_bits bits at the top)."""
        nonlocal word, word_bits
        sh = 24 - word_bits[:, None] - 8 * ar[:3]
        can = pred[:, None] & (sh > 0)
        byte = st["bwin"].gather(1, st["brel"][:, None] + ar[:3])
        word = word | torch.where(can, byte << sh.clamp(min=0), 0).sum(1)
        kk = can.sum(1)
        st["brel"] = st["brel"] + kk
        word_bits = word_bits + 8 * kk
        nb = nb.clamp(0, 24)
        v = torch.where(pred & (nb > 0), word >> (32 - nb).clamp(0, 31), 0)
        word = torch.where(pred, (word << nb) & _M32, word)
        word_bits = word_bits - torch.where(pred, nb, 0)
        return v

    need = ~done & (num_ops == 0)
    if not lazy or bool(need.any()):  # _frame_init (the JAX lax.cond on any(need))
        hb = header_bytes(frame_ptr, 12).view(B, 3, 4)
        be = _i32((hb[:, :, 0] << 24) | (hb[:, :, 1] << 16) | (hb[:, :, 2] << 8) | hb[:, :, 3])
        hdr_ops, nb_bytes, nr_bytes = be.unbind(1)
        done = done | (need & (hdr_ops == 0))
        init = need & (hdr_ops != 0)
        rans_base = _i32(frame_ptr + nb_bytes)
        lb = header_bytes(rans_base, 16).view(B, 4, 4)
        seeds = lb[:, :, 0] | (lb[:, :, 1] << 8) | (lb[:, :, 2] << 16) | (lb[:, :, 3] << 24)
        num_ops = torch.where(init, hdr_ops, num_ops)
        bit_pos = torch.where(init, _i32(frame_ptr + 12), bit_pos)
        word = torch.where(init, 0, word)
        word_bits = torch.where(init, 0, word_bits)
        rans = torch.where(init[:, None], seeds, rans)
        rans_pos = torch.where(init, _i32(rans_base + 16), rans_pos)
        frame_ptr = torch.where(init, _i32(frame_ptr + nb_bytes + nr_bytes), frame_ptr)
    active = ~done
    st["rwin"], st["rel"] = window(rans_pos, 4)
    st["bwin"], st["brel"] = window(bit_pos, 3)
    st["reads"] = zero
    rel0, brel0 = st["rel"], st["brel"]

    # R0: command
    y0 = cdf_read(k["CMD"], k["mix4"], 4, active)
    is_lit = active & (y0 == 0)
    is_dict = active & (y0 == 1)
    is_rep = active & (y0 >= 2)
    is_match = is_dict | is_rep
    # B0: rep slot index
    rep_idx = bits_read(k["TWO"], is_rep)
    # R1: literal hi nibble (16 symbols) | direct length (8)
    y1 = cdf_read(torch.where(is_lit, CTX_LIT_HI, CTX_LEN_DIRECT),
                  torch.where(is_lit[:, None, None], k["mix16"], k["mix8"]),
                  torch.where(is_lit, 16, 8), active)
    esc = is_match & (y1 == 7)
    lc = y1.clamp(max=3)
    # R2: literal lo nibble | length-extension hi
    y2 = cdf_read(torch.where(is_lit, CTX_LIT_LO + y1, CTX_LEN_EXT_HI), k["mix16"], 16,
                  is_lit | esc)
    # R3: length-extension lo
    y3 = cdf_read(CTX_LEN_EXT_LO + torch.where(esc, y2, 0), k["mix16"], 16, esc)
    lv = torch.where(esc, 7 + (y2 << 4) + y3, y1)
    # R4: distance slot hi (context: length class)
    y4 = cdf_read(CTX_DIST_HI + torch.where(is_dict, lc, 0), k["mix8"], 8, is_dict)
    # R5: distance slot lo (context: length class * 8 + hi slot)
    y5 = cdf_read(CTX_DIST_LO + torch.where(is_dict, (lc << 3) + y4, 0), k["mix8"], 8, is_dict)

    # distance: both raw-bit fields in one read
    dv_slot = (y4 << 3) + y5
    small = dv_slot < 4
    ab = ((dv_slot >> 1) - 1).clamp(0, 30)
    need_bits = is_dict & ~small
    extra = bits_read(torch.where(need_bits, ab, 0), need_bits)
    bits_reads = is_rep.long() + torch.where(need_bits, 1 + (ab > 4).long(), 0)
    dv = torch.where(small, dv_slot, _i32(((2 + (dv_slot & 1)) << ab) + extra))

    # emit
    delta_dict = _i32(dv + 1)
    delta_rep = rep_tab.gather(1, rep_idx.clamp(0, 3)[:, None])[:, 0]
    delta = torch.where(is_rep, delta_rep, delta_dict)
    mmin = 2 + (delta > 0xFF).long() + (delta > 0xFFF).long() + (delta > 0xFFFFF).long()
    op_len = torch.where(active, torch.where(is_match, lv + mmin, 0), -1)
    op_val = torch.where(is_lit, (y1 << 4) + y2, delta)

    # rep MTF insert of fresh dict distances
    present = (rep_tab == delta_dict[:, None]).any(1)
    shifted = torch.cat([delta_dict[:, None], rep_tab[:, :3]], 1)
    rep_tab = torch.where((is_dict & ~present)[:, None], shifted, rep_tab)
    num_ops = _i32(num_ops - st["reads"] - bits_reads)
    rans_pos = _i32(rans_pos + (st["rel"] - rel0))
    bit_pos = _i32(bit_pos + (st["brel"] - brel0))
    new = dict(rans=rans, rans_pos=rans_pos, bit_pos=bit_pos, word=word, word_bits=word_bits,
               num_ops=num_ops, frame_ptr=frame_ptr, done=done, rep_tab=rep_tab)
    return new, op_len, op_val


def _ref_step_in_place(k, s, out_len, out_val, t_idx, lazy: bool) -> None:
    """_ref_step writing the next state into s's tensors and the step's
    pair into row t_idx of out_len, out_val, then t_idx + 1: every tensor
    it touches stays where it is, so a CUDA graph can replay it."""
    new, op_len, op_val = _ref_step(k, s, lazy)
    for name in _STATE:
        s[name].copy_(new[name])
    out_len.index_copy_(0, t_idx, op_len.to(torch.int32)[None])
    out_val.index_copy_(0, t_idx, op_val.to(torch.int32)[None])
    t_idx.add_(1)


def _captured(step, k, s, outs, dev):
    """step (a call of _ref_step_in_place on k, s and outs = (out_len,
    out_val, t_idx)) captured as a CUDA graph on dev, the current device:
    -> its replay. One eager step on copies first loads every kernel the
    capture records."""
    step({**k, "bank": k["bank"].clone()}, {n: v.clone() for n, v in s.items()},
         *(t.clone() for t in outs))
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(k, s, *outs)
    return graph.replay


def fsm_decode_v2_ref(data, num_steps: int):
    """Plain PyTorch version of fsm_decode_v2 (the contract there): a loop
    of _ref_step, each step all blocks at once.

    Two exact rewrites of the JAX step keep the op count down: the four
    rANS lanes rotate so the current lane is always column 0, and the
    renorm and bit cursors run relative to their step's window (every
    offset a step can reach lies inside it, so _win_byte's clamps never
    bind) and are folded back into the stream positions at the step's end.

    On the CPU the frame init runs only at steps where a block needs it
    (JAX's lax.cond on any(need)) and the loop ends once every block is
    done. On a CUDA device one step, its frame init predicated (the same
    result: init changes only the blocks in need), is captured as a CUDA
    graph and replayed num_steps times: no step waits for the device or
    pays the host's dispatch of its few hundred small ops.
    """
    B = data.shape[0]
    T = int(num_steps)
    dev = data.device
    k, s = _ref_setup(data)
    outs = (torch.empty(T, B, dtype=torch.int32, device=dev),
            torch.empty(T, B, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.long, device=dev))
    out_len, out_val, _ = outs
    if dev.type == "cuda" and T:
        with torch.cuda.device(dev):  # a replay runs on the current device's stream
            replay = _captured(lambda *a: _ref_step_in_place(*a, lazy=False), k, s, outs, dev)
            for _ in range(T):
                replay()
        return out_len, out_val
    for t in range(T):
        _ref_step_in_place(k, s, *outs, lazy=True)
        # once every block is done no state changes: the rest repeats step t
        if t % 64 == 63 and bool(s["done"].all()):
            out_len[t + 1 :] = out_len[t]
            out_val[t + 1 :] = out_val[t]
            break
    return out_len, out_val


def fsm_decode_v2(data, num_steps: int):
    """Entropy-decode B block streams, one command per step.

    data: [B, S] uint8 frames (zero-padded; a zero header terminates).
    num_steps: >= max commands per block, +1 for the terminator step.
    Returns (op_len [T, B], op_val [T, B]) int32, T = num_steps: op_len
    < 0 marks steps past a block's end (every one of them repeats the
    terminator step's pair), 0 a literal (op_val the byte), else a match
    of length op_len at distance op_val.
    """
    if data.device.type == "cpu":
        return fsm_decode_v2_ref(data, num_steps)
    _build.check_cuda("fsm_decode_v2", data)
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[1] == 0:
        raise ValueError("fsm_decode_v2: data must be [B, S] uint8 with S > 0")
    B, S = data.shape
    T = int(num_steps)
    pad = (-S) % 4
    if pad:
        data = torch.cat([data, data.new_zeros(B, pad)], 1)
    op_len = torch.empty(T, B, dtype=torch.int32, device=data.device)
    op_val = torch.empty(T, B, dtype=torch.int32, device=data.device)
    fn = _build.entry("fsm_decode", "nlzm_fsm_decode", 3, 3)
    _build.launch(fn, [data.data_ptr(), op_len.data_ptr(), op_val.data_ptr()],
                  [B, S + pad, T], data.device)
    fsm_decode_v2.launches += 1
    return op_len, op_val


fsm_decode_v2.launches = 0

