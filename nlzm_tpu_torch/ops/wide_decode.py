"""Batched decoder for the NLZP wide profile, in PyTorch with CUDA kernels.

Counterpart of nlzm_tpu/ops/wide_decode.py, stage for stage:

1. host staging (prepare_wide): parse block payloads into compact plane
   streams, chunk-offset tables and raw-bit halfwords, uploaded as tensors;
2. stage_windows_fused: dense per-chunk renorm windows of every plane;
3. plane_scan_fused: the fused rANS decode of all five symbol planes;
4. assemble_ops: plane symbols -> LZ commands (op_len, op_val) [Tc, B]
   (on the main path _assemble_rows: [B, TP] pairs);
5. expand_ops.lz_expand_parallel: commands -> bytes (on the main path
   _lz_expand_rows, on those pairs).

Steps 2-5 each have a CUDA kernel (csrc/) and a plain PyTorch version
(the *_ref functions). Beside them, stage_plane and plane_scan are the
unfused single-plane decode (csrc/plane_decode.cu) with multi-row,
multi-read context tables: no container path runs it (wire v4's planes
are single-row and decode fused); it reads what plane_encode writes for
any plane spec. The public function dispatches on the device of
its tensors: CPU tensors run the plain version, CUDA tensors launch the
kernel. Both are exact integer code and agree with the JAX decoder array
for array on valid streams; on corrupt streams every index is clamped, so
the decode ends in a CRC failure, not a fault.

Storage: the u16 streams (hw_cat, bit_half) ride as int16 tensors holding
the raw 16 bits (the kernels read them as unsigned short, the plain
versions mask with 0xFFFF), lane seeds as int32 holding u32 bits.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..format import wide
from ..format.wide import (
    N_PLANES,
    PLANES,
    TOK_DICT,
    TOK_LIT,
    TOK_REP,
    chunk_schedule,
    padded_steps,
    parse_payload,
    parse_priors,
)
from .expand_ops import _lz_expand_rows, scatter_blocks
from .sort_gather import compact_by_rank, gather_rows

NP = N_PLANES
# Fused-scan lane layout ("slot order"): planes grouped by alphabet, the
# small alphabets first, wire order within a group - tok|len|dst|lit|lex.
# Slot q holds wire plane SLOT_PLANE[q]; lane seeds are staged this way.
SLOT_PLANE = tuple(sorted(range(NP), key=lambda p: (PLANES[p].alphabets[0] > 64, p)))
PLANE_SLOT = tuple(SLOT_PLANE.index(p) for p in range(NP))
SLOT_LANES = tuple(PLANES[p].lanes for p in SLOT_PLANE)
SLOT_BASE = tuple(int(x) for x in np.cumsum((0,) + SLOT_LANES))
LTOT = SLOT_BASE[-1]
SLOT_ALPH = tuple(PLANES[p].alphabets[0] for p in SLOT_PLANE)
# csrc/plane_scan.cu is compiled for exactly this layout
assert (SLOT_PLANE, SLOT_LANES, SLOT_ALPH) == (
    (0, 2, 4, 1, 3), (64, 32, 32, 64, 16), (4, 8, 64, 256, 256)
)

# The JAX decoder cuts every plane output to 2^15 columns for blocks of
# at most 32 KiB (its packed-sort budget; symbol counts never exceed it).
# The port keeps the cut so the command arrays keep the JAX shapes.
CAP15 = 1 << 15
_U32 = 0xFFFFFFFF


def rounds_hint_of(max_depth: int):
    """Exact pointer-doubling round budget for a max chain depth; None
    when the depth is unknown (legacy containers)."""
    if max_depth <= 0:
        return None
    return max(0, max_depth - 1).bit_length()


# ------------------------------------------------------- window staging


def stage_windows_fused_ref(hw_cat, offs, ends, WHs):
    """Plain version of stage_windows_fused. Pair counts and pair indices
    wrap in int32, as JAX's do."""
    B, H = hw_cat.shape
    src = hw_cat.long() & 0xFFFF
    nxt = torch.cat([offs[:, :, 1:], ends[:, :, None]], dim=2)
    pc = (nxt - offs).long()  # pair count per (block, plane, chunk)
    NC = offs.shape[2]
    wins = []
    for p in range(NP):
        k = torch.arange(WHs[p], device=hw_cat.device)
        q = ((offs[:, p, :, None].long() + k + (1 << 31)) & _U32) - (1 << 31)  # [B, NC, WH_p]
        w = gather_rows(src, q.reshape(B, NC * WHs[p])).reshape(B, NC, WHs[p])
        w = torch.where(k < pc[:, p, :, None], w, 0)
        wins.append(w.permute(1, 0, 2).contiguous())
    return tuple(wins)


def stage_windows_fused(hw_cat, offs, ends, WHs):
    """Every plane's dense per-chunk renorm windows.

    hw_cat [B, H] int16 (u16 bits): each block's five pair streams at
    static per-plane bases. offs [B, NP, NC] int32: global pair index of
    each chunk's first pair; ends [B, NP] int32: end of each plane's
    stream. Returns NP windows [NC, B, WH_p] int32, wire order:
    win_p[c, b, k] = hw_cat[b, offs[b, p, c] + k] below the chunk's pair
    count, 0 past it.
    """
    if hw_cat.device.type == "cpu":
        return stage_windows_fused_ref(hw_cat, offs, ends, WHs)
    _build.check_cuda("stage_windows_fused", hw_cat, offs, ends)
    B, H = hw_cat.shape
    NC = offs.shape[2]
    if (hw_cat.dtype != torch.int16 or offs.dtype != torch.int32 or ends.dtype != torch.int32
            or offs.shape != (B, NP, NC) or ends.shape != (B, NP) or len(WHs) != NP):
        raise ValueError("stage_windows_fused: hw_cat [B,H] int16, offs [B,5,NC] int32, "
                         "ends [B,5] int32, five window widths")
    sizes = [NC * B * int(w) for w in WHs]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=hw_cat.device)
    fn = _build.entry("stage_windows", "nlzm_stage_windows", 4, 8)
    _build.launch(fn, [hw_cat.data_ptr(), offs.data_ptr(), ends.data_ptr(), flat.data_ptr()],
                  [B, H, NC, *(int(w) for w in WHs)], hw_cat.device)
    stage_windows_fused.launches += 1
    return tuple(
        part.view(NC, B, int(w)) for part, w in zip(torch.split(flat, sizes), WHs)
    )


stage_windows_fused.launches = 0


# ------------------------------------------------------------ plane scan


def _build_cdf(carry, nsym: int):
    """Fence table [..., nsym + 1] from counts [..., nsym] (int64): the
    torch mirror of nlzm_tpu wide_decode._build_cdf_jnp / format.wide.
    build_cdf. fence[0] = 0, fence[nsym] = 2^14, every symbol freq >= 1."""
    tot = carry.sum(-1, keepdim=True)
    freq = 1 + (carry * (CDF_SCALE_TOTAL - nsym)) // (tot + 1)
    fences = torch.zeros(carry.shape[:-1] + (nsym + 1,), dtype=torch.long, device=carry.device)
    fences[..., 1:nsym] = freq.cumsum(-1)[..., :-1]
    fences[..., nsym] = CDF_SCALE_TOTAL
    return fences


def _uniform_fences(B: int, nsym: int, device):
    f = torch.arange(nsym + 1, device=device) * (CDF_SCALE_TOTAL // nsym)
    f[nsym] = CDF_SCALE_TOTAL
    return f.expand(B, nsym + 1)


PRIOR_MAX = 0xFFFF  # a container's priors are u16 (format/wide.py parse_priors)


def _check_priors(priors, name: str = "plane_scan_fused") -> None:
    """Raise ValueError, naming the caller `name`, unless every prior value
    is in 0..65535 (one torch.aminmax; None entries skipped). A container
    carries its priors as u16, and the kernels' 32-bit rebuild holds for
    that domain; past it JAX's int32 products and sums wrap and tot + 1
    can reach 0, so there is no single answer to match. A CUDA tensor
    costs one copy back; numpy arrays are checked on the host."""
    if priors is None:
        return
    parts = [torch.as_tensor(a).reshape(-1).long() for a in priors if a is not None]
    flat = torch.cat(parts) if parts else torch.zeros(0)
    if flat.numel():
        lo, hi = torch.aminmax(flat)
        if bool((lo < 0) | (hi > PRIOR_MAX)):  # one copy back
            raise ValueError(f"{name}: prior values must be in 0..65535")


def _cat_windows(wins):
    """JAX's pair source: each chunk's five windows concatenated in wire
    order and zero-padded to a multiple of 64 columns, [NC, B, WHc], and
    each plane's first column."""
    WHs = [int(w.shape[2]) for w in wins]
    base = [int(v) for v in np.cumsum([0] + WHs)[:NP]]
    NC, B = wins[0].shape[:2]
    pad = -sum(WHs) % 64
    parts = [w.long() for w in wins] + [torch.zeros(NC, B, pad, dtype=torch.long,
                                                    device=wins[0].device)]
    return torch.cat(parts, dim=2), base


def _scan_ref(seeds, wins, n_syms, steps: int, priors=None):
    B = seeds.shape[0]
    dev = seeds.device
    x = seeds.long() & _U32
    nsym = n_syms.long()
    cat, base_w = _cat_windows(wins)
    WHc = cat.shape[2]
    carries, fences = [], []
    for q in range(NP):
        a = SLOT_ALPH[q]
        if priors is None:
            carries.append(torch.zeros(B, a, dtype=torch.long, device=dev))
            fences.append(_uniform_fences(B, a, dev))
        else:
            carries.append(priors[SLOT_PLANE[q]].reshape(1, a).long().expand(B, a).clone())
            fences.append(_build_cdf(carries[q], a))
    lanes = [torch.arange(L, device=dev) for L in SLOT_LANES]
    outs = [torch.zeros(B, steps, L, dtype=torch.int32, device=dev) for L in SLOT_LANES]
    s = 0
    for c, clen in enumerate(chunk_schedule(steps)):
        counts = [torch.zeros(B, a, dtype=torch.long, device=dev) for a in SLOT_ALPH]
        rel = [torch.zeros(B, 1, dtype=torch.long, device=dev) for _ in range(NP)]
        for _ in range(clen):
            for q in range(NP):
                p, L, a = SLOT_PLANE[q], SLOT_LANES[q], SLOT_ALPH[q]
                lo, hi = SLOT_BASE[q], SLOT_BASE[q + 1]
                xq = x[:, lo:hi]
                f = xq & 0x3FFF
                fen = fences[q]
                y = torch.searchsorted(fen[:, 1:].contiguous(), f, right=True).clamp(max=a - 1)
                start = fen.gather(1, y)
                freq = fen.gather(1, y + 1) - start
                x2 = (freq * (xq >> CDF_SCALE_BITS) + (f - start)) & _U32
                active = (s * L + lanes[q])[None, :] < nsym[:, p : p + 1]
                ren = active & (x2 < (1 << 16))
                r = ren.long()
                rank = r.cumsum(1) - r
                # JAX's index: past its own window a lane reads the next
                # planes' windows of the chunk, then the zero padding
                if WHc:
                    pair = gather_rows(cat[c], base_w[p] + rel[q] + rank).long()
                else:
                    pair = torch.zeros_like(rank)
                xn = torch.where(ren, ((x2 << 16) | pair) & _U32, x2)
                x[:, lo:hi] = torch.where(active, xn, xq)
                rel[q] = rel[q] + r.sum(1, keepdim=True)
                y = torch.where(active, y, 0)
                counts[q].scatter_add_(1, y, active.long())
                outs[q][:, s] = y.to(torch.int32)
            s += 1
        for q in range(NP):
            carries[q] = (carries[q] >> 1) + counts[q]
            fences[q] = _build_cdf(carries[q], SLOT_ALPH[q])
    return tuple(outs[PLANE_SLOT[p]].reshape(B, steps * PLANES[p].lanes) for p in range(NP))


def plane_scan_fused_ref(seeds, wins, n_syms, steps: int, priors=None):
    """Plain version of plane_scan_fused: one loop iteration per step over
    all steps, lanes as tensors, u32 lane states carried as int64 masked to
    32 bits. Raises ValueError for a prior outside 0..65535."""
    _check_priors(priors)
    return _scan_ref(seeds, wins, n_syms, steps, priors)


@functools.lru_cache(maxsize=64)
def _schedule_tensor(steps: int, device):
    """chunk_schedule(steps) as an int32 tensor on `device`, uploaded once
    per (steps, device): a fresh upload from pageable memory would stall
    the host until the stream drains, on every scan."""
    return torch.tensor(chunk_schedule(steps), dtype=torch.int32, device=device)


def plane_scan_fused(seeds, wins, n_syms, steps: int, priors=None):
    """Decode all five planes in one fused scan.

    seeds [B, 208] int32 (u32 bits): lane states in slot order. wins: NP
    windows [NC, B, WH_p] int32, wire order, NC = len(chunk_schedule(
    steps)). n_syms [B, NP] int32, wire order. priors: optional NP
    int32 tensors of the plane alphabet's warm-start counts, wire order,
    each value in 0..65535 (else ValueError). Returns NP symbol arrays
    [B, steps * L_p] int32, wire order; a lane past its plane's symbol
    count emits 0. A renorm pair index past the plane's window reads, as
    JAX does, the chunk's windows concatenated in wire order and padded
    with zeros to a multiple of 64 columns.
    """
    _check_priors(priors)
    return _plane_scan_fused(seeds, wins, n_syms, steps, priors)


def slot_priors(priors):
    """The five wire-order prior tensors as the kernel reads them: one
    int32 tensor in slot order (tok|len|dst|lit|lex), or None."""
    if priors is None:
        return None
    return torch.cat([priors[p].reshape(-1) for p in SLOT_PLANE]).to(torch.int32)


def _plane_scan_fused(seeds, wins, n_syms, steps: int, priors=None, slot_pri=None):
    """plane_scan_fused without the prior check: for priors staged from a
    container's u16 blob, in range by construction (no host sync).
    slot_pri: slot_priors(priors), staged once; None builds it here."""
    if seeds.device.type == "cpu":
        return _scan_ref(seeds, wins, n_syms, steps, priors)
    pri = slot_priors(priors) if slot_pri is None else slot_pri
    _build.check_cuda("plane_scan_fused", seeds, n_syms, pri, *wins)
    B = seeds.shape[0]
    sched = chunk_schedule(steps)
    NC = len(sched)
    if (seeds.dtype != torch.int32 or seeds.shape != (B, LTOT) or n_syms.dtype != torch.int32
            or n_syms.shape != (B, NP) or len(wins) != NP
            or any(w.dtype != torch.int32 or w.shape[:2] != (NC, B) for w in wins)
            or (pri is not None and pri.numel() != sum(SLOT_ALPH))):
        raise ValueError("plane_scan_fused: seeds [B,208] int32, n_syms [B,5] int32, "
                         "five int32 windows [NC,B,WH], priors of the plane alphabets")
    dev = seeds.device
    sched_t = _schedule_tensor(steps, dev)
    # one allocation, split into the five planes' outputs
    widths = [steps * PLANES[p].lanes for p in range(NP)]
    flat = torch.empty(B * sum(widths), dtype=torch.int32, device=dev)
    outs = [o.view(B, w) for o, w in zip(flat.split([B * w for w in widths]), widths)]
    fn = _build.entry("plane_scan", "nlzm_plane_scan", 14, 8)
    _build.launch(
        fn,
        [seeds.data_ptr(), n_syms.data_ptr(), sched_t.data_ptr(),
         None if pri is None else pri.data_ptr(),
         *(w.data_ptr() for w in wins), *(o.data_ptr() for o in outs)],
        [B, NC, steps, *(int(w.shape[2]) for w in wins)],
        dev,
    )
    plane_scan_fused.launches += 1
    return tuple(outs)


plane_scan_fused.launches = 0


# ---------------------------------------------------- the unfused plane scan


def stage_plane(stream_list, offset_list, plane_idx: int, steps: int, *, device="cuda"):
    """One plane's inputs for plane_scan, on `device`: (seeds [B, L] int32
    holding the u32 lane states, wins [NC, B, WH] int32).

    stream_list: per block the plane's stream bytes (L u32le lane seeds,
    then the renorm pairs as u16be); offset_list: per block its chunk
    byte offsets (format/wide.py parse_payload, plane_streams). wins
    holds each chunk's pairs as big-endian values, dense and zero-padded
    to WH (the largest pair count of any (block, chunk), rounded up to 8,
    at least 8); a block's offsets pad to the chunk count of `steps` with
    its stream end. The values of nlzm_tpu's stage_plane, whose wins are
    u16.
    """
    L = wide.PLANES[plane_idx].lanes
    B = len(stream_list)
    NC = len(chunk_schedule(steps))
    seeds = np.frombuffer(b"".join(s[: 4 * L] for s in stream_list), "<u4").reshape(B, L)
    hw_lens = np.asarray([(len(s) - 4 * L) // 2 for s in stream_list], np.int64)
    hw_flat = np.frombuffer(b"".join(s[4 * L :] for s in stream_list), ">u2")
    hw_base = np.zeros(B + 1, np.int64)
    np.cumsum(hw_lens, out=hw_base[1:])

    offs = np.zeros((B, NC + 1), np.int64)
    for b, o in enumerate(offset_list):
        offs[b, : len(o)] = o
        offs[b, len(o) :] = hw_lens[b] * 2
    pair_counts = (offs[:, 1:] - offs[:, :-1]) // 2  # [B, NC]
    WH = max(8, int(-(-pair_counts.max() // 8)) * 8)
    wins = np.zeros((NC, B, WH), np.int32)
    if len(hw_flat):
        # wins[c, b, k] = hw[b][offs[b, c] / 2 + k] for k < pair_counts[b, c]
        k = np.arange(WH, dtype=np.int64)
        idx = hw_base[:-1][:, None, None] + offs[:, :-1, None] // 2 + k  # [B, NC, WH]
        mask = k < pair_counts[:, :, None]
        wins = np.where(mask, np.take(hw_flat, np.minimum(idx, len(hw_flat) - 1)), 0)
        wins = np.ascontiguousarray(wins.transpose(1, 0, 2), np.int32)
    dev = torch.device(device)
    return (torch.as_tensor(seeds.astype(np.uint32).view(np.int32), device=dev),
            torch.as_tensor(wins, device=dev))


def _wrap32(v):
    """int64 values as the int32 values they wrap to."""
    return ((v + (1 << 31)) & _U32) - (1 << 31)


def plane_scan_ref(seeds, wins, n_sym, ctx, plane_idx: int, steps: int, prior=None):
    """Plain version of plane_scan: one loop iteration per step and read,
    lanes as tensors, u32 lane states carried as int64 masked to 32 bits."""
    spec = wide.PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    B = seeds.shape[0]
    dev = seeds.device
    x = seeds.long() & _U32
    nsym = n_sym.long()[:, None]
    lane = torch.arange(L, device=dev)
    ctx = ctx.long().reshape(B, steps, L)
    carries, fences = [], []
    for r in range(R):
        nr, a = spec.rows[r], spec.alphabets[r]
        if prior is None:
            carries.append(torch.zeros(B, nr, a, dtype=torch.long, device=dev))
            fences.append(_uniform_fences(1, a, dev).reshape(1, 1, a + 1).expand(B, nr, a + 1))
        else:
            carries.append(prior[r].long().reshape(1, nr, a).expand(B, nr, a).clone())
            fences.append(_build_cdf(carries[r], a))
    outs = [torch.zeros(B, steps, L, dtype=torch.int32, device=dev) for _ in range(R)]
    s = 0
    for c, clen in enumerate(chunk_schedule(steps)):
        win = wins[c].long()
        counts = [torch.zeros(B, spec.rows[r] * spec.alphabets[r], dtype=torch.long, device=dev)
                  for r in range(R)]
        rel = torch.zeros(B, 1, dtype=torch.long, device=dev)  # the window cursor, per chunk
        for _ in range(clen):
            active = (s * L + lane)[None, :] < nsym
            row0 = ctx[:, s]
            y_prev = None
            for r in range(R):
                nr, a = spec.rows[r], spec.alphabets[r]
                if r == 0:
                    row = row0
                elif spec.name == "dst":
                    row = _wrap32(row0 * 8 + y_prev)
                else:
                    row = y_prev
                # a single-row read ignores the row; a row outside [0, rows)
                # reads as an all-zero table row (JAX's one-hot select)
                ok = torch.ones_like(active) if nr == 1 else (row >= 0) & (row < nr)
                rc = torch.zeros_like(row) if nr == 1 else row.clamp(0, nr - 1)
                tbl = fences[r].gather(1, rc[:, :, None].expand(B, L, a + 1))
                tbl = torch.where(ok[:, :, None], tbl, 0)  # [B, L, a + 1]
                f = x & 0x3FFF
                y = (f[:, :, None] >= tbl[:, :, 1:]).sum(-1)  # a on a zero row
                start = tbl.gather(2, y[:, :, None])[:, :, 0]
                end = tbl.gather(2, (y + 1).clamp(max=a)[:, :, None])[:, :, 0]
                freq = torch.where(y < a, end - start, 0)
                x2 = (freq * (x >> CDF_SCALE_BITS) + (f - start)) & _U32
                ren = active & (x2 < (1 << 16))
                rr = ren.long()
                rank = rr.cumsum(1) - rr
                pair = win.gather(1, (rel + rank).clamp(0, win.shape[1] - 1))
                x = torch.where(active, torch.where(ren, ((x2 << 16) | pair) & _U32, x2), x)
                rel = rel + rr.sum(1, keepdim=True)
                y = torch.where(active, y, 0)
                hit = active & ok & (y < a)  # out-of-range rows and symbols count nothing
                counts[r].scatter_add_(1, rc * a + y.clamp(max=a - 1), hit.long())
                outs[r][:, s] = y.to(torch.int32)
                y_prev = y
            s += 1
        for r in range(R):
            nr, a = spec.rows[r], spec.alphabets[r]
            carries[r] = (carries[r] >> 1) + counts[r].reshape(B, nr, a)
            fences[r] = _build_cdf(carries[r], a)
    return tuple(o.reshape(B, steps * L) for o in outs)


PLANE_MAX_READS = 8  # csrc/plane_decode.cu's read slots
PLANE_MAX_LANES = 1024
PLANE_MAX_SMEM = 225 << 10  # dynamic shared memory a CTA may take, below the H100's 227 KiB
# csrc/plane_decode.cu's warp path: lanes at most, ring slots, steps a chunk
# at most, the bytes of a row's fence bitmap (512 words and their counts,
# two words of padding every 16) and the table kinds
PD_WARP_LANES = 64
PD_RING = 4
PD_MAX_CLEN = wide.CHUNK_STEPS
PD_TB_BYTES = 8 * (512 + 64)
PD_REG, PD_BITMAP, PD_SEARCH = 0, 1, 2
PD_FIELDS = 92  # int64 fields of a launch (csrc/plane_decode.cu)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _row_entries(a: int) -> int:
    """Entries of a one-row read's counts and spans: 32 lanes of
    ceil(a / 32) entries rounded up to a power of two (the one-row
    kernel's vector loads and stores)."""
    return 32 << (-(-a // 32) - 1).bit_length()


class PlaneLayout(NamedTuple):
    """Where csrc/plane_decode.cu decodes a plane. warp: the warp path
    (else the general, CTA-wide one); lpt: lanes a thread; smem: dynamic
    shared bytes a CTA; kinds: per read PD_REG, PD_BITMAP or PD_SEARCH;
    tables: per read the byte offsets of its carries, counts and tables
    and a table row's bytes; ncopy: pairs of a chunk's window row copied
    to the ring, slot: ints a ring slot; ctx_at: the context rows' ring (0
    on the general path), -1 where no read keys on the context rows."""
    warp: bool
    lpt: int
    smem: int
    kinds: tuple
    tables: tuple
    ncopy: int
    slot: int
    ctx_at: int


@functools.lru_cache(maxsize=256)
def plane_decode_layout(spec, WH: int) -> PlaneLayout:
    """csrc/plane_decode.cu's layout for a plane spec and window width.

    The general path's tables (int fences, carries and counts, rows * (3
    alph + 1) ints a read) must fit PLANE_MAX_SMEM, with at most
    PLANE_MAX_READS reads and PLANE_MAX_LANES lanes; else ValueError. A
    plane of at most PD_WARP_LANES lanes whose alphabets are at most 2^14
    takes the warp path if its ring, context-row ring and tables fit
    PLANE_MAX_SMEM. Its reads: one read of one row and at most 8 symbols
    keeps its fences in registers (PD_REG); a one-row read a fence bitmap
    (PD_BITMAP); a multi-row read u16 fences, searched (PD_SEARCH)."""
    R, L = spec.reads, spec.lanes
    general = 4 * sum(spec.rows[r] * (3 * spec.alphabets[r] + 1) for r in range(R))
    if R > PLANE_MAX_READS or L > PLANE_MAX_LANES or general > PLANE_MAX_SMEM:
        raise ValueError(f"plane_scan: {R} reads, {L} lanes and {general} bytes of tables "
                         f"exceed the kernel's {PLANE_MAX_READS} reads, {PLANE_MAX_LANES} "
                         f"lanes, {PLANE_MAX_SMEM} bytes")
    keyed = spec.rows[0] > 1 or (spec.name == "dst" and max(spec.rows[1:], default=1) > 1)
    ncopy = min(WH, PD_MAX_CLEN * R * L)
    slot = -(-ncopy // 4) * 4
    at = PD_RING * slot * 4
    ctx_at = at if keyed else -1
    at += PD_RING * PD_MAX_CLEN * L * 4 if keyed else 0
    kinds, tables = [], []
    for r in range(R):
        a, n = spec.alphabets[r], spec.rows[r]
        if R == 1 and n == 1 and a <= 8:
            kinds.append(PD_REG)
            tables.append((0, 0, 0, 0))
            continue
        if n == 1:
            kinds.append(PD_BITMAP)
            entries = _row_entries(a)
            stride = PD_TB_BYTES + 4 * entries
        else:  # carries and counts at an odd stride a row
            kinds.append(PD_SEARCH)
            entries = n * (a | 1)
            stride = 2 * (a + 1)
        car = at
        cnt = car + _align16(4 * entries)
        tab = cnt + _align16(4 * entries)
        tables.append((car, cnt, tab, stride))
        at = tab + _align16(n * stride)
    lpt = 1 if L <= 32 else 2
    if L <= PD_WARP_LANES and max(spec.alphabets) <= CDF_SCALE_TOTAL and at <= PLANE_MAX_SMEM:
        return PlaneLayout(True, lpt, at, tuple(kinds), tuple(tables), ncopy, slot, ctx_at)
    return PlaneLayout(False, 1, general, (), (), ncopy, slot, 0 if keyed else -1)


def _pd_fields(seeds, wins, n_sym, ctx, spec, steps: int, prior, outs):
    """csrc/plane_decode.cu's PD_FIELDS int64 launch fields (read on the
    host, passed by value): per read its prior and output pointers, spec
    and layout; the input pointers, the sizes and plane_decode_layout."""
    B, L, R = seeds.shape[0], spec.lanes, spec.reads
    WH = int(wins.shape[2])
    lay = plane_decode_layout(spec, WH)
    fields = np.zeros(PD_FIELDS, np.int64)
    for r, (p, o) in enumerate(zip(prior, outs)):
        tabs = lay.tables[r] if lay.warp else (0, 0, 0, 0)
        fields[9 * r: 9 * r + 9] = (0 if p is None else p.data_ptr(), o.data_ptr(),
                                    spec.alphabets[r], spec.rows[r],
                                    lay.kinds[r] if lay.warp else 0, *tabs)
    aligned = lambda *ts: all(t.data_ptr() % 16 == 0 for t in ts)
    fields[9 * PLANE_MAX_READS:] = (
        seeds.data_ptr(), wins.data_ptr(), n_sym.data_ptr(), ctx.data_ptr(),
        B, L, R, steps, int(wins.shape[0]), WH, int(spec.name == "dst"), lay.ncopy, lay.slot,
        lay.ctx_at, int(WH % 4 == 0 and aligned(wins)), int(L % 2 == 0 and aligned(ctx)),
        int(L % 4 == 0 and aligned(*outs)), int(lay.warp), lay.lpt, lay.smem)
    return fields


def plane_scan(seeds, wins, n_sym, ctx, plane_idx: int, steps: int, prior=None):
    """Decode one plane for all blocks.

    The plane's spec is wide.PLANES[plane_idx], read at call time. seeds
    [B, L] int32 (u32 bits) and wins [NC, B, WH] int32 from stage_plane,
    NC = len(chunk_schedule(steps)); n_sym [B] int32 symbol counts; ctx
    [B, steps * L] int32 context rows of the first read (reads after it
    key their row on the previous read's symbol: row0 * 8 + y for a plane
    named "dst", else y; single-row reads ignore the row); prior: None,
    or one [rows, alph] int32 tensor of warm-start counts per read, each
    value in 0..65535 (else ValueError). Returns per read a [B, steps * L]
    int32 symbol array; a lane past n_sym emits 0, a row outside [0, rows)
    decodes as alph from an all-zero table row.
    """
    spec = wide.PLANES[plane_idx]
    if prior is not None and (len(prior) != spec.reads or any(p is None for p in prior)):
        raise ValueError(f"plane_scan: prior is None or one tensor for each of the "
                         f"{spec.reads} reads")
    _check_priors(prior, "plane_scan")
    return _plane_scan(seeds, wins, n_sym, ctx, plane_idx, steps, prior)


def _plane_scan(seeds, wins, n_sym, ctx, plane_idx: int, steps: int, prior=None):
    """plane_scan without the prior checks: for priors in range by
    construction (a container's u16 blob), with no copy back."""
    spec = wide.PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    if seeds.device.type == "cpu":
        return plane_scan_ref(seeds, wins, n_sym, ctx, plane_idx, steps, prior)
    prior = (None,) * R if prior is None else tuple(prior)
    _build.check_cuda("plane_scan", seeds, wins, n_sym, ctx, *prior)
    B = seeds.shape[0]
    sched = chunk_schedule(steps)
    NC = len(sched)
    if (seeds.dtype != torch.int32 or seeds.shape != (B, L) or wins.dtype != torch.int32
            or wins.dim() != 3 or wins.shape[:2] != (NC, B) or wins.shape[2] < 1
            or n_sym.dtype != torch.int32 or n_sym.shape != (B,)
            or ctx.dtype != torch.int32 or ctx.shape != (B, steps * L) or sum(sched) != steps
            or len(prior) != R
            or any(p is not None and (p.dtype != torch.int32
                                      or p.numel() != spec.rows[r] * spec.alphabets[r])
                   for r, p in enumerate(prior))):
        raise ValueError("plane_scan: seeds [B,L] int32, wins [NC,B,WH] int32, n_sym [B] int32, "
                         "ctx [B,steps*L] int32, steps = sum(chunk_schedule(steps)), prior int32 "
                         "[rows,alph] per read")
    dev = seeds.device
    outs = [torch.empty(B, steps * L, dtype=torch.int32, device=dev) for _ in range(R)]
    fields = _pd_fields(seeds, wins, n_sym, ctx, spec, steps, prior, outs)
    _build.launch(_build.entry("plane_decode", "nlzm_plane_decode", 1, 0), [fields.ctypes.data],
                  [], dev)
    plane_scan.launches += 1
    return tuple(outs)


plane_scan.launches = 0


# -------------------------------------------------------------- assembly


def _bits_fetch(bit_half, offs, width):
    """MSB-first field of `width` (<= 16) bits at bit offset `offs` (both
    [B, Tc]) from big-endian halfwords [B, H] (int16 holding u16)."""
    src = bit_half.long() & 0xFFFF
    h0 = offs >> 4
    hw0 = gather_rows(src, h0).long()
    hw1 = gather_rows(src, h0 + 1).long()
    word = (hw0 << 16) | hw1
    w = width.clamp(0, 16)
    v = ((word << (offs & 15)) & _U32) >> (32 - w.clamp(min=1))
    return torch.where(width > 0, v, 0)


def _check_pack(planes, bit_half, big: bool) -> None:
    """JAX's packed path (big false) asserts that no plane and no raw-bit
    row is wider than its packing (2^15); raise ValueError there."""
    if not big and any(a.shape[1] > CAP15 for a in (*planes, bit_half)):
        raise ValueError(f"assemble_ops: a plane or the raw-bit row is wider than {CAP15} on "
                         f"the packed path (big=False): widths "
                         f"{[a.shape[1] for a in (*planes, bit_half)]}")


def _packed_compaction(delta_dict, d_rank, is_dict, Tc: int, pb: int):
    """JAX's compact_by_rank (pb 15: i32 keys) / compact_by_rank16 (pb 16:
    u32 keys) word for word, in int64: key (rank << pb) | delta for a dict
    (delta unmasked, so one outside the payload spills into the rank
    bits), PACK_MAX << pb for every other slot; sorted, masked to the
    payload, zero from the row's dict count on."""
    rank = torch.where(is_dict, d_rank, CAP15)
    vals = torch.where(is_dict, delta_dict, 0)
    key = (rank << pb) | (vals if pb == 15 else vals & _U32)
    out = key.sort(1).values & ((1 << pb) - 1)
    live = torch.arange(Tc, device=key.device)[None, :] < is_dict.sum(1, keepdim=True)
    return torch.where(live, out, 0)


def assemble_ops_ref(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big=False,
                     wide_delta=False):
    """Plain version of assemble_ops."""
    _check_pack((tok_y, len_y, lex_y, lit_y, slot_y), bit_half, big)
    B, Tc = tok_y.shape
    dev = tok_y.device
    tok = tok_y.long()
    active = torch.arange(Tc, device=dev)[None, :] < n_cmds.long()[:, None]
    is_lit = active & (tok == TOK_LIT)
    is_rep = active & (tok == TOK_REP)
    is_dict = active & (tok == TOK_DICT)
    is_match = is_rep | is_dict

    def rank_of(m):  # exclusive prefix count
        c = m.long()
        return c.cumsum(1) - c

    m_rank = rank_of(is_match)
    len_sym = torch.where(is_match, gather_rows(len_y, m_rank).long(), 0)
    esc = is_match & (len_sym == 7)
    ext = torch.where(esc, gather_rows(lex_y, rank_of(esc)).long(), 0)
    lv = torch.where(esc, 7 + ext, len_sym)
    d_rank = rank_of(is_dict)

    slot = torch.where(is_dict, gather_rows(slot_y, d_rank).long(), 0)
    is_big_slot = slot >= 4
    # the format maximum (128 KiB blocks + dictionary) keeps ab <= 16
    ab = torch.where(is_dict & is_big_slot, (slot >> 1) - 1, 0).clamp(0, 16)
    widths = torch.where(is_rep, 2, 0) + ab
    v = _bits_fetch(bit_half, widths.cumsum(1) - widths, widths)
    rep_idx = torch.where(is_rep, v, 0)
    extra = torch.where(is_dict, v, 0)
    dv = torch.where(is_big_slot, ((2 + (slot & 1)) << ab) + extra, slot)
    delta_dict = torch.where(is_dict, dv + 1, 0)

    # rep r = the r-th most recent dict distance (virtual history 1..4);
    # on JAX's packed path a row with a dict distance outside the payload
    # (2^15, or 2^16 with wide_delta) compacts them as JAX's sort does
    D = compact_by_rank(delta_dict, d_rank, is_dict, Tc)
    if not big:
        pb = 16 if wide_delta else 15
        bad = (is_dict & ((delta_dict < 0) | (delta_dict >= 1 << pb))).any(1)
        if bool(bad.any()):
            rows = bad.nonzero().flatten()
            D[rows] = _packed_compaction(delta_dict[rows], d_rank[rows], is_dict[rows], Tc,
                                         pb).to(torch.int32)
    j = d_rank - 1 - rep_idx
    delta_rep = torch.where(j >= 0, gather_rows(D, j.clamp(min=0)).long(), -j)
    delta = torch.where(is_rep, delta_rep, delta_dict)

    byte = torch.where(is_lit, gather_rows(lit_y, rank_of(is_lit)).long(), 0)
    mmin = 2 + (delta > 0xFF).long() + (delta > 0xFFF).long() + (delta > 0xFFFFF).long()
    op_len = torch.where(active, torch.where(is_match, lv + mmin, 0), -1)
    op_val = torch.where(is_match, delta, byte)
    return op_len.t().to(torch.int32).contiguous(), op_val.t().to(torch.int32).contiguous()


def _assemble_launch(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big: bool,
                     wide_delta: bool):
    """csrc/assemble.cu on CUDA tensors: the [B, TP, 2] int32 pairs."""
    planes = (tok_y, len_y, lex_y, lit_y, slot_y)
    _build.check_cuda("assemble_ops", bit_half, n_cmds)
    B, Tc = tok_y.shape
    if (any(a.device != bit_half.device or a.dtype != torch.int32 or a.dim() != 2
            or a.shape[0] != B or a.stride(1) != 1 or (Tc and a.shape[1] < 1) for a in planes)
            or bit_half.dtype != torch.int16 or bit_half.dim() != 2 or bit_half.shape[0] != B
            or (Tc and bit_half.shape[1] < 1)
            or n_cmds.dtype != torch.int32 or n_cmds.shape != (B,)):
        raise ValueError("assemble_ops: [B, W >= 1] int32 planes with unit inner stride on the "
                         "device of bit_half [B, H >= 1] int16, n_cmds [B] int32")
    _check_pack(planes, bit_half, big)
    TP = (Tc + 1) & ~1
    cmds = torch.empty(B, TP, 2, dtype=torch.int32, device=tok_y.device)
    fn = _build.entry("assemble", "nlzm_assemble", 8, 14)
    geom = []
    for a in planes:
        geom += [a.shape[1], a.stride(0)]
    _build.launch(
        fn,
        [*(a.data_ptr() for a in planes), bit_half.data_ptr(), n_cmds.data_ptr(),
         cmds.data_ptr()],
        [B, *geom, bit_half.shape[1], TP, 0 if big else (16 if wide_delta else 15)],
        tok_y.device,
    )
    assemble_ops.launches += 1
    return cmds


def assemble_ops(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big=False,
                 wide_delta=False):
    """Plane symbols -> (op_len [Tc, B], op_val [Tc, B]) int32 for
    lz_expand_parallel; Tc = tok_y.shape[1].

    Plane arrays are [B, width] int32 and may be column slices (unit
    inner stride); bit_half [B, H] int16 (u16 bits); n_cmds [B] int32.
    big and wide_delta as in JAX's assemble_ops: big false is its packed
    path (widths up to 2^15, else ValueError), where a dict distance past
    2^15 (2^16 with wide_delta, a shared dictionary's reach) changes what
    reps read as JAX's packed sort does. Both default as in JAX
    (decode_wide_staged passes them as JAX's decode does). The
    kernel writes [B, TP] pairs (_assemble_rows); here they are transposed
    back with torch.
    """
    if tok_y.device.type == "cpu":
        return assemble_ops_ref(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big,
                                wide_delta)
    Tc = tok_y.shape[1]
    cmds = _assemble_launch(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big,
                            wide_delta)
    return cmds[:, :Tc, 0].t().contiguous(), cmds[:, :Tc, 1].t().contiguous()


assemble_ops.launches = 0


def _rows_of(op_len, op_val):
    """[Tc, B] op_len / op_val -> [B, TP, 2] int32 pairs, TP = Tc rounded up
    to even, the padding slot (-1, 0)."""
    Tc, B = op_len.shape
    cmds = torch.zeros(B, (Tc + 1) & ~1, 2, dtype=torch.int32, device=op_len.device)
    cmds[:, :, 0] = -1
    cmds[:, :Tc, 0] = op_len.t()
    cmds[:, :Tc, 1] = op_val.t()
    return cmds


def _assemble_rows(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big=False,
                   wide_delta=False):
    """assemble_ops as the wide decode's main path takes it: [B, TP, 2]
    int32 (op_len, op_val) pairs, TP = Tc rounded up to even (the padding
    slot -1, 0), for expand_ops._lz_expand_rows. A launch of assemble_ops
    on CUDA tensors; the plain version's outputs stacked on CPU ones."""
    if tok_y.device.type == "cpu":
        return _rows_of(*assemble_ops_ref(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds,
                                          big, wide_delta))
    return _assemble_launch(tok_y, len_y, lex_y, lit_y, slot_y, bit_half, n_cmds, big,
                            wide_delta)


# ---------------------------------------------------------- host staging


def _prepare_wide_np(payloads, priors_blob: bytes | None = None) -> dict:
    """Parse block payloads into the staged arrays, as numpy: the same
    arrays, layouts and widths as nlzm_tpu's prepare_wide builds before
    its upload, in its dict format (see staged_from_jax)."""
    B = len(payloads)
    counts = np.zeros((B, NP), np.int64)
    plane_streams = [[] for _ in range(NP)]
    plane_offsets = [[] for _ in range(NP)]
    bit_chunks = []
    for b, p in enumerate(payloads):
        cnts, streams, offsets, bits = parse_payload(p)
        for i in range(NP):
            counts[b, i] = cnts[i]
            plane_streams[i].append(streams[i])
            plane_offsets[i].append(offsets[i])
        bit_chunks.append(bits)

    # one global step count for the fused scan (the max of the planes'
    # padded counts is itself a valid schedule sum)
    steps = max(
        padded_steps(int(counts[:, i].max()), PLANES[i].lanes) for i in range(NP)
    )
    NC = len(chunk_schedule(steps))

    seeds_cat = np.zeros((B, LTOT), np.uint32)
    hw_lens = np.zeros((B, NP), np.int64)
    for i in range(NP):
        L = PLANES[i].lanes
        q0 = SLOT_BASE[PLANE_SLOT[i]]
        seeds_cat[:, q0 : q0 + L] = np.frombuffer(
            b"".join(s[: 4 * L] for s in plane_streams[i]), "<u4"
        ).reshape(B, L)
        hw_lens[:, i] = [(len(s) - 4 * L) // 2 for s in plane_streams[i]]
    Hmax = np.maximum(8, hw_lens.max(axis=0))
    bases = np.zeros(NP + 1, np.int64)
    np.cumsum(Hmax, out=bases[1:])

    hw_cat = np.zeros((B, int(bases[-1])), np.uint16)
    offs_g = np.zeros((B, NP, NC), np.int32)
    ends_g = np.zeros((B, NP), np.int32)
    for i in range(NP):
        L = PLANES[i].lanes
        flat = np.frombuffer(b"".join(s[4 * L :] for s in plane_streams[i]), ">u2")
        base = 0
        b0 = int(bases[i])
        for b in range(B):
            n = int(hw_lens[b, i])
            hw_cat[b, b0 : b0 + n] = flat[base : base + n]
            base += n
            o = plane_offsets[i][b]
            offs_g[b, i, : len(o)] = b0 + (o // 2)
            offs_g[b, i, len(o) :] = b0 + n
            ends_g[b, i] = b0 + n

    pair_counts = np.concatenate([offs_g[:, :, 1:], ends_g[:, :, None]], axis=2) - offs_g
    WHs = tuple(
        max(8, int(-(-pair_counts[:, i, :].max() // 8)) * 8) for i in range(NP)
    )

    hmax = (max(len(x) for x in bit_chunks) + 1) // 2 + 2
    bit_arr = np.zeros((B, hmax), np.uint16)
    for b, c in enumerate(bit_chunks):
        cb = np.frombuffer(c + b"\x00" * (len(c) & 1), np.uint8).astype(np.uint16)
        bit_arr[b, : len(cb) // 2] = (cb[0::2] << 8) | cb[1::2]
    priors = None
    if priors_blob:
        priors = {
            name: [np.asarray(a, np.int32) for a in pr]
            for name, pr in parse_priors(priors_blob).items()
        }
    return {
        "priors": priors,
        "n_sym": [counts[:, i].astype(np.int32) for i in range(NP)],
        "seeds_cat": seeds_cat,
        "hw_cat": hw_cat,
        "offs": offs_g,
        "ends": ends_g,
        "WHs": WHs,
        "bit_half": bit_arr,
        "steps": [steps] * NP,
    }


def staged_from_jax(staged_np: dict, device) -> dict:
    """The port's staged dict from a nlzm_tpu prepare_wide staged dict.

    staged_np holds the JAX dict's arrays as numpy (any array-like that
    numpy converts will do). The port's dict: seeds_cat [B, 208] int32
    (u32 bits), hw_cat [B, H] int16 and bit_half [B, Hb] int16 (u16
    bits), offs [B, 5, NC] / ends [B, 5] int32, n_sym [B, 5] int32,
    priors (five int32 [alph] tensors, wire order) or None, slot_priors
    (slot_priors(priors): what the kernel reads), dict_arr [D] uint8 or
    None, all on `device`; and the host-side WHs, steps (int)
    and rounds_hint. (nlzm_tpu's "bases" and "B" are implied by the
    shapes and not carried.)
    """
    dev = torch.device(device)

    def put(a, dtype, view=None):
        a = np.array(a, dtype=dtype)  # an owned, writable copy
        return torch.as_tensor(a if view is None else a.view(view), device=dev)

    priors = staged_np.get("priors")
    out = {
        "seeds_cat": put(staged_np["seeds_cat"], np.uint32, np.int32),
        "hw_cat": put(staged_np["hw_cat"], np.uint16, np.int16),
        "offs": put(staged_np["offs"], np.int32),
        "ends": put(staged_np["ends"], np.int32),
        "WHs": tuple(int(w) for w in staged_np["WHs"]),
        "bit_half": put(staged_np["bit_half"], np.uint16, np.int16),
        "n_sym": put(np.stack([np.asarray(a) for a in staged_np["n_sym"]], axis=1), np.int32),
        "priors": None if not priors else tuple(
            put(np.asarray(priors[PLANES[p].name][0]).reshape(-1), np.int32)
            for p in range(NP)
        ),
        "steps": int(staged_np["steps"][0]),
        "rounds_hint": staged_np.get("rounds_hint"),
        "dict_arr": None,
    }
    out["slot_priors"] = slot_priors(out["priors"])  # as the kernel reads them
    if staged_np.get("dict_arr") is not None:
        out["dict_arr"] = put(staged_np["dict_arr"], np.uint8)
    return out


def prepare_wide(payloads, priors_blob: bytes | None = None, *, device) -> dict:
    """Host prep: parse block payloads and stage them on `device`."""
    return staged_from_jax(_prepare_wide_np(payloads, priors_blob), device)


N_BUCKETS = 2  # nlzm_tpu's prepare_wide_bucketed default, the one its decode uses


def prepare_wide_bucketed(payloads, priors_blob: bytes | None = None, *, device):
    """Quantile buckets by tok symbol count, each staged on its own
    (smaller) widths: [(staged, block_index_list), ...]. One bucket when
    B <= 8 * N_BUCKETS, as in nlzm_tpu."""
    B = len(payloads)
    if B <= N_BUCKETS * 8:
        return [(prepare_wide(payloads, priors_blob, device=device), list(range(B)))]
    tok_counts = [int.from_bytes(p[0:4], "big") for p in payloads]
    order = sorted(range(B), key=lambda b: tok_counts[b])
    out = []
    for k in range(N_BUCKETS):
        idx = order[k * B // N_BUCKETS : (k + 1) * B // N_BUCKETS]
        if idx:
            out.append((prepare_wide([payloads[b] for b in idx], priors_blob, device=device), idx))
    return out


# ---------------------------------------------------------------- driver


def stage_windows_of(staged):
    """Windows from a staged dict."""
    return stage_windows_fused(staged["hw_cat"], staged["offs"], staged["ends"], staged["WHs"])


def decode_wide_staged(staged, block_size: int):
    """Staged plane streams -> (out [B, block_size] uint8, produced [B]).

    As JAX's decode: blocks up to 32 KiB take the packed path (planes cut
    to 2^15 columns, big false), with wide_delta when a shared dictionary
    is set. The commands pass from assembly to expansion as [B, TP] pairs
    (_assemble_rows, _lz_expand_rows)."""
    n_sym = staged["n_sym"]
    dict_arr = staged.get("dict_arr")
    ys = _plane_scan_fused(
        staged["seeds_cat"], stage_windows_of(staged), n_sym, staged["steps"], staged["priors"],
        staged.get("slot_priors"),
    )
    big = block_size > CAP15
    if not big:
        ys = tuple(a[:, : min(a.shape[1], CAP15)] for a in ys)
    tok_y, lit_y, len_y, lex_y, slot_y = ys
    cmds = _assemble_rows(tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
                          n_sym[:, 0].contiguous(), big, dict_arr is not None)
    return _lz_expand_rows(cmds, tok_y.shape[1], block_size, staged.get("rounds_hint"), dict_arr)


def dict_tensor(dictionary: bytes | None, device):
    """The container's shared dictionary as a [D] uint8 tensor on
    `device`, or None for none."""
    if not dictionary:
        return None
    return torch.as_tensor(np.frombuffer(dictionary, np.uint8).copy(), device=torch.device(device))


def stage_buckets(payloads, priors_blob: bytes | None, max_depth, dict_arr, *, device):
    """prepare_wide_bucketed, with each bucket's doubling budget and the
    shared dictionary set: [(staged, block_index_list), ...] on `device`.

    max_depth: the chain depth of each block (the container's
    total_reads, or its slice for these payloads); each bucket runs the
    exact budget of its deepest block. dict_arr: the container's shared
    dictionary (virtual history before every block) from dict_tensor, or
    None.
    """
    dev = torch.device(device)
    buckets = prepare_wide_bucketed(payloads, priors_blob, device=dev)
    for staged, idx in buckets:
        staged["rounds_hint"] = rounds_hint_of(max((max_depth[b] for b in idx), default=0))
        staged["dict_arr"] = dict_arr
    return buckets


def decode_wide_blocks(payloads, block_size: int, priors_blob: bytes | None, max_depth, dict_arr,
                       *, device):
    """Decode wide-profile block payloads on `device` (arguments as in
    stage_buckets) -> (out [B, block_size] uint8, produced [B] int32)
    there, rows in block order (expand_ops.py::scatter_blocks)."""
    parts = [(decode_wide_staged(staged, block_size), idx)
             for staged, idx in stage_buckets(payloads, priors_blob, max_depth, dict_arr,
                                              device=device)]
    return scatter_blocks(parts, len(payloads), block_size, device)
