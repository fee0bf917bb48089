"""Canonical Huffman research codec (Moffat-Turpin style): host coder and
the batched device decode, in PyTorch with a CUDA kernel.

Counterpart of nlzm_tpu/research/huff0.py. The host side is a copy of
the original (code lengths limited to 14 bits, canonical codes,
left-justified decode tables, the bit writer, the per-block container and
the adaptive scheme), pinned to it by tests/test_torch_host.py: each copy
gives byte-equal output.

The device decode runs every block of a container in lockstep, one symbol
a block a step: _huff_scan dispatches on the device of its tensors, CPU
tensors to the plain version _huff_scan_ref, CUDA tensors to
csrc/huff_scan.cu. decode(data) runs it on "cuda" by default: this
departs from nlzm_tpu on purpose, whose decode defaults to the serial
host decoder and names the device engine "tpu". Here engine="device" is
the default, as the port's encodes name it, "host" is the serial decoder,
and "tpu" is refused.
"""

import struct

import numpy as np
import torch

from .. import _build

CODE_LEN_LIMIT = 14
_PEEK = CODE_LEN_LIMIT


# ---------------------------------------------------------------- tables
def code_lengths(counts) -> np.ndarray:
    """Length-limited Huffman code lengths over 256 symbols (all coded)."""
    counts = np.maximum(np.asarray(counts, dtype=np.int64), 1)

    while True:
        lengths = _huffman_depths(counts)
        if lengths.max() <= CODE_LEN_LIMIT:
            return lengths
        counts = np.maximum(counts >> 1, 1)


def _huffman_depths(counts: np.ndarray) -> np.ndarray:
    """Two-queue Huffman: leaves sorted ascending + FIFO of merged nodes."""
    n = len(counts)
    order = np.argsort(counts, kind="stable")
    leaf_w = counts[order]
    # nodes: (weight, children) with leaves as ints, internals as tuples
    merged_w = []
    merged_kids = []
    li = 0
    mi = 0

    def pop_min():
        nonlocal li, mi
        take_leaf = li < n and (mi >= len(merged_w) or leaf_w[li] <= merged_w[mi])
        if take_leaf:
            li += 1
            return leaf_w[li - 1], int(order[li - 1])
        mi += 1
        return merged_w[mi - 1], merged_kids[mi - 1]

    for _ in range(n - 1):
        w1, k1 = pop_min()
        w2, k2 = pop_min()
        merged_w.append(w1 + w2)
        merged_kids.append((k1, k2))

    depths = np.zeros(n, dtype=np.int32)
    stack = [(merged_kids[-1], 0)]
    while stack:
        node, d = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], d + 1))
            stack.append((node[1], d + 1))
        else:
            depths[node] = d
    return depths


def canonical_codes(lengths: np.ndarray):
    """Canonical assignment: codes ordered by (length, symbol).

    Returns (codes u32[256], first_code u32[15], offset i32[15],
    sym_table u8[256])."""
    lengths = np.asarray(lengths, dtype=np.int32)
    counts_per_len = np.bincount(lengths, minlength=CODE_LEN_LIMIT + 1)
    first = np.zeros(CODE_LEN_LIMIT + 2, dtype=np.int64)
    code = 0
    for length in range(1, CODE_LEN_LIMIT + 1):
        first[length] = code
        code = (code + counts_per_len[length]) << 1
    assert code <= (1 << (CODE_LEN_LIMIT + 1)), "over-subscribed code"

    codes = np.zeros(256, dtype=np.uint32)
    sym_table = np.zeros(256, dtype=np.uint8)
    offset = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int32)
    nxt = first.copy()
    k = 0
    for length in range(1, CODE_LEN_LIMIT + 1):
        offset[length] = k
        for s in range(256):
            if lengths[s] == length:
                codes[s] = nxt[length]
                nxt[length] += 1
                sym_table[k] = s
                k += 1
    return codes, first[: CODE_LEN_LIMIT + 1].astype(np.uint32), offset, sym_table


def left_tables(lengths: np.ndarray):
    """Left-justified decode tables: for each length L, the 14-bit-justified
    limit of its code range plus the symbol offset."""
    _, first, offset, sym_table = canonical_codes(lengths)
    counts_per_len = np.bincount(lengths, minlength=CODE_LEN_LIMIT + 1)
    base_left = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int64)
    limit_left = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int64)
    for L in range(1, CODE_LEN_LIMIT + 1):
        base_left[L] = int(first[L]) << (_PEEK - L)
        limit_left[L] = (int(first[L]) + int(counts_per_len[L])) << (_PEEK - L)
    return base_left, limit_left, offset, sym_table


# ---------------------------------------------------------------- host bit io
def _encode_payload(data: bytes, lengths: np.ndarray) -> bytes:
    """Each symbol's canonical code, MSB first, at its bit position (the
    sum of the lengths before it), packed into bytes; then the flush of a
    32-bit writer: the partial byte and three zero bytes."""
    d = np.frombuffer(bytes(data), np.uint8)
    lengths = np.asarray(lengths, np.int64)
    ln, code = lengths[d], canonical_codes(lengths)[0].astype(np.int64)[d]
    pos = np.cumsum(ln) - ln
    n = int(ln.sum())
    bits = np.zeros(n, np.uint8)
    for k in range(CODE_LEN_LIMIT):
        m = k < ln
        bits[pos[m] + k] = (code[m] >> (ln[m] - 1 - k)) & 1
    out = np.zeros(n // 8 + 4, np.uint8)
    packed = np.packbits(bits)
    out[: len(packed)] = packed
    return out.tobytes()


def _decode_payload(payload: bytes, lengths: np.ndarray, n: int) -> bytes:
    base_left, limit_left, offset, sym_table = left_tables(lengths)
    out = bytearray()
    word = 0
    bits = 0
    pos = 0
    for _ in range(n):
        while bits < _PEEK and pos < len(payload):
            word = ((word << 8) | payload[pos]) & 0x3FFFFF
            pos += 1
            bits += 8
        peek = (word >> (bits - _PEEK)) & (_PEEK_MASK)
        L = 1
        while L < CODE_LEN_LIMIT and peek >= limit_left[L]:
            L += 1
        idx = offset[L] + ((peek - base_left[L]) >> (_PEEK - L))
        out.append(int(sym_table[idx]))
        bits -= L
    return bytes(out)


_PEEK_MASK = (1 << _PEEK) - 1


# ---------------------------------------------------------------- containers
MAGIC = b"NLZH"
_HDR = struct.Struct(">4sBxHIQ")


def encode(data: bytes, block_size: int = 32768) -> bytes:
    """Per-block static canonical-Huffman container (device-decodable)."""
    nblocks = (len(data) + block_size - 1) // block_size if data else 0
    out = bytearray(_HDR.pack(MAGIC, 1, 0, nblocks, len(data)))
    metas = []
    payloads = []
    for b in range(nblocks):
        chunk = data[b * block_size : (b + 1) * block_size]
        lengths = code_lengths(np.bincount(np.frombuffer(chunk, np.uint8), minlength=256))
        payload = _encode_payload(chunk, lengths)
        # 256 nibble lengths (1..14 fit a nibble)
        packed = bytes(
            (int(lengths[2 * i]) - 1) | ((int(lengths[2 * i + 1]) - 1) << 4)
            for i in range(128)
        )
        metas.append(struct.pack(">I", len(payload)) + packed)
        payloads.append(payload)
    for m in metas:
        out += m
    for p in payloads:
        out += p
    # store block_size after header for ragged reconstruction
    return bytes(out[: _HDR.size]) + struct.pack(">I", block_size) + bytes(out[_HDR.size :])


def _parse(data: bytes):
    magic, ver, _, nblocks, total = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not an NLZH container")
    (block_size,) = struct.unpack_from(">I", data, _HDR.size)
    off = _HDR.size + 4
    sizes = []
    lens = []
    for _ in range(nblocks):
        (ps,) = struct.unpack_from(">I", data, off)
        packed = data[off + 4 : off + 4 + 128]
        arr = np.zeros(256, np.int32)
        for i, byte in enumerate(packed):
            arr[2 * i] = (byte & 0xF) + 1
            arr[2 * i + 1] = (byte >> 4) + 1
        sizes.append(ps)
        lens.append(arr)
        off += 4 + 128
    return block_size, total, sizes, lens, off


def _truncated(data: bytes, block: int = 1, cut: int = 37) -> bytes:
    """The container with block `block`'s payload size lowered by `cut`:
    that payload ends early and every later one starts inside it (a
    corrupt input for the decode's clamps)."""
    sizes = _parse(data)[2]
    at = _HDR.size + 4 + 132 * block
    blob = bytearray(data)
    blob[at : at + 4] = struct.pack(">I", max(sizes[block] - cut, 0))
    return bytes(blob)


def decode(data: bytes, engine: str = "device", device="cuda") -> bytes:
    """Decode a huff0 block container.

    engine="device" (the default) decodes every block in lockstep on
    `device` ("cuda" unless the caller names another; CPU tensors run
    the plain version); engine="host" runs the serial Python decoder.
    nlzm_tpu's decode defaults to its host decoder and calls the device
    engine "tpu"; the port refuses that name.
    """
    if engine not in ("device", "host"):
        raise ValueError(f"huff0.decode: engine must be 'device' or 'host', not {engine!r}")
    block_size, total, sizes, lens, off = _parse(data)
    if engine == "device":
        return _decode_device(data, block_size, total, sizes, lens, off, device)
    out = bytearray()
    for b, (ps, lengths) in enumerate(zip(sizes, lens)):
        n = min(block_size, total - b * block_size)
        out += _decode_payload(data[off : off + ps], lengths, n)
        off += ps
    return bytes(out)


# ---------------------------------------------------------------- device decode
def stage_blocks(data, block_size, total, sizes, lens, off, device):
    """The device decode's inputs from a parsed container, on `device`:
    (streams [B, S] uint8, each block's payload zero-padded to S =
    max(sizes) + 8; base_l, limit_l, offs [B, 15] int32 and syms [B, 256]
    int32, the left-justified tables; n_out [B] numpy, the bytes of each
    block; T = max(n_out)). The arrays of nlzm_tpu's _decode_tpu."""
    B = len(sizes)
    S = max(sizes) + 8
    streams = np.zeros((B, S), np.uint8)
    for b, ps in enumerate(sizes):
        streams[b, :ps] = np.frombuffer(data, np.uint8, ps, off)
        off += ps

    base_l = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    limit_l = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    offs = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    syms = np.zeros((B, 256), np.int32)
    for b, lengths in enumerate(lens):
        bl, ll, o, st = left_tables(lengths)
        base_l[b], limit_l[b], offs[b], syms[b] = bl, ll, o, st

    n_out = np.minimum(np.full(B, block_size), np.maximum(total - np.arange(B) * block_size, 0))
    dev = torch.device(device)
    put = lambda a: torch.as_tensor(a, device=dev)
    return (put(streams), put(base_l), put(limit_l), put(offs), put(syms), n_out,
            int(n_out.max()))


def _decode_device(data, block_size, total, sizes, lens, off, device):
    """Batched canonical-Huffman decode: B blocks advance one symbol per
    step (nlzm_tpu's _decode_tpu)."""
    if not sizes:
        return b""
    streams, base_l, limit_l, offs, syms, n_out, T = stage_blocks(
        data, block_size, total, sizes, lens, off, device)
    out = _huff_scan(streams, base_l, limit_l, offs, syms, T).cpu().numpy()  # [B, T]
    keep = np.arange(T)[None, :] < n_out[:, None]
    return out[keep].tobytes()[:total]


def _stream_bytes(streams, n: int):
    """[B, n] int64: byte q of each block's stream as the decode reads it,
    for q < n. JAX reads byte q from a window of u32 words clamped to the
    stream zero-padded to W words: byte q & 3 of word min(q >> 2, W - 1)."""
    B, S = streams.shape
    W = (S + 3) // 4
    padded = torch.zeros(B, 4 * W, dtype=torch.long, device=streams.device)
    padded[:, :S] = streams.long()
    q = torch.arange(n, device=streams.device)
    return padded[:, ((q >> 2).clamp(max=W - 1) << 2) | (q & 3)]


def _huff_scan_ref(streams, base_l, limit_l, offs, syms, T: int):
    """Plain version of _huff_scan: one loop iteration per step, blocks as
    tensors. The code length and symbol of every 14-bit peek value are
    tabulated up front; a step reads the peek at its bit offset, looks
    both up and advances by the length. The index arithmetic wraps in
    int32, as JAX's does."""
    B = streams.shape[0]
    dev = streams.device
    peek = torch.arange(1 << _PEEK, device=dev)
    L = (1 + (peek[None, :, None] >= limit_l[:, None, 1:].long()).sum(2)).clamp(1, CODE_LEN_LIMIT)
    i32 = lambda v: ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    idx = i32(offs.long().gather(1, L) + (i32(peek - base_l.long().gather(1, L)) >> (_PEEK - L)))
    sym_of = syms.long().gather(1, idx.clamp(0, 255)).to(torch.uint8)  # [B, 2^14]
    # bytes p, p + 1, p + 2 as one 24-bit value: the 14 bits at offset cb
    # are (v[cb >> 3] >> (10 - (cb & 7))) & 0x3FFF
    n = (CODE_LEN_LIMIT * T >> 3) + 1
    v = _stream_bytes(streams, n + 2)
    v = (v[:, :n] << 16) | (v[:, 1 : n + 1] << 8) | v[:, 2 : n + 2]
    cb = torch.zeros(B, 1, dtype=torch.long, device=dev)  # bits consumed
    out = torch.empty(B, T, dtype=torch.uint8, device=dev)
    for t in range(T):
        pk = (v.gather(1, cb >> 3) >> (10 - (cb & 7))) & _PEEK_MASK
        out[:, t : t + 1] = sym_of.gather(1, pk)
        cb = cb + L.gather(1, pk)
    return out


def _huff_scan(streams, base_l, limit_l, offs, syms, T: int):
    """Decode T symbols of every block: [B, T] uint8 (nlzm_tpu's
    _huff_scan_body writes [T, B]; its unused n_out argument is left out).

    streams [B, S] uint8; base_l, limit_l, offs [B, 15] int32; syms
    [B, 256] int32. Every block takes T steps whatever its length. JAX
    refills a 22-bit window to >= 14 bits with up to two bytes a step and
    peeks at its top 14: that is, exactly, the 14 bits at the step's bit
    offset (the sum of the lengths before it) of the stream as
    _stream_bytes reads it. The code length L is 1 + the count of limits
    <= the peek, clipped to [1, 14]; the symbol is syms at offs[L] +
    ((peek - base_l[L]) >> (14 - L)), clipped to [0, 255].
    """
    if streams.device.type == "cpu":
        return _huff_scan_ref(streams, base_l, limit_l, offs, syms, T)
    _build.check_cuda("huff_scan", streams, base_l, limit_l, offs, syms)
    B, S = streams.shape
    tables = (base_l, limit_l, offs)
    if (streams.dtype != torch.uint8 or S < 1 or syms.dtype != torch.int32
            or syms.shape != (B, 256)
            or any(a.dtype != torch.int32 or a.shape != (B, CODE_LEN_LIMIT + 1) for a in tables)):
        raise ValueError("huff_scan: streams [B,S] uint8, base_l/limit_l/offs [B,15] int32, "
                         "syms [B,256] int32")
    out = torch.empty(B, T, dtype=torch.uint8, device=streams.device)
    fn = _build.entry("huff_scan", "nlzm_huff_scan", 6, 3)
    _build.launch(fn, [streams.data_ptr(), base_l.data_ptr(), limit_l.data_ptr(),
                       offs.data_ptr(), syms.data_ptr(), out.data_ptr()], [B, S, T],
                  streams.device)
    _huff_scan.launches += 1
    return out


_huff_scan.launches = 0


# ---------------------------------------------------------------- adaptive
def adaptive_encode(data: bytes, initial_frame: int = 4096, max_frame: int = 32768) -> bytes:
    """Semi-static scheme of the reference research coder: each frame uses
    the table built from the previous frame (bootstrap uniform)."""
    out = bytearray(b"NLZA")
    counts = np.ones(256, np.int64)
    frame = initial_frame
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + frame]
        lengths = code_lengths(counts)
        payload = _encode_payload(chunk, lengths)
        out += struct.pack(">II", len(chunk), len(payload))
        out += payload
        counts = np.bincount(np.frombuffer(chunk, np.uint8), minlength=256).astype(np.int64)
        pos += len(chunk)
        frame = min(frame * 2, max_frame)
    out += struct.pack(">II", 0, 0)
    return bytes(out)


def adaptive_decode(data: bytes, initial_frame: int = 4096, max_frame: int = 32768) -> bytes:
    if data[:4] != b"NLZA":
        raise ValueError("not an NLZA stream")
    out = bytearray()
    counts = np.ones(256, np.int64)
    pos = 4
    while True:
        n, ps = struct.unpack_from(">II", data, pos)
        pos += 8
        if n == 0:
            break
        lengths = code_lengths(counts)
        chunk = _decode_payload(data[pos : pos + ps], lengths, n)
        out += chunk
        counts = np.bincount(np.frombuffer(chunk, np.uint8), minlength=256).astype(np.int64)
        pos += ps
    return bytes(out)
