"""ctypes binding of the repo's native host engine (native/libnlzmx.so).

A copy of the part of nlzm_tpu/native.py the port calls: CRC32, block
encode and decode, threaded v1 block encode and decode, the command
expansion of the wide host decode (with and without a shared
dictionary), the bounded-memory single-stream encoder and decoder
(StreamEncoder, StreamDecoder: codec.py's file paths), the native wide
encode pipeline, and the pieces the device wide encode runs around its
kernels (native parse, depth lift, rep classification, host plane
encode). native/ is the repo's C++ engine (built by `make -C native` from
native/src/, at first use); this module loads the same library.
"""

import ctypes
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from .format.wide import priors_blob_size

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libnlzmx.so"

_PARSER_IDS = {"greedy": 0, "optimal": 1}


class NativeUnavailable(RuntimeError):
    pass


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(f"cannot build native library: {e}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))

    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64 = ctypes.c_longlong
    c_i64p = ctypes.POINTER(c_i64)
    c_i32p = ctypes.POINTER(ctypes.c_int)

    lib.nlzmx_crc32.restype = ctypes.c_uint
    lib.nlzmx_crc32.argtypes = [c_u8p, c_i64, ctypes.c_uint]

    lib.nlzmx_encode_block.restype = c_i64
    lib.nlzmx_encode_block.argtypes = [c_u8p, c_i64, ctypes.c_int, ctypes.c_int, c_u8p, c_i64, c_i64p]

    lib.nlzmx_decode_block.restype = c_i64
    lib.nlzmx_decode_block.argtypes = [c_u8p, c_i64, ctypes.c_int, c_u8p, c_i64]

    lib.nlzmx_expand_ops.restype = c_i64
    lib.nlzmx_expand_ops.argtypes = [c_i32p, c_i32p, c_i64, c_u8p, c_i64]

    lib.nlzmx_expand_ops_dict.restype = c_i64
    lib.nlzmx_expand_ops_dict.argtypes = [c_i32p, c_i32p, c_i64, c_u8p, c_i64, c_u8p, c_i64]

    lib.nlzmx_wide_encode_data.restype = ctypes.c_int
    lib.nlzmx_wide_encode_data.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_u8p, c_i64, c_i64p, c_u8p, c_i32p, c_i32p, c_i64p,
        c_u8p, c_i64, c_u8p, ctypes.c_int,
    ]

    lib.nlzmx_encode_blocks.restype = ctypes.c_int
    lib.nlzmx_encode_blocks.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_u8p, c_i64, c_i64p, c_i64p, c_i64p,
    ]

    lib.nlzmx_decode_blocks.restype = ctypes.c_int
    lib.nlzmx_decode_blocks.argtypes = [
        c_u8p, c_i64, c_i64p, c_i64, ctypes.c_int, c_i64, ctypes.c_int, c_u8p, c_i64,
    ]

    lib.nlzmx_senc_new.restype = ctypes.c_void_p
    lib.nlzmx_senc_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nlzmx_senc_feed.restype = ctypes.c_int
    lib.nlzmx_senc_feed.argtypes = [ctypes.c_void_p, c_u8p, c_i64, ctypes.c_int]
    lib.nlzmx_senc_pending.restype = c_i64
    lib.nlzmx_senc_pending.argtypes = [ctypes.c_void_p]
    lib.nlzmx_senc_take.restype = c_i64
    lib.nlzmx_senc_take.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_senc_free.restype = None
    lib.nlzmx_senc_free.argtypes = [ctypes.c_void_p]
    lib.nlzmx_sdec_new.restype = ctypes.c_void_p
    lib.nlzmx_sdec_new.argtypes = [ctypes.c_int]
    lib.nlzmx_sdec_feed.restype = ctypes.c_int
    lib.nlzmx_sdec_feed.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_sdec_pending.restype = c_i64
    lib.nlzmx_sdec_pending.argtypes = [ctypes.c_void_p]
    lib.nlzmx_sdec_take.restype = c_i64
    lib.nlzmx_sdec_take.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_sdec_free.restype = None
    lib.nlzmx_sdec_free.argtypes = [ctypes.c_void_p]

    lib.nlzmx_parse_blocks.restype = ctypes.c_int
    lib.nlzmx_parse_blocks.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, c_i32p, c_i32p, c_i64,
    ]

    lib.nlzmx_classify_reps.restype = None
    lib.nlzmx_classify_reps.argtypes = [c_i32p, c_i32p, c_i64, c_i64, c_i32p]

    lib.nlzmx_lift_deep.restype = None
    lib.nlzmx_lift_deep.argtypes = [
        c_i32p, c_i32p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p,
        c_i64,
    ]

    lib.nlzmx_wide_encode.restype = ctypes.c_int
    lib.nlzmx_wide_encode.argtypes = [
        c_i32p, c_i32p, c_i32p, c_i64, c_i64, ctypes.c_int, ctypes.c_int,
        c_u8p, c_i64, c_i64p, c_u8p,
    ]
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def crc32(data: bytes, prev: int = 0) -> int:
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return prev
    return load().nlzmx_crc32(_u8p(buf), len(buf), prev)


def encode_block(data: bytes, hist_bits: int, parser: str = "optimal"):
    """Encode one block -> (payload_bytes, total_reads, num_cmds)."""
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = max(4096, len(data) * 2 + 65536)
    dst = np.empty(cap, dtype=np.uint8)
    stats = np.zeros(2, dtype=np.int64)
    sz = lib.nlzmx_encode_block(
        _u8p(src) if len(src) else _u8p(dst),
        len(src),
        hist_bits,
        _PARSER_IDS[parser],
        _u8p(dst),
        cap,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if sz < 0:
        raise RuntimeError("native encode failed (capacity)")
    return dst[:sz].tobytes(), int(stats[0]), int(stats[1])


def decode_block(payload: bytes, hist_bits: int, out_cap: int) -> bytes:
    lib = load()
    src = np.frombuffer(payload, dtype=np.uint8)
    dst = np.empty(max(out_cap, 1), dtype=np.uint8)
    got = lib.nlzmx_decode_block(_u8p(src), len(src), hist_bits, _u8p(dst), out_cap)
    if got < 0:
        raise RuntimeError("native decode failed")
    return dst[:got].tobytes()


def expand_ops(op_len: np.ndarray, op_val: np.ndarray, out_cap: int,
               dictionary: bytes | None = None) -> bytes:
    """Expand one block's op arrays (int32, aligned) into bytes.

    dictionary: optional shared-dict bytes as virtual history before the
    output start (distances may reach len(dictionary) bytes back)."""
    lib = load()
    op_len = np.ascontiguousarray(op_len, dtype=np.int32)
    op_val = np.ascontiguousarray(op_val, dtype=np.int32)
    dst = np.empty(max(out_cap, 1), dtype=np.uint8)
    if dictionary:
        darr = np.frombuffer(dictionary, dtype=np.uint8)
        got = lib.nlzmx_expand_ops_dict(_i32p(op_len), _i32p(op_val), len(op_len), _u8p(dst),
                                        out_cap, _u8p(darr), len(darr))
    else:
        got = lib.nlzmx_expand_ops(_i32p(op_len), _i32p(op_val), len(op_len), _u8p(dst), out_cap)
    if got < 0:
        raise RuntimeError("native expand failed")
    return dst[:got].tobytes()


def _feed_ptr(arr: np.ndarray):
    return _u8p(arr) if len(arr) else _u8p(np.zeros(1, np.uint8))


class StreamEncoder:
    """Bounded-memory streaming NLZM encoder (frames-only payload).

    Feed input in chunks, drain compressed bytes as they complete; the
    native state holds O(window) whatever the file size (the reference's
    overlapped-refill loop, NLZM.cpp:1870-1885). Byte-identical to
    encode_block on the same input (same chunk schedule)."""

    def __init__(self, hist_bits: int, parser: str = "optimal"):
        self._lib = load()
        self._h = self._lib.nlzmx_senc_new(hist_bits, _PARSER_IDS[parser])
        self.hist_bits = hist_bits

    def feed(self, data: bytes, final: bool = False) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        self._lib.nlzmx_senc_feed(self._h, _feed_ptr(arr), len(arr), 1 if final else 0)
        n = self._lib.nlzmx_senc_pending(self._h)
        if n == 0:
            return b""
        buf = np.empty(n, np.uint8)
        got = self._lib.nlzmx_senc_take(self._h, _u8p(buf), n)
        return buf[:got].tobytes()

    def close(self):
        if self._h:
            self._lib.nlzmx_senc_free(self._h)
            self._h = None

    __del__ = close


class StreamDecoder:
    """Bounded-memory streaming NLZM decoder (frames-only payload).

    Feed compressed bytes, drain decoded output; the native state holds
    one window of history. `done` flips when the sentinel frame is seen."""

    def __init__(self, hist_bits: int):
        self._lib = load()
        self._h = self._lib.nlzmx_sdec_new(hist_bits)
        self.done = False

    def feed(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        rc = self._lib.nlzmx_sdec_feed(self._h, _feed_ptr(arr), len(arr))
        if rc < 0:
            raise RuntimeError("corrupt NLZM stream")
        if rc == 1:
            self.done = True
        n = self._lib.nlzmx_sdec_pending(self._h)
        if n == 0:
            return b""
        buf = np.empty(n, np.uint8)
        got = self._lib.nlzmx_sdec_take(self._h, _u8p(buf), n)
        return buf[:got].tobytes()

    def close(self):
        if self._h:
            self._lib.nlzmx_sdec_free(self._h)
            self._h = None

    __del__ = close


def encode_blocks(data: bytes, block_size: int, hist_bits: int, parser: str = "optimal"):
    """Threaded block encode -> (list of payloads, reads, cmds)."""
    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return [], [], []
    threads = min(os.cpu_count() or 1, nblocks)
    src = np.frombuffer(data, dtype=np.uint8)
    block_cap = block_size * 2 + 65536
    dst = np.empty(nblocks * block_cap, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    reads = np.zeros(nblocks, dtype=np.int64)
    cmds = np.zeros(nblocks, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_longlong)
    rc = lib.nlzmx_encode_blocks(
        _u8p(src), n, block_size, hist_bits, _PARSER_IDS[parser], threads,
        _u8p(dst), block_cap,
        sizes.ctypes.data_as(p64), reads.ctypes.data_as(p64), cmds.ctypes.data_as(p64),
    )
    if rc != 0:
        raise RuntimeError("native block encode failed")
    payloads = [dst[b * block_cap : b * block_cap + sizes[b]].tobytes() for b in range(nblocks)]
    return payloads, reads.tolist(), cmds.tolist()


def decode_blocks(payloads: list, hist_bits: int, block_size: int, total_len: int) -> bytes:
    """Threaded block decode of per-block v1 payloads, cut to total_len."""
    lib = load()
    nblocks = len(payloads)
    if nblocks == 0:
        return b""
    threads = min(os.cpu_count() or 1, nblocks)
    stride = max(len(p) for p in payloads) + 8
    src = np.zeros(nblocks * stride, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    for b, p in enumerate(payloads):
        src[b * stride : b * stride + len(p)] = np.frombuffer(p, dtype=np.uint8)
        sizes[b] = len(p)
    dst = np.empty(nblocks * block_size, dtype=np.uint8)
    rc = lib.nlzmx_decode_blocks(
        _u8p(src), stride, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        nblocks, hist_bits, block_size, threads, _u8p(dst), len(dst),
    )
    if rc != 0:
        raise RuntimeError("native block decode failed")
    return dst.tobytes()[:total_len]


def wide_encode_pipeline(data: bytes, block_size: int, hist_bits: int, depth_cap: int = 16,
                         dictionary: bytes | None = None, with_priors: bool = True,
                         priors_in: bytes | None = None):
    """Full native wide-profile encode: parse -> lift(-split) ->
    rep-classify -> plane encode, one library call. dictionary:
    shared-dictionary bytes preloaded before every block, or None.
    priors_in: encode against this serialized priors blob (the returned
    blob echoes it); else with_priors builds the container priors from
    these blocks, or encodes without priors (blob b"").
    Returns (payloads, priors_blob, depths, ncmds)."""
    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return [], b"", np.zeros(0, np.int32), []
    threads = min(16, os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    src = np.frombuffer(data, dtype=np.uint8)
    out_cap = n + nblocks * 70000 + (1 << 20)
    out = np.empty(out_cap, np.uint8)
    sizes = np.zeros(nblocks, np.int64)
    depths = np.zeros(nblocks, np.int32)
    ncmds = np.zeros(nblocks, np.int32)
    priors = np.zeros(priors_blob_size(), np.uint8)
    counter = np.zeros(1, np.int64)
    darr = np.frombuffer(dictionary, dtype=np.uint8) if dictionary else None
    parr = None
    if priors_in is not None:
        if len(priors_in) != priors_blob_size():
            raise ValueError("priors_in blob has the wrong size")
        parr = np.frombuffer(priors_in, dtype=np.uint8)
    while True:
        rc = lib.nlzmx_wide_encode_data(
            _u8p(src), n, block_size, hist_bits, depth_cap, 1 if with_priors else 0, threads,
            _u8p(out), out_cap, sizes.ctypes.data_as(i64p), _u8p(priors),
            depths.ctypes.data_as(i32p), ncmds.ctypes.data_as(i32p),
            counter.ctypes.data_as(i64p),
            _u8p(darr) if darr is not None else None,
            len(darr) if darr is not None else 0,
            _u8p(parr) if parr is not None else None,
            0,  # not strict
        )
        if rc != 1:
            break
        # rc == 1: out_cap overflow (pathological expansion) - regrow
        out_cap *= 2
        out = np.empty(out_cap, np.uint8)
    if rc != 0:
        raise RuntimeError(f"native wide encode failed (rc={rc})")
    payloads = []
    off = 0
    for b in range(nblocks):
        payloads.append(out[off : off + int(sizes[b])].tobytes())
        off += int(sizes[b])
    blob = priors_in if priors_in is not None else (priors.tobytes() if with_priors else b"")
    return payloads, blob, depths, [int(c) for c in ncmds]


def lift_deep(op_len: np.ndarray, op_val: np.ndarray, block_size: int) -> np.ndarray:
    """Bound literal-ancestor depth in [T, B] command arrays at cap 15 (in
    place: op_val is rewritten through ctypes, so it must own its memory).
    Returns the per-block max chain depth."""
    assert op_len.dtype == np.int32 and op_val.dtype == np.int32
    assert op_len.flags.c_contiguous and op_val.flags.c_contiguous
    T, B = op_len.shape
    depths = np.zeros(B, np.int32)
    load().nlzmx_lift_deep(_i32p(op_len), _i32p(op_val), T, B, block_size, 15,
                           min(16, os.cpu_count() or 1), _i32p(depths), 0)
    return depths


def wide_encode(op_len: np.ndarray, op_val: np.ndarray, op_rep: np.ndarray,
                with_priors: bool = True):
    """Threaded wide-profile plane encode of [T, B] command arrays.
    Returns (payloads list, priors_blob bytes)."""
    assert op_len.dtype == np.int32 and op_val.dtype == np.int32
    T, B = op_len.shape
    if B == 0:
        return [], b""
    threads = min(16, os.cpu_count() or 1)
    ol = np.ascontiguousarray(op_len.T)
    ov = np.ascontiguousarray(op_val.T)
    orp = np.ascontiguousarray(np.asarray(op_rep, np.int32).T)
    # worst-case payload: headers + chunk tables + incompressible planes
    out_cap = B * (17 * T + 65536)
    out = np.empty(out_cap, np.uint8)
    sizes = np.zeros(B, np.int64)
    priors = np.zeros(priors_blob_size(), np.uint8)
    rc = load().nlzmx_wide_encode(
        _i32p(ol), _i32p(ov), _i32p(orp), T, B, 1 if with_priors else 0, threads,
        _u8p(out), out_cap, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        _u8p(priors),
    )
    if rc != 0:
        raise RuntimeError("native wide encode overflow")
    payloads = []
    off = 0
    for b in range(B):
        payloads.append(out[off : off + int(sizes[b])].tobytes())
        off += int(sizes[b])
    return payloads, (priors.tobytes() if with_priors else b"")


def parse_blocks(data: bytes, block_size: int, hist_bits: int):
    """Native optimal parse -> ([T, B] op_len, op_val) command arrays."""
    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return np.zeros((0, 0), np.int32), np.zeros((0, 0), np.int32)
    threads = min(os.cpu_count() or 1, nblocks)
    t_cap = block_size + 8
    src = np.frombuffer(data, dtype=np.uint8)
    ol = np.empty((nblocks, t_cap), np.int32)
    ov = np.zeros((nblocks, t_cap), np.int32)
    rc = lib.nlzmx_parse_blocks(_u8p(src), n, block_size, hist_bits, threads,
                                _i32p(ol), _i32p(ov), t_cap)
    if rc != 0:
        raise RuntimeError("native parse failed")
    return np.ascontiguousarray(ol.T), np.ascontiguousarray(ov.T)


def classify_reps(op_len: np.ndarray, op_val: np.ndarray) -> np.ndarray:
    """Wide-profile rep classification of [T, B] command arrays."""
    assert op_len.dtype == np.int32 and op_len.flags.c_contiguous
    assert op_val.dtype == np.int32 and op_val.flags.c_contiguous
    T, B = op_len.shape
    out = np.full((T, B), -1, np.int32)  # rows past a block's end stay -1
    load().nlzmx_classify_reps(_i32p(op_len), _i32p(op_val), T, B, _i32p(out))
    return out
