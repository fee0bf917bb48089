"""Single-stream NLZM format on the native host engine.

A copy of the native paths of nlzm_tpu/codec.py: in memory (decode_bytes,
encode_bytes) and file to file through bounded buffers (encode_file,
decode_file). The file layout is

    u16be hist_bits | u16be frame_bits | frame* | 4-byte zero sentinel

decodable by the reference binary, and the reference's archives decode
here (NLZM.cpp:1711-2039). The format has no device path: it decodes
strictly serially. The pure-Python reference codec (nlzm_tpu's engine
"python", its CLI's "serial") is not ported: those engine names raise
ValueError, and a missing native library raises native.NativeUnavailable.
tests/test_torch_host_engines.py pins every function here to the
original.
"""

import os

from . import native
from .constants import (
    DEFAULT_HIST_BITS,
    FILE_HEADER_BYTES,
    MAX_FRAME_BITS,
    MAX_HIST_BITS,
    MIN_FRAME_BITS,
    MIN_HIST_BITS_DECODE,
    SENTINEL_FRAME,
    frame_bits_for,
    shrink_hist_bits,
)

_ENGINES = ("auto", "native")


class FormatError(ValueError):
    pass


def _check_engine(engine: str) -> None:
    if engine not in _ENGINES:
        raise ValueError(f"engine={engine!r}: the single-stream format runs on the native "
                         f"host engine only ('auto' or 'native')")


def _check_parser(parser: str) -> None:
    if parser not in ("greedy", "optimal"):
        raise ValueError(f"unknown parser {parser!r}; expected 'greedy' or 'optimal'")


def _header(hist_bits: int) -> bytes:
    return hist_bits.to_bytes(2, "big") + frame_bits_for(hist_bits).to_bytes(2, "big")


def _check_header(header: bytes) -> int:
    """hist_bits of a file header; FormatError when it is out of range."""
    if len(header) < FILE_HEADER_BYTES:
        raise FormatError("truncated header")
    hist_bits = int.from_bytes(header[0:2], "big")
    frame_bits = int.from_bytes(header[2:4], "big")
    if not (MIN_HIST_BITS_DECODE <= hist_bits <= MAX_HIST_BITS):
        raise FormatError(f"hist_bits {hist_bits} out of range")
    if not (MIN_FRAME_BITS <= frame_bits <= MAX_FRAME_BITS):
        raise FormatError(f"frame_bits {frame_bits} out of range")
    return hist_bits


def decode_bytes(data: bytes, engine: str = "native") -> bytes:
    """Decode a complete NLZM stream held in memory on the native engine."""
    _check_engine(engine)
    if len(data) < FILE_HEADER_BYTES:
        raise FormatError("truncated header")
    hist_bits = int.from_bytes(data[0:2], "big")
    if not (MIN_HIST_BITS_DECODE <= hist_bits <= MAX_HIST_BITS):
        raise FormatError(f"hist_bits {hist_bits} out of range")
    payload = data[FILE_HEADER_BYTES:]
    cap = max(1 << 16, len(data) * 4)
    while True:
        try:
            return native.decode_block(payload, hist_bits, cap)
        except RuntimeError:
            if cap > len(data) * 4096:
                raise
            cap *= 8


def encode_bytes(data: bytes, hist_bits: int = DEFAULT_HIST_BITS, parser: str = "optimal",
                 engine: str = "auto") -> bytes:
    """Encode `data` into an NLZM stream (reference-decodable) on the
    native engine. parser: "greedy" (hash-chain matcher) or "optimal"
    (forward-graph parse with the full matcher suite)."""
    _check_engine(engine)
    _check_parser(parser)
    hist_bits = max(MIN_HIST_BITS_DECODE, min(MAX_HIST_BITS, hist_bits))
    hist_bits = shrink_hist_bits(hist_bits, len(data))
    payload, _, _ = native.encode_block(data, hist_bits, parser)
    return _header(hist_bits) + payload + SENTINEL_FRAME


# ---------------------------------------------------------------- files
# Bounded-memory file paths: the reference encodes and decodes files of
# any size through fixed buffers (NLZM.cpp:1870-1885, 2014-2018); these
# mirror that with the native streaming codec, so RSS stays O(window).

_IO_CHUNK = 4 << 20


def encode_file(src_path, dst_path, hist_bits: int = DEFAULT_HIST_BITS,
                parser: str = "optimal", progress=None) -> dict:
    """Stream-encode a file into an NLZM stream, byte-identical to
    encode_bytes on the same input. Returns {"in", "out", "crc32"}."""
    _check_parser(parser)
    flen = os.stat(src_path).st_size
    hist_bits = max(MIN_HIST_BITS_DECODE, min(MAX_HIST_BITS, hist_bits))
    hist_bits = shrink_hist_bits(hist_bits, flen)

    enc = native.StreamEncoder(hist_bits, parser)
    crc = 0
    done = 0
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        header = _header(hist_bits)
        fout.write(header)
        out_total = len(header)
        while True:
            chunk = fin.read(_IO_CHUNK)
            final = len(chunk) < _IO_CHUNK
            crc = native.crc32(chunk, crc)
            out = enc.feed(chunk, final=final)
            fout.write(out)
            out_total += len(out)
            done += len(chunk)
            if progress is not None:
                progress.update(done, out_total)
            if final:
                break
        fout.write(SENTINEL_FRAME)
        out_total += len(SENTINEL_FRAME)
    enc.close()
    return {"in": done, "out": out_total, "crc32": crc}


def decode_file(src_path, dst_path, progress=None) -> dict:
    """Stream-decode an NLZM stream file; dst_path None is test mode
    (decode and CRC only, like the reference's `t`). Returns {"in",
    "out", "crc32"}."""
    flen = os.stat(src_path).st_size
    with open(src_path, "rb") as fin:
        header = fin.read(FILE_HEADER_BYTES)
        dec = native.StreamDecoder(_check_header(header))
        crc = 0
        done = len(header)
        out_total = 0
        fout = open(dst_path, "wb") if dst_path else None
        try:
            while not dec.done:
                chunk = fin.read(_IO_CHUNK)
                if not chunk:
                    raise FormatError("truncated stream (no sentinel)")
                done += len(chunk)
                # the native decoder pauses with ~8 MB pending, so its
                # memory stays O(window): pump with empty feeds until dry
                while True:
                    out = dec.feed(chunk)
                    chunk = b""
                    crc = native.crc32(out, crc)
                    if fout:
                        fout.write(out)
                    out_total += len(out)
                    if progress is not None:
                        progress.update(min(done, flen), out_total)
                    if dec.done or not out:
                        break
        finally:
            if fout:
                fout.close()
        dec.close()
    return {"in": done, "out": out_total, "crc32": crc}
