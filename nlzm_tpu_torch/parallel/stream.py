"""Bounded-memory NLZP container files: bucket-at-a-time file I/O.

Counterpart of nlzm_tpu/parallel/stream.py: the file encode (host
engines, and the v1 device encode) and the file decode (on the device, or
on the native host engine, both profiles). The file
goes through in buckets of consecutive blocks (default 16 MiB of plain
data per bucket), so host memory stays O(dictionary + bucket) whatever
the file size; the CRC is accumulated bucket by bucket. Wire format: the
container of parallel/blocks.py. The encoder writes placeholders for the
CRC, the priors and the block table, streams the payloads, and patches
them in at the end; the wide profile's priors come from the first bucket
and every later bucket encodes against them (any blob is wire-valid: the
decoder applies the stored one). The native engine of the file decode
needs the native library and raises NativeUnavailable without it (the
JAX function has no such guard and fails on a missing symbol).
"""

import os
import secrets
import struct

import numpy as np

from .. import native
from ..constants import frame_bits_for
from ..format.wide import priors_blob_size
from ..ops.encode_ops import check_one_frame, encode_blocks_device
from ..ops.wide_decode import decode_wide_blocks, dict_tensor
from ..utils.crc32 import crc32
from .blocks import (
    _BLK, _HDR, FLAG_CRC32, FLAG_DICT, FLAG_PRIORS, FLAG_WIDE, MAGIC, VERSION, WIDE_MAX_BLOCK,
    ContainerInfo, IntegrityError, _compress_dict, _decompress_dict, block_bytes,
    decode_blocks_native, decode_v1_blocks, hist_bits_for_block,
)

DEFAULT_BUCKET_BYTES = 16 << 20


def sample_dict_file(f, flen: int, dict_size: int, segment: int = 2048) -> bytes:
    """blocks.sample_dict over a seekable file (no whole-file read)."""
    if dict_size <= 0 or flen <= dict_size:
        return b""
    nseg = max(1, dict_size // segment)
    stride = flen / nseg
    parts = []
    for i in range(nseg):
        f.seek(int(i * stride))
        parts.append(f.read(segment))
    return b"".join(parts)[:dict_size]


def _bucket_blocks(block_size: int, bucket_bytes: int) -> int:
    return max(1, bucket_bytes // block_size)


def encode_container_stream(
    src_path: str,
    dst_path: str,
    block_size: int,
    parser: str = "optimal",
    engine: str = "auto",
    profile: str = "v1",
    depth_cap: int = 8,
    dict_size: int = 0,
    progress=None,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    device="cuda",
) -> dict:
    """Stream-encode a file into an NLZP container, bucket by bucket.

    The parameters and the wire output of blocks.encode_container, as
    nlzm_tpu's encode_container_stream writes them (its engine "tpu" is
    "device" here): engine "auto" or "native" encodes on the native host
    engine, engine="device" the v1 profile on `device` (the greedy or the
    calibrated optimal parse, one frame per block). The wide profile needs
    the native optimal-parse pipeline. Returns {"in", "out", "crc32"}.

    The archive is written to a temporary file beside dst_path and moved
    onto it only when the encode succeeds, and the device encode's
    one-frame limit is checked before anything is written: a failed
    encode leaves dst_path as it was (absent, or its old bytes). This
    departs on purpose from nlzm_tpu's function, which writes dst_path in
    place and leaves a partial archive behind when an encode raises.
    """
    if engine not in ("auto", "native", "device"):
        raise ValueError(f"engine={engine!r}: 'auto', 'native' or 'device'")
    flen = os.stat(src_path).st_size
    num_blocks = (flen + block_size - 1) // block_size if flen else 0
    if profile == "wide":
        if block_size > WIDE_MAX_BLOCK:
            raise ValueError("wide profile caps blocks at 128 KiB")
        if engine == "device" or parser != "optimal":
            raise ValueError(
                "streaming wide encode needs the native optimal-parse "
                "pipeline (engine != 'device', parser='optimal')")

    dictionary = b""
    with open(src_path, "rb") as f:
        if dict_size and profile == "wide" and num_blocks:
            dictionary = sample_dict_file(f, flen, dict_size)
    hist_bits = hist_bits_for_block(len(dictionary) + block_size)
    if engine == "device":
        check_one_frame(block_size, hist_bits)

    flags = FLAG_CRC32
    if profile == "wide" and num_blocks:
        flags |= FLAG_WIDE | FLAG_PRIORS
        if dictionary:
            flags |= FLAG_DICT

    meta = np.zeros((num_blocks, 3), dtype=">u4")
    crc = 0
    bucket_nb = _bucket_blocks(block_size, bucket_bytes)
    priors_blob = None

    # a temporary file beside dst_path, moved onto it only on success
    dst_dir, dst_name = os.path.split(os.path.abspath(dst_path))
    tmp_path = os.path.join(dst_dir, f".{dst_name}.{os.getpid()}.{secrets.token_hex(4)}.tmp")
    try:
        with open(src_path, "rb") as fin, open(tmp_path, "xb+") as out:
            out.write(_HDR.pack(MAGIC, VERSION, hist_bits, frame_bits_for(hist_bits), flags,
                                block_size, flen, num_blocks))
            crc_off = out.tell()
            out.write(bytes(4))  # the CRC, patched in at the end
            priors_off = out.tell()
            if flags & FLAG_PRIORS:
                out.write(bytes(priors_blob_size()))  # patched in at the end
            if flags & FLAG_DICT:
                dcomp = _compress_dict(dictionary)
                out.write(struct.pack(">II", len(dictionary), len(dcomp)))
                out.write(dcomp)
            meta_off = out.tell()
            out.write(bytes(_BLK.size * num_blocks))  # patched in at the end

            done = 0
            b0 = 0
            while b0 < num_blocks:
                nb = min(bucket_nb, num_blocks - b0)
                chunk = fin.read(nb * block_size)
                crc = crc32(chunk, crc)
                if profile == "wide":
                    payloads, blob, reads, cmds = native.wide_encode_pipeline(
                        chunk, block_size, hist_bits, depth_cap=depth_cap,
                        dictionary=dictionary or None, with_priors=priors_blob is None,
                        priors_in=priors_blob)
                    if priors_blob is None:
                        priors_blob = blob
                elif engine == "device":
                    payloads, reads, cmds = encode_blocks_device(chunk, block_size, hist_bits,
                                                                 parser, device=device)
                else:
                    payloads, reads, cmds = native.encode_blocks(chunk, block_size, hist_bits,
                                                                 parser)
                for k, p in enumerate(payloads):
                    meta[b0 + k] = (len(p), int(reads[k]), cmds[k])  # wide: reads = chain depth
                    out.write(p)
                done += len(chunk)
                b0 += nb
                if progress is not None:
                    progress.update(done, out.tell())

            total_out = out.tell()
            out.seek(crc_off)
            out.write(struct.pack(">I", crc))
            if flags & FLAG_PRIORS:
                out.seek(priors_off)
                out.write(priors_blob)
            out.seek(meta_off)
            out.write(meta.tobytes())
        os.replace(tmp_path, dst_path)
    except BaseException:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise
    return {"in": flen, "out": total_out, "crc32": crc}


def read_container_head(f) -> ContainerInfo:
    """Parse header + priors + dict + meta from a container file; leaves
    the cursor at the first payload byte (== info.payload_off)."""
    hdr = f.read(_HDR.size)
    magic, version, hist_bits, frame_bits, flags, block_size, total_len, num_blocks = (
        _HDR.unpack(hdr)
    )
    if magic != MAGIC:
        raise ValueError("not an NLZP container")
    if version != VERSION:
        raise ValueError(f"unsupported NLZP version {version}")
    crc = None
    if flags & FLAG_CRC32:
        (crc,) = struct.unpack(">I", f.read(4))
    priors = None
    if flags & FLAG_PRIORS:
        priors = f.read(priors_blob_size())
    dictionary = None
    if flags & FLAG_DICT:
        raw_len, comp_len = struct.unpack(">II", f.read(8))
        dictionary = _decompress_dict(f.read(comp_len), raw_len)
        if len(dictionary) != raw_len:
            raise IntegrityError("corrupt container dictionary")
    meta = np.frombuffer(f.read(_BLK.size * num_blocks), dtype=">u4")
    meta = meta.reshape(num_blocks, 3).astype(np.int64)
    return ContainerInfo(
        hist_bits=hist_bits,
        frame_bits=frame_bits,
        block_size=block_size,
        total_len=total_len,
        comp_sizes=[int(x) for x in meta[:, 0]],
        total_reads=[int(x) for x in meta[:, 1]],
        num_cmds=[int(x) for x in meta[:, 2]],
        payload_off=f.tell(),
        crc32=crc,
        wide=bool(flags & FLAG_WIDE),
        wide_priors=priors,
        dictionary=dictionary,
    )


def decode_container_stream(
    src_path: str,
    dst_path: str | None,
    device="cuda",
    engine: str = "device",
    progress=None,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> dict:
    """Stream-decode an NLZP container file, bucket by bucket.

    engine="device": on `device`; engine="native": on the native host
    engine (blocks.decode_blocks_native; NativeUnavailable without the
    library). dst_path None = test mode (decode + CRC only, like the
    reference's `t`). The CRC is accumulated incrementally and verified
    against the stored value (IntegrityError on a mismatch). Returns
    {"in", "out", "crc32"}.
    """
    if engine not in ("device", "native"):
        raise ValueError(f"engine={engine!r}: 'device' or 'native'")
    if engine == "native":
        native.load()
    flen = os.stat(src_path).st_size
    with open(src_path, "rb") as fin:
        info = read_container_head(fin)
        num_blocks = len(info.comp_sizes)
        N = info.block_size
        bucket_nb = _bucket_blocks(N, bucket_bytes)
        on_device = info.wide and engine == "device"
        dict_arr = dict_tensor(info.dictionary, device) if on_device else None

        out_f = open(dst_path, "wb") if dst_path else None
        crc = 0
        written = 0
        try:
            b0 = 0
            while b0 < num_blocks:
                nb = min(bucket_nb, num_blocks - b0)
                payloads = [fin.read(info.comp_sizes[b0 + k]) for k in range(nb)]
                keep = min(nb * N, info.total_len - b0 * N)
                if engine == "native":
                    plain = decode_blocks_native(payloads, info, keep)
                elif info.wide:
                    plain = block_bytes([decode_wide_blocks(
                        payloads, N, info.wide_priors, info.total_reads[b0 : b0 + nb],
                        dict_arr, device=device)], keep)
                else:
                    plain = block_bytes([decode_v1_blocks(
                        payloads, info.num_cmds[b0 : b0 + nb], N, device=device)], keep)
                crc = crc32(plain, crc)
                if out_f is not None:
                    out_f.write(plain)
                written += len(plain)
                b0 += nb
                if progress is not None:
                    progress.update(written, flen)
        finally:
            if out_f is not None:
                out_f.close()
    if info.crc32 is not None and crc != info.crc32:
        raise IntegrityError(f"CRC mismatch: stored {info.crc32:08X}, decoded {crc:08X}")
    return {"in": flen, "out": written, "crc32": crc}
