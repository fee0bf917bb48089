"""Bounded-memory NLZP container decode: bucket-at-a-time file I/O.

Counterpart of the device branches of nlzm_tpu/parallel/stream.py. The
file is decoded in buckets of consecutive blocks (default 16 MiB of plain
data per bucket), so host memory stays O(dictionary + bucket) whatever
the file size; the CRC is accumulated bucket by bucket and checked
against the stored one at the end. Wire format: the container of
parallel/blocks.py. The host engines and the stream encoder are not
ported yet (ROADMAP.md queue A item 7).
"""

import os
import struct

import numpy as np

from ..format.wide import priors_blob_size
from ..ops.wide_decode import decode_wide_blocks, dict_tensor
from ..utils.crc32 import crc32
from .blocks import (
    _BLK, _HDR, FLAG_CRC32, FLAG_DICT, FLAG_PRIORS, FLAG_WIDE, MAGIC, VERSION,
    ContainerInfo, IntegrityError, _decompress_dict, decode_v1_blocks,
)

DEFAULT_BUCKET_BYTES = 16 << 20


def _bucket_blocks(block_size: int, bucket_bytes: int) -> int:
    return max(1, bucket_bytes // block_size)


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
    progress=None,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> dict:
    """Stream-decode an NLZP container file on `device`, bucket by bucket.

    dst_path None = test mode (decode + CRC only, like the reference's
    `t`). The CRC is accumulated incrementally and verified against the
    stored value (IntegrityError on a mismatch). Returns {"in", "out",
    "crc32"}.
    """
    flen = os.stat(src_path).st_size
    with open(src_path, "rb") as fin:
        info = read_container_head(fin)
        num_blocks = len(info.comp_sizes)
        N = info.block_size
        bucket_nb = _bucket_blocks(N, bucket_bytes)
        dict_arr = dict_tensor(info.dictionary, device) if info.wide else None

        out_f = open(dst_path, "wb") if dst_path else None
        crc = 0
        written = 0
        try:
            b0 = 0
            while b0 < num_blocks:
                nb = min(bucket_nb, num_blocks - b0)
                payloads = [fin.read(info.comp_sizes[b0 + k]) for k in range(nb)]
                keep = min(nb * N, info.total_len - b0 * N)
                if info.wide:
                    plain = decode_wide_blocks(
                        payloads, N, keep, info.wide_priors,
                        info.total_reads[b0 : b0 + nb], dict_arr, device=device)
                else:
                    plain = decode_v1_blocks(
                        payloads, info.num_cmds[b0 : b0 + nb], N, keep, device=device)
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
