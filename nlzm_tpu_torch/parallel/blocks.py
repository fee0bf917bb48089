"""NLZP block container: encode, parsing, and decode on a PyTorch device
or the native host engine.

Counterpart of nlzm_tpu/parallel/blocks.py. The container code (header
constants, ContainerInfo, parse_container, CRC verification, payload
slicing, dictionary sampling and (de)compression) is a copy of the
original; tests/test_torch_host.py pins its output to it. Encode runs on
the native host engine (the wide profile through
native.wide_encode_pipeline with the optimal parse, or with the greedy
parse through the device encode below; v1 through native.encode_blocks)
or, with the greedy or the optimal parse, on the device
(engine="device"): the wide profile through ops/encode_ops.py's parse and ops/wide_encode_dev.py, v1
through ops/encode_ops.py::encode_blocks_device (one frame per block, all
on the device). Decode runs both profiles on the device (engine="device":
wide through ops/wide_decode.py, v1 through ops/decode_v2.py
(fsm_decode_v2) and ops/expand_ops.py) or on the native host engine
(engine="native": format/wide.py::decode_wide_block and
native.expand_ops, or native.decode_blocks).

Container layout (all integers big-endian):

    0   magic  b"NLZP"
    4   u8     version
    5   u8     hist_bits     (per-block window)
    6   u8     frame_bits
    7   u8     flags         (bit 0: u32 CRC32 of the plain data follows)
    8   u32    block_size    (uncompressed bytes per block; last may be short)
    12  u64    total uncompressed length
    20  u32    num_blocks
    [u32 crc32 when flagged] [priors blob] [u32 raw, u32 comp, dictionary]
    per block: u32 comp_size | u32 total_reads | u32 num_cmds
               (wide profile: the reads slot carries the block's max
                literal-ancestor chain depth)
    ... concatenated block payloads
"""

import io
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..constants import frame_bits_for
from ..format.wide import decode_wide_block, empty_payload, priors_blob_size
from ..ops.decode_v2 import fsm_decode_v2
from ..ops.encode_ops import encode_blocks_device, parse_blocks_device
from ..ops.expand_ops import lz_expand_parallel, scatter_blocks
from ..ops.wide_decode import decode_wide_blocks, dict_tensor
from ..ops.wide_encode_dev import encode_wide_blocks_device
from ..utils.crc32 import crc32
from ..utils.shards import shard_rows

MAGIC = b"NLZP"
VERSION = 4
_HDR = struct.Struct(">4sBBBBIQI")
_BLK = struct.Struct(">III")
FLAG_CRC32 = 0x01  # u32be CRC of the uncompressed data follows the header
FLAG_WIDE = 0x02  # blocks use the wide profile
FLAG_PRIORS = 0x04  # container-level wide warm-start priors blob follows
FLAG_DICT = 0x08  # shared dictionary follows (u32 raw len, u32 comp len, v1 frames)

DEFAULT_BLOCK_SIZE = 1 << 17  # 128 KB: 5 frames/block at hist_bits 17
WIDE_MAX_BLOCK = 131072


class IntegrityError(ValueError):
    pass


def sample_dict(data: bytes, dict_size: int, segment: int = 2048) -> bytes:
    """Deterministic shared-dictionary sampling: evenly spaced segments,
    in their original order."""
    if dict_size <= 0 or len(data) <= dict_size:
        return b""
    nseg = max(1, dict_size // segment)
    stride = len(data) / nseg
    parts = []
    for i in range(nseg):
        off = int(i * stride)
        parts.append(data[off : off + segment])
    return b"".join(parts)[:dict_size]


def _compress_dict(dictionary: bytes) -> bytes:
    payload, _, _ = native.encode_block(dictionary, hist_bits_for_block(len(dictionary)), "optimal")
    return payload


def _decompress_dict(payload: bytes, raw_len: int) -> bytes:
    return native.decode_block(payload, hist_bits_for_block(raw_len), raw_len)


@dataclass
class ContainerInfo:
    hist_bits: int
    frame_bits: int
    block_size: int
    total_len: int
    comp_sizes: list
    total_reads: list
    num_cmds: list
    payload_off: int
    crc32: int | None = None
    wide: bool = False
    wide_priors: bytes | None = None
    dictionary: bytes | None = None


def hist_bits_for_block(block_size: int) -> int:
    """Window covering the whole block (blocks never slide)."""
    return max(12, (max(block_size, 2) - 1).bit_length())


def encode_container(
    data: bytes,
    block_size: int = DEFAULT_BLOCK_SIZE,
    parser: str = "greedy",
    engine: str = "auto",
    profile: str = "v1",
    depth_cap: int = 8,
    dict_size: int = 0,
    device="cuda",
) -> bytes:
    """Block encode; the container bytes are those nlzm_tpu's
    encode_container writes with the same engine (its "tpu" engine is
    this one's "device").

    engine "auto" or "native": the native host engine; profile="wide"
    with parser="optimal" runs the native wide pipeline, where depth_cap
    bounds every byte's literal-ancestor chain depth and dict_size > 0
    samples a shared dictionary; with parser="greedy" the wide encode of
    engine="device" (nlzm_tpu's engine "auto" runs a numpy plane encode
    there; the bytes are the same). engine="device": the device parse
    (ops/encode_ops.py; parser "greedy", or "optimal", the calibrated DP
    parse) on `device`, then for the wide profile the device plane encode
    (ops/wide_encode_dev.py; no dictionary), for v1 the device model
    emission, rANS and bit packing (encode_blocks_device: one frame per
    block, so block_size <= 14848 at hist_bits <= 16, else ValueError).
    Raises NativeUnavailable when the native library cannot be built.
    """
    if engine not in ("auto", "native", "device"):
        raise ValueError(f"engine={engine!r}: 'auto', 'native' or 'device'")
    dictionary = b""
    if dict_size and profile == "wide":
        dictionary = sample_dict(data, dict_size)
    hist_bits = hist_bits_for_block(len(dictionary) + block_size)
    num_blocks = (len(data) + block_size - 1) // block_size if data else 0

    flags = FLAG_CRC32
    priors_blob = b""
    meta, payloads = [], []
    if profile == "wide":
        if block_size > WIDE_MAX_BLOCK:
            raise ValueError("wide profile caps blocks at 128 KiB")
        flags |= FLAG_WIDE
        native_pipeline = engine != "device" and parser == "optimal"
        if dictionary and not native_pipeline:
            raise ValueError(
                "shared dictionaries need the native optimal-parse pipeline "
                "(engine != 'device', parser='optimal')")
        if num_blocks and native_pipeline:
            payloads, priors_blob, depths, ncmds = native.wide_encode_pipeline(
                data, block_size, hist_bits, depth_cap=depth_cap,
                dictionary=dictionary or None,
            )
        elif num_blocks:
            op_len, op_val, op_rep, depths = parse_blocks_device(
                data, block_size, hist_bits, parser, device=device)
            payloads, priors_blob = encode_wide_blocks_device(op_len, op_val, op_rep,
                                                              device=device)
            neg = op_len < 0
            ncmds = np.where(neg.any(axis=0), neg.argmax(axis=0), op_len.shape[0]).tolist()
        if num_blocks:
            if priors_blob:
                flags |= FLAG_PRIORS
            if dictionary:
                flags |= FLAG_DICT
            # the per-block "reads" slot carries the chain depth
            meta = [(len(p), int(d), c) for p, d, c in zip(payloads, depths, ncmds)]
        else:
            dictionary = b""
    elif num_blocks:
        if engine == "device":
            payloads, reads, cmds = encode_blocks_device(data, block_size, hist_bits, parser,
                                                         device=device)
        else:
            payloads, reads, cmds = native.encode_blocks(data, block_size, hist_bits, parser)
        meta = list(zip(map(len, payloads), reads, cmds))

    out = io.BytesIO()
    out.write(_HDR.pack(MAGIC, VERSION, hist_bits, frame_bits_for(hist_bits), flags,
                        block_size, len(data), num_blocks))
    out.write(struct.pack(">I", crc32(data)))
    if flags & FLAG_PRIORS:
        out.write(priors_blob)
    if flags & FLAG_DICT:
        dcomp = _compress_dict(dictionary)
        out.write(struct.pack(">II", len(dictionary), len(dcomp)))
        out.write(dcomp)
    for m in meta:
        out.write(_BLK.pack(*m))
    for p in payloads:
        out.write(p)
    return out.getvalue()


def parse_container(data: bytes) -> ContainerInfo:
    magic, version, hist_bits, frame_bits, flags, block_size, total_len, num_blocks = (
        _HDR.unpack_from(data, 0))
    if magic != MAGIC:
        raise ValueError("not an NLZP container")
    if version != VERSION:
        raise ValueError(f"unsupported NLZP version {version}")
    off = _HDR.size
    crc = None
    if flags & FLAG_CRC32:
        (crc,) = struct.unpack_from(">I", data, off)
        off += 4
    priors = None
    if flags & FLAG_PRIORS:
        n = priors_blob_size()
        priors = data[off : off + n]
        off += n
    dictionary = None
    if flags & FLAG_DICT:
        raw_len, comp_len = struct.unpack_from(">II", data, off)
        off += 8
        dictionary = _decompress_dict(data[off : off + comp_len], raw_len)
        if len(dictionary) != raw_len:
            raise IntegrityError("corrupt container dictionary")
        off += comp_len
    comp_sizes, reads, cmds = [], [], []
    for _ in range(num_blocks):
        cs, rd, nc = _BLK.unpack_from(data, off)
        comp_sizes.append(cs)
        reads.append(rd)
        cmds.append(nc)
        off += _BLK.size
    return ContainerInfo(
        hist_bits=hist_bits,
        frame_bits=frame_bits,
        block_size=block_size,
        total_len=total_len,
        comp_sizes=comp_sizes,
        total_reads=reads,
        num_cmds=cmds,
        payload_off=off,
        crc32=crc,
        wide=bool(flags & FLAG_WIDE),
        wide_priors=priors,
        dictionary=dictionary,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stage_v1_payloads(payloads, num_cmds, *, device):
    """Bucket v1 block payloads by command count before the FSM scan.

    The scan's step count is static per batch, sized by the worst block:
    1 bucket below 1024 blocks and 2 from there on (the JAX package's
    measured break-even). Returns [(streams [Bk, Sk] uint8 on `device`,
    num_steps, block_idx_list), ...]; the streams are zero padded
    (terminator and window slack).
    """
    B = len(payloads)
    n_buckets = 2 if B >= 1024 else 1
    order = sorted(range(B), key=lambda b: num_cmds[b])
    out = []
    for k in range(n_buckets):
        idx = order[k * B // n_buckets : (k + 1) * B // n_buckets]
        if not idx:
            continue
        s = _round_up(max(len(payloads[b]) for b in idx) + 24, 256)
        arr = np.zeros((len(idx), s), np.uint8)
        for row, b in enumerate(idx):
            arr[row, : len(payloads[b])] = np.frombuffer(payloads[b], np.uint8)
        # +1 step: every block spends one scan step on its terminator header
        num_steps = _round_up(max(num_cmds[b] for b in idx) + 1, 256)
        out.append((torch.as_tensor(arr, device=torch.device(device)), num_steps, idx))
    return out


def stage_v1_buckets(data: bytes, info: ContainerInfo, *, device):
    """stage_v1_payloads over a parsed container's blocks."""
    return stage_v1_payloads(block_payloads(data, info), info.num_cmds, device=device)


def decode_v1_staged(streams, num_steps: int, block_size: int):
    """FSM decode + LZ expansion of one staged v1 bucket -> ([Bk, N] u8,
    produced [Bk])."""
    op_len, op_val = fsm_decode_v2(streams, num_steps)
    return lz_expand_parallel(op_len, op_val, block_size)


def decode_v1_blocks(payloads, num_cmds, block_size: int, *, device):
    """Decode v1 block payloads on `device` -> (out [B, block_size] uint8,
    produced [B] int32) there, rows in block order
    (ops/expand_ops.py::scatter_blocks)."""
    parts = [(decode_v1_staged(streams, num_steps, block_size), idx)
             for streams, num_steps, idx in stage_v1_payloads(payloads, num_cmds, device=device)]
    return scatter_blocks(parts, len(payloads), block_size, device)


def block_bytes(shards, keep: int) -> bytes:
    """Decoded rows in block order, as shards [(out [R, N] uint8,
    produced [R]), ...] (each shard's rows consecutive, pad rows last) ->
    their first `keep` bytes, block b at b * N, as nlzm_tpu lays them out;
    only those bytes leave the devices."""
    parts = []
    for out, _ in shards:
        take = min(keep, out.numel())
        if take <= 0:
            break
        parts.append(out.reshape(-1)[:take].cpu().numpy().tobytes())
        keep -= take
    return b"".join(parts)


def gathered(shards, info: ContainerInfo) -> bytes:
    """A non-empty container's decoded shards (as in block_bytes) -> its
    bytes, CRC-verified, after the ordered gather of the blocks' produced
    sizes, each of which must be its block's length; IntegrityError on
    either fault."""
    out = _verified(block_bytes(shards, info.total_len), info)
    n = len(info.comp_sizes)
    sizes = torch.cat([p.cpu() for _, p in shards])[:n].numpy()
    want = np.minimum(info.block_size, info.total_len - np.arange(n) * info.block_size)
    if len(out) != info.total_len or (sizes != want).any():
        raise IntegrityError("decoded block sizes do not match the container's length")
    return out


def decode_sharded(data: bytes, info: ContainerInfo, mesh) -> bytes:
    """A parsed container's device decode over an ordered list of devices
    (parallel/mesh.py::make_mesh; decode_container's is [device]): the
    blocks padded to a multiple of its length (v1: b"" with 0 commands,
    whose zero stream's first header ends the block; wide:
    format/wide.py::empty_payload), shard i's contiguous rows
    (utils/shards.py::shard_rows) staged and decoded on mesh[i], wide with
    the container's dictionary (uploaded once a distinct device) and each
    block's depth; every shard launches before the first copy back; then
    gathered. Raises IntegrityError on a corrupt container."""
    if not info.comp_sizes:
        return _verified(b"", info)
    n = len(mesh)
    payloads = block_payloads(data, info)
    pad = (-len(payloads)) % n
    payloads += [empty_payload() if info.wide else b""] * pad
    per_block = list(info.total_reads if info.wide else info.num_cmds) + [0] * pad
    dicts, shards = {}, []
    for i, d in enumerate(mesh):
        dev = torch.device(d)
        lo, hi = shard_rows(len(payloads), n, i)
        if not info.wide:
            shards.append(decode_v1_blocks(payloads[lo:hi], per_block[lo:hi], info.block_size,
                                           device=dev))
            continue
        if dev not in dicts:
            dicts[dev] = dict_tensor(info.dictionary, dev)
        shards.append(decode_wide_blocks(payloads[lo:hi], info.block_size, info.wide_priors,
                                         per_block[lo:hi], dicts[dev], device=dev))
    return gathered(shards, info)


def pack_streams(data: bytes, info: ContainerInfo) -> np.ndarray:
    """[B, S] uint8: per-block payloads, zero padded (terminator + window slack)."""
    n = len(info.comp_sizes)
    s = _round_up(max(info.comp_sizes, default=1) + 24, 256)
    arr = np.zeros((n, s), dtype=np.uint8)
    off = info.payload_off
    for b, cs in enumerate(info.comp_sizes):
        arr[b, :cs] = np.frombuffer(data, dtype=np.uint8, count=cs, offset=off)
        off += cs
    return arr


def block_payloads(data: bytes, info: ContainerInfo) -> list:
    """Per-block payload byte strings of a parsed container."""
    out = []
    off = info.payload_off
    for cs in info.comp_sizes:
        out.append(data[off : off + cs])
        off += cs
    return out


def _verified(out: bytes, info: ContainerInfo) -> bytes:
    if info.crc32 is not None:
        got = crc32(out)
        if got != info.crc32:
            raise IntegrityError(f"CRC mismatch: stored {info.crc32:08X}, decoded {got:08X}")
    return out


def decode_blocks_native(payloads, info: ContainerInfo, keep: int) -> bytes:
    """The native engine's decode of block payloads (consecutive blocks of
    the container `info` describes), cut to `keep` bytes. Wide blocks go
    through the host plane decode (format/wide.py::decode_wide_block) and
    native.expand_ops with the container's dictionary, v1 blocks through
    native.decode_blocks. A payload the decoders reject (the plane
    decode's ValueError, the library's RuntimeError) raises
    IntegrityError; any other error passes through, as in nlzm_tpu, and
    so does NativeUnavailable for a missing library."""
    try:
        if not info.wide:
            return native.decode_blocks(payloads, info.hist_bits, info.block_size, keep)
        parts = []
        for payload in payloads:
            op_len, op_val = decode_wide_block(payload, info.wide_priors)
            parts.append(native.expand_ops(np.asarray(op_len, np.int32),
                                           np.asarray(op_val, np.int32), info.block_size,
                                           info.dictionary or None))
        return b"".join(parts)[:keep]
    except native.NativeUnavailable:
        raise
    except (ValueError, RuntimeError) as e:
        raise IntegrityError(f"corrupt block payload: {e}") from e


def decode_container(data: bytes, device="cuda", engine: str = "device") -> bytes:
    """Decode an NLZP container (wide or v1 profile), CRC-verified when the
    container carries a CRC.

    engine="device": on `device` ("cuda", "cpu", a torch.device;
    decode_sharded over [device]).
    engine="native": on the native host engine (`device` unused;
    decode_blocks_native); raises NativeUnavailable when the library
    cannot be built. Raises IntegrityError on a CRC mismatch or a
    payload the decoders reject.
    """
    if engine not in ("device", "native"):
        raise ValueError(f"engine={engine!r}: 'device' or 'native'")
    info = parse_container(data)
    if engine == "device":
        return decode_sharded(data, info, [device])
    if not info.comp_sizes:
        return _verified(b"", info)
    return _verified(decode_blocks_native(block_payloads(data, info), info, info.total_len),
                     info)
