"""Block sharding over an ordered list of devices.

Counterpart of nlzm_tpu/parallel/mesh.py. The codec's scaling axis is the
block: blocks are independent streams, so the mesh is 1-D ("blocks") and
shard i of n holds the contiguous rows [i * Bp / n, (i + 1) * Bp / n) of
the Bp blocks padded to a multiple of n (JAX's P("blocks") layout;
utils/shards.py). Every shard runs the port's kernels on its own device,
with no traffic between devices; then one ordered gather of the bytes in
block order and of the per-block produced sizes, and the container's CRC
check (parallel/blocks.py::decode_sharded, whose one-device case is
decode_container).

A mesh is a tuple of torch.devices (make_mesh). A device may repeat, so
one card can hold several shards. One process stages every shard's
payloads on the host in turn and launches each shard's kernels before
the first copy back, so the devices' work overlaps but the host staging,
which sets a call's time at the shipping shapes, does not: the
single-process mesh is not expected to scale with the number of cards.
The multi-process mode, one process a device on torch.distributed, is
parallel/mp_dryrun.py.

Departures from JAX's functions: both decodes verify the container's CRC
and the blocks' sizes (IntegrityError on a mismatch, as decode_container
does; JAX returns the bytes unchecked), and decode_wide_sharded decodes
with the container's shared dictionary, which JAX's drops (it then
returns wrong bytes for a container with a dictionary, the shipping
config's).
"""

import torch

from .blocks import decode_sharded, parse_container

BLOCK_AXIS = "blocks"


def make_mesh(devices=None) -> tuple:
    """The 1-D block mesh: an ordered tuple of torch.devices; shard i runs
    on devices[i]. devices: any names torch.device takes ("cuda:0",
    "cpu", an index), repeats allowed; a bare "cuda" becomes the current
    CUDA device. The default is every visible CUDA device; with none it
    raises RuntimeError (no CPU fallback: name ["cpu"] * k for that)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; name the devices (e.g. ['cpu'] * k)")
        devices = range(n)
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return tuple(mesh)


def decode_container_sharded(data: bytes, mesh) -> bytes:
    """v1 block decode sharded over the mesh: each shard's payloads staged
    on its device (stage_v1_payloads), fsm_decode_v2 and
    lz_expand_parallel there; then the ordered gather and the CRC check
    (decode_sharded). Raises IntegrityError on a corrupt container,
    ValueError on a wide one (decode_wide_sharded)."""
    info = parse_container(data)
    if info.comp_sizes and info.wide:
        raise ValueError("decode_container_sharded: a wide container (use decode_wide_sharded)")
    return decode_sharded(data, info, mesh)


def decode_wide_sharded(data: bytes, mesh) -> bytes:
    """Wide-profile block decode sharded over the mesh: blocks padded with
    empty_payload(), each shard through ops/wide_decode.py's buckets on
    its device with the container's dictionary and each block's chain
    depth; then the ordered gather and the CRC check (decode_sharded).
    Raises IntegrityError on a corrupt container, ValueError on a v1
    one."""
    info = parse_container(data)
    if info.comp_sizes and not info.wide:
        raise ValueError("decode_wide_sharded: a v1 container (use decode_container_sharded)")
    return decode_sharded(data, info, mesh)
