"""nlzm_tpu_torch: the NLZM codec and the NLZP container codec in PyTorch,
with CUDA kernels.

A port of nlzm_tpu (JAX) to PyTorch on an NVIDIA Hopper GPU: the
wide-profile and the v1 block decode (parallel/blocks.py::
decode_container), the bounded-memory file decode and encode
(parallel/stream.py::decode_container_stream, encode_container_stream),
and the device encodes with the greedy or the calibrated optimal parse
(encode_container(parser="greedy" or "optimal", engine="device")): the
wide profile through the device parse of ops/encode_ops.py and the plane
encode of ops/wide_encode_dev.py, v1 wholly on the device
(ops/encode_ops.py: parse, model emission, rANS, bit packing), in memory
and from files; the unfused multi-row plane decode (ops/wide_decode.py
stage_plane, plane_scan); and the research codecs' device decodes,
research/ppm_tpu.py (NLZC, decompress) and research/huff0.py (decode).
Each jitted device function of nlzm_tpu on those paths is a CUDA kernel
written by hand (nlzm_tpu_torch/csrc) beside a plain PyTorch version.

Blocks shard over devices (parallel/mesh.py: make_mesh, an ordered
device list, and decode_container_sharded, decode_wide_sharded; the v1
device encode's and NLZC's mesh= argument) and over processes, one a
device, on torch.distributed (parallel/mp_dryrun.py): each shard runs
the same kernels on its device, then one ordered gather of the blocks'
sizes and the CRC check.

The host engines run on the native library (native/, built at first
use): the containers' native decode (decode_container and
decode_container_stream with engine="native": format/wide.py's host plane
decode and native.expand_ops, or native.decode_blocks), the native
encodes, and the single-stream NLZM
format (codec.py: decode_bytes, encode_bytes, encode_file, decode_file),
which has no device path. The command line, `python -m
nlzm_tpu_torch.cli c|d|t|h`, drives all of them (cli.py; its timing and
memory report in utils/metrics.py).

The port keeps its own copies of the host modules it needs (constants,
format/wide.py, container parsing, the native binding, codec.py,
utils/crc32.py, utils/metrics.py, the research codecs' host coders),
pinned to the originals by tests/test_torch_host.py and
tests/test_torch_host_engines.py; it imports nothing of nlzm_tpu.

Every kernel wrapper dispatches on the device of the tensors it is given:
CPU tensors run the plain version, CUDA tensors launch the kernel (built
with nvcc at first use into .build/torch_kernels/). Entry points run on
"cuda" unless the caller names another device. Importing this package
needs neither CUDA nor JAX.
"""

__version__ = "0.7.0"

from .codec import decode_bytes, decode_file, encode_bytes, encode_file
from .ops.encode_ops import encode_blocks_device, parse_blocks_device
from .ops.wide_encode_dev import encode_wide_blocks_device
from .parallel.blocks import decode_container, encode_container
from .parallel.stream import decode_container_stream, encode_container_stream

__all__ = [
    "decode_bytes", "decode_container", "decode_container_stream", "decode_file",
    "encode_blocks_device", "encode_bytes", "encode_container", "encode_container_stream",
    "encode_file", "encode_wide_blocks_device", "parse_blocks_device",
    "__version__",
]
