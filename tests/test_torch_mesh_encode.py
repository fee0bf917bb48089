"""The port's sharded v1 device encode (ops/encode_ops.py::
encode_blocks_device(mesh=)) and sharded NLZC decode
(research/ppm_tpu.py::decompress(mesh=)) on the CPU, against the JAX
package's encode_blocks_tpu(mesh=) and decompress(mesh=) on the virtual
8-device CPU mesh, exact."""

import jax
import pytest
import torch

from nlzm_tpu.ops.encode_ops import encode_blocks_tpu
from nlzm_tpu.parallel import mesh as jmesh
from nlzm_tpu.research import ppm_tpu as jppm
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.ops.encode_ops import encode_blocks_device
from nlzm_tpu_torch.parallel import mesh as tmesh
from nlzm_tpu_torch.research import ppm_tpu as tppm

torch.set_num_threads(1)

BS = 1024
HIST_BITS = 12


@pytest.fixture(scope="module")
def text():
    return build_nonperiodic(64 * 1024, seed=5)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("parser", ["greedy", "optimal"])
def test_encode_sharded_matches_jax(text, parser, k):
    """7 blocks (the last one 17 bytes) over k shards, padded with empty
    blocks: payloads, reads and cmds of the real blocks, in order."""
    data = text[: 6 * BS + 17]
    got = encode_blocks_device(data, BS, HIST_BITS, parser, mesh=tmesh.make_mesh(["cpu"] * k))
    want = encode_blocks_tpu(data, BS, HIST_BITS, mesh=jmesh.make_mesh(jax.devices()[:k]),
                             parser=parser)
    assert len(got[0]) == 7
    assert got == want
    assert got == encode_blocks_device(data, BS, HIST_BITS, parser, device="cpu")


def test_nlzc_sharded_matches_jax(text):
    """64 KiB (a shipped prior) at 4 KiB blocks: 16 blocks over 3 shards."""
    blob = jppm.compress(text, block_size=4096)
    got = tppm.decompress(blob, mesh=tmesh.make_mesh(["cpu"] * 3))
    assert got == jppm.decompress(blob, mesh=jmesh.make_mesh(jax.devices()[:3]))
    assert got == text


def test_nlzc_sharded_empty():
    assert tppm.decompress(jppm.compress(b"", block_size=4096),
                           mesh=tmesh.make_mesh(["cpu"] * 2)) == b""
