"""Sharded container decodes of the port (nlzm_tpu_torch/parallel/mesh.py)
on the CPU, against the JAX package's on the virtual 8-device CPU mesh:
the same containers, exact bytes, at several shard counts, ragged block
counts, padding, empty and corrupt containers; and the shared
dictionary, which JAX's sharded wide decode drops. The sharded encode
and NLZC decode: tests/test_torch_mesh_encode.py."""

import jax
import pytest
import torch

from nlzm_tpu.parallel import mesh as jmesh
from nlzm_tpu.parallel.blocks import decode_container as jdecode
from nlzm_tpu.parallel.blocks import encode_container, parse_container
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.parallel import mesh as tmesh
from nlzm_tpu_torch.parallel.blocks import ContainerInfo, IntegrityError, gathered
from nlzm_tpu_torch.utils.shards import shard_rows

torch.set_num_threads(1)

BS = 2048
BS_V1 = 1024  # the plain v1 decode is a step loop a shard: short blocks keep it quick


def jax_mesh(k: int):
    return jmesh.make_mesh(jax.devices()[:k])


def cpu_mesh(k: int):
    return tmesh.make_mesh(["cpu"] * k)


@pytest.fixture(scope="module")
def text():
    return build_nonperiodic(64 * 1024, seed=11)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_v1_sharded_matches_jax(text, k):
    """2k + 1 blocks (the last one short) over k shards: padded to 2k + 2."""
    data = text[: 2 * k * BS_V1 + 17]
    c = encode_container(data, block_size=BS_V1, parser="greedy")
    assert len(parse_container(c).comp_sizes) == 2 * k + 1
    got = tmesh.decode_container_sharded(c, cpu_mesh(k))
    assert got == jmesh.decode_container_sharded(c, jax_mesh(k))
    assert got == data


@pytest.mark.parametrize("k", [2, 3])
def test_wide_sharded_no_dict_matches_jax(text, k):
    data = text[:40_000]
    c = encode_container(data, block_size=4096, parser="optimal", profile="wide")
    assert parse_container(c).dictionary is None
    got = tmesh.decode_wide_sharded(c, cpu_mesh(k))
    assert got == jmesh.decode_wide_sharded(c, jax_mesh(k))
    assert got == data


def test_wide_sharded_keeps_the_dictionary(text):
    """8 KiB blocks + an 8 KiB dictionary, optimal, depth cap 8 (the
    shipping config, cut down): the port's sharded decode equals the input
    and JAX's unsharded decode. JAX's sharded decode drops the dictionary
    (nlzm_tpu/parallel/mesh.py:97-106) and differs from the input here: the
    defect the port must not copy."""
    c = encode_container(text, block_size=8192, dict_size=8192, depth_cap=8,
                         parser="optimal", profile="wide")
    assert parse_container(c).dictionary
    assert tmesh.decode_wide_sharded(c, cpu_mesh(3)) == text == jdecode(c)
    assert jmesh.decode_wide_sharded(c, jax_mesh(3)) != text


def test_padding_below_one_block_a_shard(text):
    """Pads stay below the shard count; with fewer blocks than shards whole
    shards hold pad rows only (2 blocks over 3 shards)."""
    for b in range(1, 40):
        for k in (1, 2, 3, 5, 8):
            rows = b + (-b) % k
            assert rows - b < k
            bounds = [shard_rows(rows, k, i) for i in range(k)]
            assert bounds[0][0] == 0 and bounds[-1][1] == rows
            assert all(hi - lo == rows // k for lo, hi in bounds)
            assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    data = text[: BS + 100]
    wide = encode_container(data, block_size=BS, parser="optimal", profile="wide")
    v1 = encode_container(data[: BS_V1 + 100], block_size=BS_V1, parser="greedy")
    assert tmesh.decode_wide_sharded(wide, cpu_mesh(3)) == data
    assert tmesh.decode_container_sharded(v1, cpu_mesh(3)) == data[: BS_V1 + 100]


def test_empty_containers():
    for kw in (dict(profile="wide", parser="optimal"), dict(parser="greedy")):
        c = encode_container(b"", block_size=BS, **kw)
        decode = tmesh.decode_wide_sharded if kw.get("profile") else tmesh.decode_container_sharded
        assert decode(c, cpu_mesh(2)) == b""


def test_flipped_bit_is_integrity_error(text):
    for kw, decode in ((dict(block_size=BS, profile="wide", parser="optimal"),
                        tmesh.decode_wide_sharded),
                       (dict(block_size=BS_V1, parser="greedy"), tmesh.decode_container_sharded)):
        c = bytearray(encode_container(text[: 5 * kw["block_size"]], **kw))
        info = parse_container(bytes(c))
        c[info.payload_off + info.comp_sizes[0] + info.comp_sizes[1] // 2] ^= 0x10
        with pytest.raises(IntegrityError):
            decode(bytes(c), cpu_mesh(2))


def test_wrong_profile_raises(text):
    data = text[:3 * BS]
    with pytest.raises(ValueError):
        tmesh.decode_wide_sharded(encode_container(data, block_size=BS), cpu_mesh(2))
    with pytest.raises(ValueError):
        tmesh.decode_container_sharded(
            encode_container(data, block_size=BS, parser="optimal", profile="wide"), cpu_mesh(2))


def test_make_mesh():
    assert tmesh.make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert tmesh.make_mesh([torch.device("cpu")]) == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    if torch.cuda.is_available():
        assert len(tmesh.make_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError):
            tmesh.make_mesh()
    assert tmesh.BLOCK_AXIS == jmesh.BLOCK_AXIS


def test_gathered_checks_the_sizes():
    """The ordered gather: blocks at block strides, cut to the length; with
    no CRC to catch it, a block that produced other than its length raises
    IntegrityError. Two shards of 2 rows, the last a pad row."""
    info = ContainerInfo(hist_bits=12, frame_bits=12, block_size=4, total_len=10,
                         comp_sizes=[1, 1, 1], total_reads=[0] * 3, num_cmds=[1] * 3,
                         payload_off=0)
    rows = torch.arange(16, dtype=torch.uint8).reshape(4, 4)

    def shards(sizes):
        sizes = torch.tensor(sizes, dtype=torch.int32)
        return [(rows[:2], sizes[:2]), (rows[2:], sizes[2:])]

    assert gathered(shards([4, 4, 2, 0]), info) == bytes(range(10))
    for bad in ([4, 3, 2, 0], [4, 4, 3, 0]):
        with pytest.raises(IntegrityError):
            gathered(shards(bad), info)
