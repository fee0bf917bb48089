"""The port's optimal device parse through its entry points, against the
JAX package with engine="tpu", byte for byte: parse_blocks_device,
encode_container for v1 and wide (a 1-byte input, an empty one, a partial
last block), encode_container_stream at its default parser; the optimal
parse beating the greedy one; an unknown parser. The functions
themselves are held in tests/test_torch_optimal_parse.py."""

import numpy as np
import pytest
import torch

from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.parallel import stream as jstream
from nlzm_tpu_torch.ops import encode_ops as tenc
from nlzm_tpu_torch.parallel import blocks as tblocks
from nlzm_tpu_torch.parallel import stream as tstream

torch.set_num_threads(1)

N4K = 4096
HIST4K = 12


# name -> input bytes: a 1-byte input, an empty one, a partial last block
INPUTS = {
    "one": lambda text: b"x",
    "empty": lambda text: b"",
    "partial": lambda text: text(9000) + b"#",
}


@pytest.mark.parametrize("name", ["partial", "one"])
def test_parse_blocks_device_optimal_matches_jax(corpus_text, name):
    data = INPUTS[name](corpus_text)
    want = jenc.parse_blocks_device(data, N4K, HIST4K, parser="optimal")
    got = tenc.parse_blocks_device(data, N4K, HIST4K, parser="optimal", device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("profile", ["v1", "wide"])
def test_encode_container_optimal_matches_jax(corpus_text, profile, name):
    data = INPUTS[name](corpus_text)
    kw = dict(block_size=N4K, parser="optimal", profile=profile)
    got = tblocks.encode_container(data, engine="device", device="cpu", **kw)
    assert got == jblocks.encode_container(data, engine="tpu", **kw)
    assert tblocks.decode_container(got, device="cpu") == data


def test_encode_container_stream_default_parser_matches_jax(corpus_text, tmp_path):
    """The stream encode at its default parser, "optimal", in two buckets
    of two blocks, the last one partial: the JAX file byte for byte."""
    data = corpus_text(16_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    kw = dict(block_size=N4K, bucket_bytes=2 * N4K)
    j = jstream.encode_container_stream(str(src), str(tmp_path / "jax.nlzp"), engine="tpu", **kw)
    t = tstream.encode_container_stream(str(src), str(tmp_path / "port.nlzp"), engine="device",
                                        device="cpu", **kw)
    assert t == j
    assert (tmp_path / "port.nlzp").read_bytes() == (tmp_path / "jax.nlzp").read_bytes()


def test_optimal_parse_beats_greedy(corpus_text):
    """The JAX package's property (tests/test_tpu_encode.py): the
    calibrated optimal parse gives a smaller container than the greedy."""
    data = corpus_text(49152)
    opt, greedy = (tblocks.encode_container(data, block_size=8192, parser=p, engine="device",
                                            device="cpu") for p in ("optimal", "greedy"))
    assert len(opt) < len(greedy)
    assert tblocks.decode_container(opt, device="cpu") == data


def test_unknown_parser_raises():
    with pytest.raises(ValueError, match="parser"):
        tenc.encode_blocks_device(b"abc" * 100, N4K, HIST4K, parser="lazy", device="cpu")
