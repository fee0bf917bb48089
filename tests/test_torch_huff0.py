"""Port huff0 device decode (nlzm_tpu_torch.research.huff0) against the JAX
one, exact: the plain scan against JAX's _huff_scan_body on the same
staged arrays (valid, random and truncated streams), decode with the
device engine on the CPU and with the host engine on the cases of
tests/test_huff0.py, a truncated payload against JAX's device output, the
engine names; card-only kernel-vs-plain cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.research import huff0 as jh
from nlzm_tpu_torch.research import huff0 as th

torch.set_num_threads(1)

SAMPLES = ["text", "random", "repetitive", "zeros", "tiny"]


def _staged(container: bytes, device="cpu"):
    return th.stage_blocks(container, *th._parse(container), device)


def _jax_scan(streams, base_l, limit_l, offs, syms, n_out, T):
    """JAX's scan on the port's staged arrays, as [B, T] numpy."""
    out = jh._huff_scan(*(jnp.asarray(a.cpu().numpy()) for a in (streams, base_l, limit_l,
                                                                 offs, syms)),
                        jnp.asarray(n_out.astype(np.int32)), T)
    return np.asarray(out).T


@pytest.fixture(scope="module")
def text_container(corpus_text):
    data = corpus_text(40000) + b"\x00\xff"
    return data, jh.encode(data, block_size=8192)


def test_huff_scan_ref_matches_jax(text_container):
    _, c = text_container
    st = _staged(c)
    want = _jax_scan(*st)
    got = th._huff_scan_ref(*st[:5], st[6])
    assert got.dtype == torch.uint8 and got.shape == (5, 8192)
    np.testing.assert_array_equal(got.numpy(), want)


def test_huff_scan_ref_matches_jax_on_noise(text_container):
    """Random bytes in place of every stream, under the real tables: the
    peek, length and symbol clamps, and reads past the streams."""
    _, c = text_container
    streams, *tables, n_out, T = _staged(c)
    rng = np.random.default_rng(9)
    noise = torch.from_numpy(rng.integers(0, 256, (streams.shape[0], 301), dtype=np.uint8))
    got = th._huff_scan_ref(noise, *tables, T)
    np.testing.assert_array_equal(got.numpy(), _jax_scan(noise, *tables, n_out, T))


@pytest.mark.parametrize("name", SAMPLES)
def test_decode_engines(corpus_samples, name):
    data = corpus_samples[name]
    c = th.encode(data, block_size=4096)
    assert c == jh.encode(data, block_size=4096)
    assert th.decode(c, device="cpu") == data
    assert th.decode(c, engine="host") == data


def test_decode_device_text(text_container):
    data, c = text_container
    assert th.decode(c, engine="device", device="cpu") == data == jh.decode(c, engine="tpu")


def test_empty():
    c = th.encode(b"")
    assert c == jh.encode(b"")
    assert th.decode(c, device="cpu") == b"" == th.decode(c, engine="host")
    assert th.adaptive_decode(th.adaptive_encode(b"")) == b""


@pytest.mark.parametrize("block,cut", [(1, 37), (0, 2000), (4, 10**6)])
def test_truncated_payload_matches_jax(text_container, block, cut):
    _, c = text_container
    bad = th._truncated(c, block, cut)
    got = th.decode(bad, device="cpu")
    assert got == jh.decode(bad, engine="tpu")
    assert len(got) == len(text_container[0])


def test_engine_names(text_container):
    _, c = text_container
    for engine in ("tpu", "native", ""):
        with pytest.raises(ValueError):
            th.decode(c, engine=engine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_huff_scan_kernel_matches_ref(text_container, cuda):
    _, c = text_container
    for blob in (c, th._truncated(c, 1, 37)):
        streams, *tables, _, T = _staged(blob, cuda)
        assert torch.equal(th._huff_scan(streams, *tables, T),
                           th._huff_scan_ref(streams, *tables, T))
