"""Port device parse (nlzm_tpu_torch.ops.encode_ops) against the JAX
functions, exact: find_matches on the text, repetitive, random and zeros
samples at 4 KiB blocks with one and three candidates and two reaches, and
on 40000-byte blocks (the JAX 2-key sort path); greedy_cover and repify on
the JAX outputs; parse_blocks_device end to end; the optimal-parse
encodes, once not ported; device checks of the wrappers; card-only
kernel-vs-plain cases."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu_torch.ops import encode_ops as tenc
from nlzm_tpu_torch.parallel import blocks as tblocks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SAMPLES = ("text", "repetitive", "random", "zeros")
N4K = 4096


def _arrays(data: bytes, N: int):
    arr, nv = jenc._blocks_arrays(data, N)
    return arr, nv


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


@pytest.fixture(scope="module")
def jax_parse(corpus_samples):
    """sample -> (arr, n_valid, JAX delta, mlen, op_len, op_val, op_rep) at
    4 KiB blocks, full reach, one candidate."""
    out = {}
    for name in SAMPLES:
        arr, nv = _arrays(corpus_samples[name], N4K)
        dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
        delta, mlen = jenc.find_matches(dj, nvj, N4K - 1)
        op_len, op_val = jenc.greedy_cover(dj, delta, mlen, nvj, N4K)
        op_rep = jenc.repify(op_len, op_val)
        out[name] = tuple(np.asarray(a) for a in (arr, nv, delta, mlen, op_len, op_val, op_rep))
    return out


@pytest.mark.parametrize("reach", [N4K - 1, 300])
@pytest.mark.parametrize("num_cands", [1, 3])
@pytest.mark.parametrize("name", SAMPLES)
def test_find_matches_matches_jax(corpus_samples, name, num_cands, reach):
    arr, nv = _arrays(corpus_samples[name], N4K)
    jd, jm = jenc.find_matches(jnp.asarray(arr), jnp.asarray(nv), reach, num_cands)
    td, tm = tenc.find_matches(_t(arr), _t(nv), reach, num_cands)
    assert td.dtype == tm.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("num_cands", [1, 3])
def test_find_matches_big_blocks_match_jax(corpus_text, num_cands):
    """N > 32768: the JAX function's 2-key lexicographic sort path; a
    ragged last block."""
    N = 40000
    arr, nv = _arrays(corpus_text(61000), N)
    reach = (1 << 16) - 1
    jd, jm = jenc.find_matches(jnp.asarray(arr), jnp.asarray(nv), reach, num_cands)
    td, tm = tenc.find_matches(_t(arr), _t(nv), reach, num_cands)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("name", SAMPLES)
def test_greedy_cover_matches_jax(jax_parse, name):
    arr, nv, delta, mlen, op_len, op_val, _ = jax_parse[name]
    tl, tv = tenc.greedy_cover(_t(arr), _t(delta), _t(mlen), _t(nv), N4K)
    np.testing.assert_array_equal(tl.numpy(), op_len)
    np.testing.assert_array_equal(tv.numpy(), op_val)


@pytest.mark.parametrize("name", SAMPLES)
def test_repify_matches_jax(jax_parse, name):
    *_, op_len, op_val, op_rep = jax_parse[name]
    got = tenc.repify(_t(op_len), _t(op_val))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), op_rep)


def test_repify_live_distances():
    """A rep hit takes the first equal slot and leaves the table; a fresh
    distance goes to the front; rows that are not matches give -1."""
    op_len = np.array([[5], [0], [4], [3], [-1], [6], [2]], np.int32)
    op_val = np.array([[3], [65], [9], [3], [0], [9], [1]], np.int32)
    want = np.asarray(jenc.repify(jnp.asarray(op_len), jnp.asarray(op_val)))
    got = tenc.repify(_t(op_len), _t(op_val)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [2, -1, -1, 3, -1, 0, 1])


@pytest.mark.parametrize("name", ["text", "repetitive"])
def test_parse_blocks_device_matches_jax(corpus_samples, name):
    data = corpus_samples[name]
    want = jenc.parse_blocks_device(data, N4K, 12, parser="greedy")
    got = tenc.parse_blocks_device(data, N4K, 12, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_parse_blocks_device_empty():
    op_len, op_val, op_rep, depths = tenc.parse_blocks_device(b"", N4K, 12, device="cpu")
    assert op_len.shape == op_val.shape == op_rep.shape == (0, 0) and depths.shape == (0,)


def test_optimal_device_parse_is_not_ported():
    """Ported since: the optimal device parse and the wide encode on it
    equal JAX's (tests/test_torch_optimal_encode.py holds more inputs)."""
    data = b"abc" * 100
    got = tenc.parse_blocks_device(data, N4K, 12, parser="optimal", device="cpu")
    for g, w in zip(got, jenc.parse_blocks_device(data, N4K, 12, parser="optimal"), strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    kw = dict(block_size=N4K, profile="wide", parser="optimal")
    assert (tblocks.encode_container(data, engine="device", device="cpu", **kw)
            == jblocks.encode_container(data, engine="tpu", **kw))


@pytest.mark.parametrize("parser", ["optimal"])
def test_v1_device_encode_is_not_ported(parser):
    """Ported since: the v1 device encode with the optimal parse equals
    JAX's container (the greedy one is in tests/test_torch_v1_encode.py)."""
    data = b"abc" * 100
    kw = dict(block_size=N4K, parser=parser)
    got = tblocks.encode_container(data, engine="device", device="cpu", **kw)
    assert got == jblocks.encode_container(data, engine="tpu", **kw)
    assert tblocks.decode_container(got, device="cpu") == data


def test_device_engine_refuses_a_dictionary():
    """The JAX rule: a shared dictionary needs the native optimal pipeline."""
    with pytest.raises(ValueError, match="dictionaries"):
        tblocks.encode_container(bytes(range(256)) * 100, block_size=N4K, profile="wide",
                                 parser="greedy", engine="device", dict_size=4096,
                                 device="cpu")


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        tblocks.encode_container(b"abc", engine="tpu")


def test_encode_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; meta tensors raise, and no
    launch is counted."""
    m = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=m)
    u8 = torch.empty(2, 64, dtype=torch.uint8, device=m)
    with pytest.raises(ValueError):
        tenc.find_matches(u8, torch.empty(2, **i32), 63)
    with pytest.raises(ValueError):
        tenc.greedy_cover(u8, torch.empty(2, 64, **i32), torch.empty(2, 64, **i32),
                          torch.empty(2, **i32), 256)
    with pytest.raises(ValueError):
        tenc.repify(torch.empty(256, 2, **i32), torch.empty(256, 2, **i32))
    assert tenc.find_matches.launches == tenc.greedy_cover.launches == tenc.repify.launches == 0


def test_device_encode_runs_without_jax():
    """The device encodes, wide and v1 (run here on the CPU), and the
    decodes of their containers load nothing of jax, nlzm_tpu or
    bench.py; a subprocess, since this test process has them loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import nlzm_tpu_torch\n"
        "data = bytes(range(256)) * 20 + b'device encode ' * 300\n"
        "c = nlzm_tpu_torch.encode_container(data, block_size=4096, profile='wide',\n"
        "                                    parser='greedy', engine='device', device='cpu')\n"
        "assert nlzm_tpu_torch.decode_container(c, device='cpu') == data\n"
        "c = nlzm_tpu_torch.encode_container(data, block_size=4096, parser='greedy',\n"
        "                                    engine='device', device='cpu')\n"
        "assert nlzm_tpu_torch.decode_container(c, device='cpu') == data\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'nlzm_tpu')\n"
        "             or m.startswith(('jax.', 'nlzm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("N", [N4K, 40000])
def test_find_matches_kernel_matches_ref(corpus_text, cuda, N):
    arr, nv = _arrays(corpus_text(61000), N)
    d, n = _t(arr).to(cuda), _t(nv).to(cuda)
    for C in (1, 3):
        for g, w in zip(tenc.find_matches(d, n, N - 1, C), tenc.find_matches_ref(d, n, N - 1, C)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", SAMPLES)
def test_greedy_cover_kernel_matches_ref(jax_parse, cuda, name):
    arr, nv, delta, mlen, *_ = jax_parse[name]
    args = (_t(arr).to(cuda), _t(delta).to(cuda), _t(mlen).to(cuda), _t(nv).to(cuda), N4K)
    for g, w in zip(tenc.greedy_cover(*args), tenc.greedy_cover_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", SAMPLES)
def test_repify_kernel_matches_ref(jax_parse, cuda, name):
    *_, op_len, op_val, _ = jax_parse[name]
    ol, ov = _t(op_len).to(cuda), _t(op_val).to(cuda)
    assert torch.equal(tenc.repify(ol, ov), tenc.repify_ref(ol, ov))
