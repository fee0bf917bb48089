"""Port v1 block decoder (nlzm_tpu_torch.ops.decode_v2) against the JAX
fsm_decode_v2, exact on both output arrays, dead steps included, on the
same pack_streams arrays: the five sample corpora at 4 KiB blocks
(greedy), 8 KiB blocks (optimal), 16 KiB blocks of two frames each, and
a 12-byte block. Also the bank and mixin constants, and the kernel
against its plain version where there is a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.ops import cdf_ops as jcdf
from nlzm_tpu.ops.decode_v2 import fsm_decode_v2 as jax_fsm
from nlzm_tpu.parallel.blocks import _round_up, encode_container, pack_streams, parse_container
from nlzm_tpu_torch.ops import cdf_ops as tcdf
from nlzm_tpu_torch.ops import decode_v2

torch.set_num_threads(1)

SAMPLES = ["text", "repetitive", "random", "long_range", "zeros"]


def _staged(data: bytes, **cfg):
    """(pack_streams array [B, S] u8, num_steps) of a v1 container."""
    c = encode_container(data, **cfg)
    info = parse_container(c)
    return pack_streams(c, info), _round_up(max(info.num_cmds) + 1, 256)


def _assert_same(arr: np.ndarray, num_steps: int):
    j_len, j_val = jax_fsm(jnp.asarray(arr), num_steps)
    t_len, t_val = decode_v2.fsm_decode_v2(torch.from_numpy(arr.copy()), num_steps)
    assert t_len.dtype == torch.int32 and t_val.dtype == torch.int32
    assert t_len.shape == (num_steps, arr.shape[0])
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))
    # dead steps were compared too: every block ends inside the scan
    assert (t_len.numpy()[-1] < 0).all()


@pytest.mark.parametrize("name", SAMPLES)
def test_fsm_matches_jax_4k_greedy(corpus_samples, name):
    _assert_same(*_staged(corpus_samples[name], block_size=4096, parser="greedy"))


def test_fsm_matches_jax_8k_optimal(corpus_text):
    _assert_same(*_staged(corpus_text(30000), block_size=8192, parser="optimal"))


def test_fsm_matches_jax_two_frames_per_block(corpus_text):
    # 16 KiB blocks at hist_bits 14 (frame chunk 14848): two frames per
    # block, ragged last block
    data = corpus_text(60000) + b"tail"
    arr, num_steps = _staged(data, block_size=16384, parser="greedy")
    info = parse_container(encode_container(data, block_size=16384, parser="greedy"))
    assert info.frame_bits == 14 and len(info.comp_sizes) == 4
    _assert_same(arr, num_steps)


def test_fsm_matches_jax_tiny_block():
    _assert_same(*_staged(b"abcabcabcabc", block_size=4096, parser="greedy"))


def test_bank_layout_and_mixin_match_jax():
    for name in ("CTX_CMD", "CTX_LIT_HI", "CTX_LIT_LO", "CTX_LEN_DIRECT", "CTX_LEN_EXT_HI",
                 "CTX_LEN_EXT_LO", "CTX_DIST_HI", "CTX_DIST_LO", "NUM_CTX", "CDF_WIDTH"):
        assert getattr(tcdf, name) == getattr(jcdf, name), name
    np.testing.assert_array_equal(tcdf.ctx_sizes(), jcdf.ctx_sizes())
    np.testing.assert_array_equal(tcdf.ctx_classes(), jcdf.ctx_classes())
    np.testing.assert_array_equal(tcdf.initial_bank(), jcdf.initial_bank())
    np.testing.assert_array_equal(tcdf.mixin_tensor(), jcdf.mixin_tensor())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_fsm_kernel_matches_ref(corpus_samples, cuda):
    for name in SAMPLES:
        arr, num_steps = _staged(corpus_samples[name], block_size=4096, parser="greedy")
        g = torch.from_numpy(arr).to(cuda)
        got = decode_v2.fsm_decode_v2(g, num_steps)
        want = decode_v2.fsm_decode_v2_ref(g, num_steps)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
