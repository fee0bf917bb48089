"""Port v1 block decoder (nlzm_tpu_torch.ops.decode_v2) against the JAX
fsm_decode_v2, exact on both output arrays, dead steps included, on the
same pack_streams arrays: the five sample corpora at 4 KiB blocks
(greedy), 8 KiB blocks (optimal), 16 KiB blocks of two frames each, a
12-byte block, and chip_smoke.py's hostile streams (random bytes, streams
cut short, rANS bases below 0, past the row and at the i32 limit). Also
the bank and mixin constants, the fence ends the kernel's search rests
on, and the kernel against its plain version where there is a
card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import hostile_streams
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


def _assert_same(arr: np.ndarray, num_steps: int, all_end: bool = True):
    j_len, j_val = jax_fsm(jnp.asarray(arr), num_steps)
    t_len, t_val = decode_v2.fsm_decode_v2(torch.from_numpy(arr.copy()), num_steps)
    assert t_len.dtype == torch.int32 and t_val.dtype == torch.int32
    assert t_len.shape == (num_steps, arr.shape[0])
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))
    # dead steps were compared too: every block (or, hostile, some) ends
    # inside the scan
    ended = t_len.numpy()[-1] < 0
    assert ended.all() if all_end else ended.any()
    return t_len.numpy(), t_val.numpy()


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fsm_matches_jax_on_hostile_streams(corpus_samples, seed):
    """Every step of every row, the frozen pairs after a terminator too:
    the plain version is the card's only judge of the kernel's clamps."""
    arr, num_steps = _staged(corpus_samples["text"], block_size=1024, parser="greedy")
    assert arr.shape[0] >= 10
    t_len, t_val = _assert_same(hostile_streams(arr, seed), num_steps, all_end=False)
    for b in np.flatnonzero(t_len[-1] < 0):  # frozen: the terminator's pair repeats
        end = int(np.argmax(t_len[:, b] < 0))
        assert (t_len[end:, b] == -1).all() and (t_val[end:, b] == t_val[end, b]).all()


@pytest.mark.parametrize("case", ["two_frames", "hostile0", "hostile1"])
def test_fsm_ref_init_every_step_matches_jax(corpus_samples, corpus_text, case):
    """The step fsm_decode_v2_ref captures as a CUDA graph and replays on a
    card, run here eagerly: the state held in place, the frame init
    predicated at every step (no step waits for any(need)), no early
    exit; JAX's arrays, dead steps included."""
    if case == "two_frames":
        arr, num_steps = _staged(corpus_text(40000), block_size=16384, parser="greedy")
    else:
        arr, num_steps = _staged(corpus_samples["text"], block_size=1024, parser="greedy")
        arr = hostile_streams(arr, int(case[-1]))
    j_len, j_val = (np.asarray(a) for a in jax_fsm(jnp.asarray(arr), num_steps))
    k, s = decode_v2._ref_setup(torch.from_numpy(arr.copy()))
    outs = (torch.empty(num_steps, arr.shape[0], dtype=torch.int32),
            torch.empty(num_steps, arr.shape[0], dtype=torch.int32),
            torch.zeros(1, dtype=torch.long))
    for _ in range(num_steps):
        decode_v2._ref_step_in_place(k, s, *outs, lazy=False)
    np.testing.assert_array_equal(outs[0].numpy(), j_len)
    np.testing.assert_array_equal(outs[1].numpy(), j_val)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_adaptation_pins_fence_ends(n):
    """What the kernel's one-ballot search rests on: under any symbols,
    fence 0 stays 0 (so popc(ballot(f >= fence j)) - 1 over j = 0..n - 1
    is JAX's sum(f >= fence[1:])) and fences n..16 stay at full scale
    (their targets equal them), so a lane group needs only fences 0..n;
    the fences also stay nondecreasing."""
    rng = np.random.default_rng(n)
    mix = tcdf.mixin_tensor()[n.bit_length() - 3].astype(np.int64)
    row = tcdf.initial_bank()[{4: 0, 16: 1, 8: 18}[n]].astype(np.int64)
    for y in np.concatenate([rng.integers(0, n, 3000), np.full(700, n - 1), np.zeros(700, int)]):
        row = row + ((mix[y] - row) >> 7)
        assert row[0] == 0 and (row[n:] == 1 << 14).all() and (np.diff(row) >= 0).all()


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
