"""find_matches (nlzm_tpu_torch.ops.encode_ops) against the JAX function,
exact, on the worst cases of csrc/find_matches.cu (chip_smoke.fuzz_matches:
text, random bytes, zeros, runs of period 1-4, 7, 9, 264 and 265,
distinct words of one hash, ragged blocks, n_valid outside 0..N, reaches
1, 2, 300, N - 1 and past N, blocks of 700, 4096, 4097, 8192, 32768,
32769 and 40000 bytes, one to four candidates): the plain version, and
chip_smoke.fm_model, the numpy model of the kernel's scheme (two stable
8-bit passes ranked a warp at a time, prev by position, the chain, word
compares). Also the length limit max(n_valid - p, 0) wrapped in int32 as
JAX computes it, the scheme's constants against the kernel source, and a
card-only kernel-vs-plain case."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu_torch.constants import HASH4_MULT
from nlzm_tpu_torch.ops import encode_ops as tenc

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("text", "random", "zeros", "runs_short", "runs_long", "collisions", "ragged_a",
            "ragged_b", "nvalid_wrap", "reach1", "reach2", "reach300", "reach_far", "n4097", "n8192", "rle", "n32769", "n40000")
NV_OUTSIDE = (4096 + 100, -5, -(1 << 31), (1 << 31) - 1)


def _jax(d, nv, reach, C):
    return tuple(np.asarray(a) for a in jenc.find_matches(jnp.asarray(d), jnp.asarray(nv),
                                                          reach, C))


def _equal(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def sets():
    """seed -> pattern -> (input, JAX's (delta, mlen))."""
    out = {}
    for seed in SEEDS:
        fz = cs.fuzz_matches(seed)
        assert tuple(fz) == PATTERNS
        out[seed] = {pat: (args, _jax(*args)) for pat, args in fz.items()}
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_find_matches_ref_fuzz_matches_jax(sets, seed, pattern):
    (d, nv, reach, C), want = sets[seed][pattern]
    _equal(tenc.find_matches(torch.from_numpy(d), torch.from_numpy(nv), reach, C), want)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fm_model_fuzz_matches_jax(sets, seed, pattern):
    (d, nv, reach, C), want = sets[seed][pattern]
    _equal(cs.fm_model(d, nv, reach, C), want)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("n_valid", NV_OUTSIDE)
def test_n_valid_outside_the_block_matches_jax(n_valid, C):
    """Every block at one n_valid past N or below 0: the limit n_valid - p
    wraps in int32 (at -2^31 it is large, so lengths run to 264)."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 4, (4, 4096), np.uint8)
    nv = np.full(4, n_valid, np.int32)
    want = _jax(d, nv, 4095, C)
    _equal(tenc.find_matches_ref(torch.from_numpy(d), torch.from_numpy(nv), 4095, C), want)
    _equal(cs.fm_model(d, nv, 4095, C), want)
    if n_valid == -(1 << 31):  # as unlimited as at 2^31 - 1
        _equal(want, _jax(d, np.full(4, (1 << 31) - 1, np.int32), 4095, C))
    elif n_valid == -5:
        assert not want[1].any() and want[0].any()


@pytest.mark.parametrize("pattern", ["runs_short", "zeros", "text"])
def test_fm_model_six_candidates_matches_ref(pattern):
    """Past four candidates the kernel takes them one at a time."""
    d, nv, reach, _ = cs.fuzz_matches(0, names=[pattern])[pattern]
    _equal(cs.fm_model(d, nv, reach, 6),
           tuple(a.numpy() for a in tenc.find_matches_ref(torch.from_numpy(d),
                                                          torch.from_numpy(nv), reach, 6)))


def test_fuzz_matches_holds_every_case(sets):
    fz = {pat: args for pat, (args, _) in sets[0].items()}
    shapes = {pat: a[0].shape for pat, a in fz.items()}
    assert {n for _, n in shapes.values()} == {700, 4096, 4097, 8192, 32768, 32769, 40000}
    assert all(b * n <= 64 << 10 and b <= 8 for b, n in shapes.values())
    assert {a[3] for a in fz.values()} == {1, 2, 3, 4}
    assert {fz[p][2] for p in ("reach1", "reach2", "reach300")} == {1, 2, 300}
    assert fz["reach_far"][2] >= shapes["reach_far"][1]
    assert fz["text"][2] == shapes["text"][1] - 1
    assert set(fz["nvalid_wrap"][1]) == set(NV_OUTSIDE)
    assert {0, 1, 2, 3, 4096, 1234} <= set(fz["ragged_a"][1]) | set(fz["ragged_b"][1])
    assert fz["rle"][1][0] == 24000
    # every position of zeros in one hash group, each length 264 to the tail
    _, mlen = sets[0]["zeros"][1]
    assert (mlen[:, 3:, :][:, : 4096 - 264 - 3] == 264).all()
    # collisions: block 0's aligned words are distinct and share one hash
    words = fz["collisions"][0][0].view("<u4").astype(np.uint64)
    assert len(set(words.tolist())) == len(words)
    assert len(set(((words * HASH4_MULT) & 0xFFFFFFFF) >> 16)) == 1
    delta, mlen = sets[0]["collisions"][1]
    assert (delta[0, 4::4, 0] == 4).all() and (mlen[0, 4::4] < 4).all()
    # the far reach keeps candidates past the largest in-block distance's half
    assert (sets[0]["reach_far"][1][0] > 350).any()
    # positions past shared memory (N > 32768) come out as below it
    assert shapes["n32769"][1] > cs.FM_SMEM_MAX_N >= shapes["rle"][1]


def test_fm_scheme_matches_kernel_source():
    src = (Path(tenc.__file__).resolve().parent.parent / "csrc" / "find_matches.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("ITEMS"), const("FEW_ITEMS"), const("FEW_BLOCKS"), const("SHORT")) == \
        (cs.FM_ITEMS, cs.FM_FEW_ITEMS, cs.FM_FEW_BLOCKS, cs.FM_SHORT)
    assert const("PAD") == cs.FM_PAD
    assert const("SMEM_MAX_N") == cs.FM_SMEM_MAX_N == tenc._SMEM_MAX_N
    assert const("MAX_N") == tenc._FM_MAX_N
    assert const("MAX_MLEN") == cs.MAX_MATCH == tenc.MAX_MLEN
    assert [cs.fm_threads(1024, n) for n in (1, 700, 1025, 4097, 8192, 32768)] == \
        [32, 64, 96, 288, 512, 1024]
    assert [cs.fm_threads(4, n) for n in (1, 700, 4096, 131072)] == [32, 192, 1024, 1024]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_find_matches_kernel_matches_ref_on_fuzz(cuda):
    for pat, (d, nv, reach, C) in cs.fuzz_matches(0, card=True).items():
        dt, nvt = torch.from_numpy(d).to(cuda), torch.from_numpy(nv).to(cuda)
        got = tenc.find_matches(dt, nvt, reach, C)
        want = tenc.find_matches_ref(dt, nvt, reach, C)
        for g, w in zip(got, want):
            assert torch.equal(g, w), pat
