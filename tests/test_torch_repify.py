"""repify (nlzm_tpu_torch.ops.encode_ops) against the JAX function, exact,
on the worst cases of the segmented replay in csrc/repify.cu
(chip_smoke.fuzz_rep: a cycle of 5 distances that defeats the
speculation, distance-1 runs, a cycle of 4, fresh distances, 6 values on
20% of rows, no matches, hostile distances and dead rows, one match at
the last row, T no multiple of 32, T = 1) and on the greedy commands of
the corpus samples: the plain version (a loop over match ranks) and
chip_smoke.rep_model, the numpy model of the kernel's scheme, at the
kernel's 64 segments a block, at 32 and at 48, which divides no T here.
Also the runs the model takes, and card-only kernel-vs-plain cases."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import REP_GUESS, REP_R, REP_S, fuzz_rep, rep_model, rep_work
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu_torch.ops import encode_ops as tenc

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("cycle5", "rle", "cycle4", "fresh", "random6", "literals", "dead", "hostile",
            "last_match", "ragged", "one_row")
SEGMENTS = (REP_S, 32, 48)
SAMPLES = ("text", "repetitive", "random", "zeros")
N4K = 4096
FUZZ = dict(B=8, T=2048)  # 64 KiB an array


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


@pytest.fixture(scope="module")
def sets():
    return {seed: fuzz_rep(seed, **FUZZ) for seed in SEEDS}


def _hold(op_len, op_val):
    """The plain version and the model at each segment count, against JAX.
    Returns the runs the model took at REP_S segments."""
    want = np.asarray(jenc.repify(jnp.asarray(op_len), jnp.asarray(op_val)))
    got = tenc.repify(_t(op_len), _t(op_val))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    runs = {}
    for S in SEGMENTS:
        rep, runs[S] = rep_model(op_len, op_val, S)
        np.testing.assert_array_equal(rep, want)
    return runs[REP_S]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_repify_fuzz_rep_matches_jax(sets, seed, pattern):
    _hold(*sets[seed][pattern])


@pytest.fixture(scope="module")
def greedy_commands(corpus_samples):
    """sample -> the JAX greedy commands (op_len, op_val) at 4 KiB blocks."""
    out = {}
    for name in SAMPLES:
        arr, nv = jenc._blocks_arrays(corpus_samples[name], N4K)
        dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
        delta, mlen = jenc.find_matches(dj, nvj, N4K - 1)
        out[name] = tuple(np.asarray(a) for a in jenc.greedy_cover(dj, delta, mlen, nvj, N4K))
    return out


@pytest.mark.parametrize("name", SAMPLES)
def test_repify_corpus_matches_jax(greedy_commands, name):
    runs = _hold(*greedy_commands[name])
    assert (runs <= REP_R).all()  # no corpus block needs the fallback


def test_rep_model_runs(sets):
    """The runs of each pattern: the cycle of 5 reaches the fallback in
    every block; no matches, or only fresh distances, verify at the first
    rerun; distance-1 runs and the cycle of 4 take one more."""
    for seed in SEEDS:
        s = sets[seed]
        runs = {name: rep_model(*s[name])[1] for name in PATTERNS}
        assert (runs["cycle5"] == REP_R + 1).all()
        for name in ("fresh", "literals", "dead", "one_row"):
            assert (runs[name] == 2).all(), name
        for name in ("rle", "cycle4"):
            assert (runs[name] == 3).all(), name


def test_fuzz_rep_holds_every_case(sets):
    """Every pattern is what its name says."""
    T, B = FUZZ["T"], FUZZ["B"]
    for seed in SEEDS:
        s = sets[seed]
        for name in PATTERNS:
            op_len, op_val = s[name]
            assert op_len.dtype == op_val.dtype == np.int32
            want = {"ragged": (T - 27, B - 3), "one_row": (1, B - 1)}.get(name, (T, B))
            assert op_len.shape == op_val.shape == want, name
        assert (s["ragged"][0].shape[0] % 32) != 0
        for name in ("cycle5", "cycle4", "fresh"):
            assert (s[name][0] > 0).all(), name
        assert set(np.unique(s["cycle5"][1])) == {1, 2, 3, 4, 5}
        assert len(np.unique(s["fresh"][1])) == T * B
        ln, v = s["rle"]
        assert (v[ln > 0] == 1).all() and (ln == 0).any()
        ln, v = s["random6"]
        assert 0.15 < (ln > 0).mean() < 0.25 and len(np.unique(v[ln > 0])) == 6
        assert (s["literals"][0] == 0).all() and (s["dead"][0] == -1).all()
        ln, v = s["hostile"]
        m = v[ln > 0]
        assert (ln < -1).any() and (ln == 0).any()
        assert (m <= 0).any() and (m == np.iinfo(np.int32).min).any()
        assert (m == np.iinfo(np.int32).max).any() and np.isin(REP_GUESS, m).all()
        ln, _ = s["last_match"]
        assert (ln[:-1] == 0).all() and (ln[-1] > 0).all()


def test_rep_scheme_matches_kernel_source():
    """REP_S, REP_R and REP_GUESS, which rep_model runs on, are the
    kernel's S, default R and guess (slot i holds -i)."""
    src = (Path(tenc.__file__).resolve().parents[1] / "csrc" / "repify.cu").read_text()
    assert int(re.search(r"constexpr int S = (\d+);", src)[1]) == REP_S
    assert int(re.search(r"#define NLZM_REPIFY_RUNS (\d+)", src)[1]) == REP_R
    assert re.search(r"constexpr int guess\(int i\) \{ return (.*?); \}", src)[1] == "-i"
    assert REP_GUESS == tuple(-i for i in range(4))


def test_rep_work_counts_the_sectors_of_matches():
    """repify's bound reads op_val only in the 32-byte sectors that hold a
    match: two matches in words 0 and 7 share sector 0, one in word 25 is
    in sector 3; literals and dead rows need none."""
    op_len = torch.full((4, 10), -1, dtype=torch.int32)
    op_len[0, 0] = op_len[0, 7] = 3
    op_len[0, 8] = 0
    op_len[2, 5] = 2
    assert rep_work(op_len) == (2 * 160 + 32 * 2, 2 * 40 + 12 * 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_repify_kernel_matches_ref_on_fuzz_rep(sets, cuda, pattern):
    ol, ov = (_t(a).to(cuda) for a in sets[0][pattern])
    assert torch.equal(tenc.repify(ol, ov), tenc.repify_ref(ol, ov))
