"""The cover walk (nlzm_tpu_torch.ops.encode_ops: greedy_cover, dp_cover)
against the JAX functions, exact, on the worst cases of the segmented walk
in csrc/greedy_cover.cu (chip_smoke.fuzz_cover: chains that never meet,
long matches, jumps over whole segments and past N, a start at every
position, num_steps below the command count, n_valid 0, 1, mid-segment,
N - 1 and N) and on chip_smoke.fuzz_opt: the plain versions (pointer
doubling) and chip_smoke.cover_model, the numpy model of the kernel's
segments, at the kernel's 32 positions a segment and at 48, which does
not divide N. Also the default cost row, cached once per device, and
card-only kernel-vs-plain cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import COVER_W, cover_model, fuzz_cover, fuzz_opt
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu_torch.ops import encode_ops as tenc

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("never_meet", "long_match", "far_jumps", "literals", "mixed", "few_steps")
WIDTHS = (COVER_W, 48)


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


@pytest.fixture(scope="module")
def sets():
    return {seed: fuzz_cover(seed) for seed in SEEDS}


def _greedy_args(f):
    return f["data"], f["delta"], f["mlen"], f["n_valid"]


def _dp_args(f):
    return f["data"], f["delta3"], f["choice_len"], f["choice_cand"], f["n_valid"]


def _assert_all_equal(want, got):
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_cover_walk_matches_jax(sets, seed, pattern):
    f = sets[seed][pattern]
    args, T = _greedy_args(f), f["num_steps"]
    want = jenc.greedy_cover(*(jnp.asarray(a) for a in args), T)
    _assert_all_equal(want, (o.numpy() for o in tenc.greedy_cover(*(_t(a) for a in args), T)))
    for W in WIDTHS:
        _assert_all_equal(want, cover_model(f["data"], f["delta"], f["mlen"], f["n_valid"], T,
                                            W=W))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_dp_cover_walk_matches_jax(sets, seed, pattern):
    f = sets[seed][pattern]
    args, T = _dp_args(f), f["num_steps"]
    want = jenc.dp_cover(*(jnp.asarray(a) for a in args), T)
    _assert_all_equal(want, (o.numpy() for o in tenc.dp_cover(*(_t(a) for a in args), T)))
    for W in WIDTHS:
        _assert_all_equal(want, cover_model(f["data"], f["delta3"], f["choice_len"],
                                            f["n_valid"], T, cand=f["choice_cand"], W=W))


@pytest.mark.parametrize("seed", [7, 8])
def test_cover_walk_fuzz_opt_matches_jax(seed):
    """fuzz_opt's N = 700 is no multiple of 32: a short last segment.
    greedy_cover on its first candidate, dp_cover on its choices."""
    f = fuzz_opt(seed)
    T = f["data"].shape[1] + 64
    g = (f["data"], f["delta"][..., 0], f["mlen"][..., 0], f["n_valid"])
    want = jenc.greedy_cover(*(jnp.asarray(a) for a in g), T)
    _assert_all_equal(want, (o.numpy() for o in tenc.greedy_cover(*(_t(a) for a in g), T)))
    for W in WIDTHS:
        _assert_all_equal(want, cover_model(*g, T, W=W))
    d = (f["data"], f["delta"], f["choice_len"], f["choice_cand"], f["n_valid"])
    want = jenc.dp_cover(*(jnp.asarray(a) for a in d), T)
    _assert_all_equal(want, (o.numpy() for o in tenc.dp_cover(*(_t(a) for a in d), T)))
    for W in WIDTHS:
        _assert_all_equal(want, cover_model(f["data"], f["delta"], f["choice_len"],
                                            f["n_valid"], T, cand=f["choice_cand"], W=W))


def test_fuzz_cover_holds_every_case(sets):
    """Every pattern is what its name says, with n_valid 0, 1,
    mid-segment, N - 1 and N, hostile literals on both sides, candidates
    outside [0, C), and steps past N."""
    for seed in SEEDS:
        s = sets[seed]
        N = s["mixed"]["data"].shape[1]
        nv = s["mixed"]["n_valid"]
        assert nv[0] == 0 and nv[1] == 1 and nv[2] % 32 == 17 and nv[3] == N - 1 and nv[4] == N
        for name in PATTERNS:
            f = s[name]
            ol, _ = cover_model(f["data"], f["delta"], f["mlen"], f["n_valid"], f["num_steps"])
            ncmd = (ol >= 0).sum(0)
            assert (ol[:, 0] == -1).all()
            if name == "few_steps":
                assert (ncmd == f["num_steps"]).sum() >= 10  # blocks cut short
            elif name == "literals":
                assert (ncmd == np.minimum(f["n_valid"], f["num_steps"])).all()
            else:
                assert ncmd[4] < f["num_steps"]
        lm = s["long_match"]
        assert (lm["mlen"] == 264).all() and (lm["choice_len"] == 264).all()
        nm = s["never_meet"]
        assert nm["mlen"][:, 0].tolist() == [3] * len(nv) and (nm["mlen"][:, 1:] == 2).all()
        assert (s["far_jumps"]["choice_len"] > 4 * 32).mean() > 0.5
        assert (s["mixed"]["mlen"] > N).any() and (s["mixed"]["choice_len"] > N).any()
        lit = s["mixed"]["choice_len"] <= 1
        assert (s["mixed"]["delta"][lit] <= 0).any() and (s["mixed"]["delta"][lit] > 0).any()
        cand = s["mixed"]["choice_cand"]
        assert ((cand < 0) | (cand >= 3)).any()


def test_default_cost_row_is_cached(monkeypatch):
    """dp_parse's default path reads one cost row made once per device;
    default_dp_costs() still gives a fresh tensor with the same values."""
    made = []
    make = tenc.default_dp_costs
    monkeypatch.setattr(tenc, "_default_rows", {})
    monkeypatch.setattr(tenc, "default_dp_costs", lambda device="cpu": made.append(1) or
                        make(device))
    f = fuzz_opt(7, B=4, N=64)
    args = (_t(f["delta"]), _t(f["mlen"]), _t(f["n_valid"]))
    first, second = tenc.dp_parse(*args), tenc.dp_parse(*args)
    assert len(made) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    row = tenc._default_costs_on("cpu")
    assert row is tenc._default_costs_on(torch.device("cpu")) and len(made) == 1
    assert row.tolist() == list(tenc._DP_COSTS) == make().tolist()
    assert make() is not make() and make().data_ptr() != row.data_ptr()
    want = jenc.dp_parse(*(jnp.asarray(f[k]) for k in ("delta", "mlen", "n_valid")))
    _assert_all_equal(want, (o.numpy() for o in first))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_cover_kernels_match_ref_on_fuzz_cover(sets, cuda, pattern):
    f = sets[0][pattern]
    T = f["num_steps"]
    g = tuple(_t(a).to(cuda) for a in _greedy_args(f))
    _assert_all_equal((o.cpu() for o in tenc.greedy_cover_ref(*g, T)),
                      (o.cpu() for o in tenc.greedy_cover(*g, T)))
    d = tuple(_t(a).to(cuda) for a in _dp_args(f))
    _assert_all_equal((o.cpu() for o in tenc.dp_cover_ref(*d, T)),
                      (o.cpu() for o in tenc.dp_cover(*d, T)))
