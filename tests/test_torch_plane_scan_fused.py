"""plane_scan_fused (nlzm_tpu_torch.ops.wide_decode) against the JAX
function, exact, on the worst cases of csrc/plane_scan.cu
(chip_smoke.fuzz_scan: random seeds and windows, n_sym at 0, 1, L - 1, L,
steps * L and past it, below 0 and at 2^31 - 1, one plane empty, all-zero
seeds, priors none, 0, 65535 and random u16, windows narrower than a
chunk's renorms so that pairs come from the next planes' windows and the
zero padding, windows 4 bytes wide at a time and as wide as the ring's
slot, B = 1, steps 2 to 40): the plain version, and chip_smoke.scan_model,
the numpy model of the kernel's scheme (each plane to its own live steps,
ballot ranks, the ring and JAX's index past it, register fences and the
fence bitmap's search, 8-bit register counts, the rebuild's reciprocal
division). Also the ValueError for priors outside 0..65535, the division
and the fence bitmap on their own, the scheme's constants against the
kernel source, and a card-only kernel-vs-plain case."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.ops import wide_decode as jwd
from nlzm_tpu_torch.ops import wide_decode as twd

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("random", "b1", "edges_low", "edges_high", "one_empty", "dst_empty", "seeds_zero",
            "priors_random", "priors_zero", "priors_max", "narrow", "narrow_odd", "wide",
            "steps2", "steps4", "steps8", "steps16")
KERNEL_SRC = Path(twd.__file__).resolve().parent.parent / "csrc" / "plane_scan.cu"


def _torch_args(sd, wins, ns, steps, pri):
    return (torch.from_numpy(sd.view(np.int32).copy()), tuple(torch.from_numpy(w) for w in wins),
            torch.from_numpy(ns), steps, None if pri is None else tuple(
                torch.from_numpy(a) for a in pri))


def _jax(sd, wins, ns, steps, pri):
    ys = jwd.plane_scan_fused(jnp.asarray(sd), tuple(jnp.asarray(w) for w in wins),
                              jnp.asarray(ns), steps,
                              None if pri is None else tuple(jnp.asarray(a) for a in pri))
    return tuple(np.asarray(a) for a in ys)


def _equal(got, want):
    assert len(got) == len(want) == 5
    for p, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.int32 and g.shape == w.shape, p
        np.testing.assert_array_equal(g, w, err_msg=f"wire plane {p}")


@pytest.fixture(scope="module")
def sets():
    """seed -> pattern -> (input, JAX's five symbol arrays)."""
    out = {}
    for seed in SEEDS:
        fz = cs.fuzz_scan(seed)
        assert tuple(fz) == PATTERNS
        out[seed] = {pat: (args, _jax(*args)) for pat, args in fz.items()}
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_plane_scan_fused_ref_fuzz_scan_matches_jax(sets, seed, pattern):
    args, want = sets[seed][pattern]
    _equal(twd.plane_scan_fused_ref(*_torch_args(*args)), want)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_scan_model_fuzz_scan_matches_jax(sets, seed, pattern):
    args, want = sets[seed][pattern]
    _equal(cs.scan_model(*args), want)


def test_fuzz_scan_holds_every_case(sets):
    """The patterns reach what they are named for: pairs past every
    plane's window (dst's into the zero padding), every plane empty and
    cut inside a step, searches in bitmap words of more than one fence."""
    stats = {}
    for pat in ("narrow", "narrow_odd", "edges_low", "edges_high", "priors_zero", "wide"):
        stats[pat] = {}
        cs.scan_model(*sets[0][pat][0], stats=stats[pat])
    for pat in ("narrow", "narrow_odd"):
        assert all(stats[pat][p]["jax_index"] > 0 for p in range(5)), pat
    assert stats["narrow"][4]["padding"] > 0  # dst, the last of the wire order
    assert all(st["jax_index"] == 0 for st in stats["wide"].values())
    for p, L in enumerate(cs.PS_WIRE_LANES):
        assert stats["edges_low"][p]["live"] == [0, 1, 1, 1]
        assert stats["edges_high"][p]["live"] == [40, 40, 0, 40]
    assert all(stats["priors_zero"][p]["dense"] > 0 for p in (1, 3, 4))


@pytest.mark.parametrize("value", [-1, 1 << 16])
@pytest.mark.parametrize("fn", ["plane_scan_fused", "plane_scan_fused_ref"])
def test_priors_outside_u16_raise(fn, value):
    sd, wins, ns, steps, pri = cs.fuzz_scan(0, ["steps2"])["steps2"]
    pri = tuple(a.copy() for a in pri)
    pri[3][7] = value  # one lex entry
    with pytest.raises(ValueError, match="0..65535"):
        getattr(twd, fn)(*_torch_args(sd, wins, ns, steps, pri))


def test_main_path_entry_skips_the_prior_check():
    """decode_wide_staged's entry takes the container's u16 priors as they
    are, without the check's copy back."""
    sd, wins, ns, steps, pri = cs.fuzz_scan(0, ["steps2"])["steps2"]
    args = _torch_args(sd, wins, ns, steps, pri)
    _equal(twd._plane_scan_fused(*args), tuple(a.numpy() for a in twd.plane_scan_fused(*args)))
    pri = tuple(a.copy() for a in pri)
    pri[0][0] = -1
    twd._plane_scan_fused(*_torch_args(sd, wins, ns, steps, pri))


def test_slot_priors_follow_the_kernel_slots():
    """The priors the main path stages once are the wire-order tensors laid
    out in slot order, each at its slot's first entry."""
    pri = cs.fuzz_scan(0, ["priors_random"])["priors_random"][4]
    flat = twd.slot_priors(tuple(torch.as_tensor(a) for a in pri))
    assert flat.dtype == torch.int32 and twd.slot_priors(None) is None
    starts = np.cumsum((0,) + twd.SLOT_ALPH)
    for q, p in enumerate(twd.SLOT_PLANE):
        np.testing.assert_array_equal(flat[starts[q]:starts[q + 1]].numpy(), pri[p])


def test_ps_quot_is_floor_division():
    rng = np.random.default_rng(3)
    d = np.concatenate([[1, 2, 3, 65536, 256 * 65535 + 1],
                        rng.integers(1, 256 * 65535 + 2, 20000)])
    n = np.concatenate([[0, (1 << 31) - 1, 65535 * 16380, 65535 * 16380, 65535 * 16380],
                        rng.integers(0, 1 << 30, 20000)])
    k = n // d
    for nn in (n, k * d, np.maximum(k * d - 1, 0), np.minimum(k * d + d - 1, (1 << 31) - 1)):
        np.testing.assert_array_equal(cs.ps_quot(nn, d), nn // d)


@pytest.mark.parametrize("A", [64, 256])
def test_ps_bitmap_counts_every_symbol(A):
    """For every f, the count before f's word plus the word's bits up to f
    is the symbol searchsorted finds: uniform, dense (all-zero carries) and
    random tables."""
    rng = np.random.default_rng(A)
    car = np.concatenate([np.zeros((1, A), np.int64), rng.integers(0, 1 << 16, (3, A)),
                          np.where(rng.random((2, A)) < 0.9, 0, 60000)])
    fen = cs.ps_fences(car, A)
    count, bits = cs.ps_bitmap(fen, A)
    f = np.arange(cs.PS_CDF)
    mask = (np.uint64(2) << (f & 31).astype(np.uint64)) - np.uint64(1)
    for b in range(len(car)):
        want = np.searchsorted(fen[b, 1:A], f, side="right")
        np.testing.assert_array_equal(count[b, f >> 5] + cs.ps_popc(bits[b, f >> 5] & mask), want)


def test_scan_scheme_matches_kernel_source():
    src = KERNEL_SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("RING") == cs.PS_RING
    assert const("MAX_CLEN") == cs.PS_MAX_CLEN
    lanes = re.search(r"WIRE_LANES\[NP\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in lanes.split(",")) == cs.PS_WIRE_LANES
    slots = re.findall(r"struct Slot<(\d)> \{ static constexpr int L = (\d+), A = (\d+), "
                       r"P = (\d+), LANE0 = (\d+), SYM0 = (\d+);", src)
    assert [(int(L), int(A), int(P)) for _, L, A, P, _, _ in slots] == list(cs.PS_SLOTS)
    assert [int(l0) for *_, l0, _ in slots] == list(twd.SLOT_BASE[:5])
    assert [int(s0) for *_, s0 in slots] == list(np.cumsum((0,) + twd.SLOT_ALPH)[:5])
    assert cs.PS_MAX_CLEN == max(twd.chunk_schedule(1000))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_plane_scan_kernel_matches_ref_on_fuzz(cuda):
    for seed in SEEDS:
        for pat, args in cs.fuzz_scan(seed).items():
            targs = _torch_args(*args)
            dargs = (targs[0].to(cuda), tuple(w.to(cuda) for w in targs[1]), targs[2].to(cuda),
                     targs[3], None if targs[4] is None else tuple(a.to(cuda) for a in targs[4]))
            want = twd.plane_scan_fused_ref(*targs)
            for g, w in zip(twd.plane_scan_fused(*dargs), want):
                assert torch.equal(g.cpu(), w), pat
            staged = twd._plane_scan_fused(*dargs, twd.slot_priors(dargs[4]))
            for g, w in zip(staged, want):
                assert torch.equal(g.cpu(), w), pat
