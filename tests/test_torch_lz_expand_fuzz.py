"""lz_expand_parallel (nlzm_tpu_torch.ops.expand_ops) against the JAX
lz_expand_parallel, exact, on the worst cases of csrc/lz_expand.cu
(chip_smoke.fuzz_expand: the draw at N = 4096 without a dictionary and at
the shipping shape, 32 KiB blocks with a 32 KiB dictionary; the four fault
classes where JAX's packed words leave their packing, distances 2^17 and
-3, a literal's op_val 40,000 and 8 KiB matches past the block's end; B =
1, one literal and a match of N - 1, distances past the dictionary,
chains ~N / 8 deep, zero distances, padding slots in the middle, lengths
whose sum passes N, 2^31 and 2^32), at round hints None, 0, 1 and the
chain depth's, for two seeds: the plain version, and chip_smoke.
expand_model, the numpy model of the kernel's scheme (per-position
parents from a max-scan of the start marks, u16 parents, synchronous
rounds that stop after one that changes nothing, the byte pass with the
packed path's cap and corner and the refill of unresolved parents, the
packing check and, for a flagged block, JAX's sorts word for word). Also
T = 0 (JAX raises there) between the two, the packing check on its own,
the scheme's constants against the kernel source, and a card-only
kernel-vs-plain case."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.ops.expand_ops import lz_expand_parallel as jax_expand
from nlzm_tpu_torch.ops import expand_ops as xo

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = tuple(p for p in cs.fuzz_expand(0) if p != "t0")
FAULTS = ("delta_big", "delta_neg", "lit_big", "past_end")
HINTS = ("none", "0", "1", "depth")
KERNEL_SRC = Path(xo.__file__).resolve().parent.parent / "csrc" / "lz_expand.cu"


@pytest.fixture(scope="module")
def sets():
    """seed -> pattern -> (op_len, op_val, N, dict or None, depth hint)."""
    out = {}
    for seed in SEEDS:
        out[seed] = {}
        for pat, (ol, ov, N, d) in cs.fuzz_expand(seed).items():
            st = {}
            cs.expand_model(ol, ov, N, None, d, st)
            depth = max([r for r in st["rounds"] if r is not None] or [0])
            out[seed][pat] = (ol, ov, N, d, depth)
    return out


def _hint(h, depth):
    return {"none": None, "0": 0, "1": 1, "depth": depth}[h]


@pytest.mark.parametrize("hint", HINTS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_lz_expand_fuzz_matches_jax(sets, seed, pattern, hint):
    ol, ov, N, d, depth = sets[seed][pattern]
    h = _hint(hint, depth)
    j_out, j_prod = jax_expand(jnp.asarray(ol), jnp.asarray(ov), N, h,
                               None if d is None else jnp.asarray(d))
    j_out, j_prod = np.asarray(j_out), np.asarray(j_prod)
    t_out, t_prod = xo.lz_expand_parallel(torch.from_numpy(ol), torch.from_numpy(ov), N, h,
                                          None if d is None else torch.from_numpy(d))
    assert t_out.dtype == torch.uint8 and t_prod.dtype == torch.int32
    np.testing.assert_array_equal(t_out.numpy(), j_out, err_msg="plain version")
    np.testing.assert_array_equal(t_prod.numpy(), j_prod)
    m_out, m_prod = cs.expand_model(ol, ov, N, h, d)
    np.testing.assert_array_equal(m_out, j_out, err_msg="expand_model")
    np.testing.assert_array_equal(m_prod, j_prod)


@pytest.mark.parametrize("hint", HINTS)
def test_lz_expand_no_commands(hint):
    """T = 0: nothing produced, every byte 0, in both."""
    ol, ov, N, d = cs.fuzz_expand(0, ["t0"])["t0"]
    h = _hint(hint, 0)
    t_out, t_prod = xo.lz_expand_parallel(torch.from_numpy(ol), torch.from_numpy(ov), N, h, d)
    m_out, m_prod = cs.expand_model(ol, ov, N, h, d)
    assert t_out.shape == (3, N) and not t_out.any() and not t_prod.any()
    np.testing.assert_array_equal(t_out.numpy(), m_out)
    np.testing.assert_array_equal(t_prod.numpy(), m_prod)


@pytest.mark.parametrize("seed", SEEDS)
def test_lz_expand_packing_check(sets, seed):
    """The kernel's trigger for JAX's word-for-word sorts: every block of a
    fault class at both shapes, and no block of a draw inside the packing,
    nor any block off the packed path (the 2-operand path: 128 KiB)."""
    for pat, (ol, ov, N, d, _) in sets[seed].items():
        st = {}
        cs.expand_model(ol, ov, N, None, d, st)
        fault = pat.rsplit("_", 1)[0] in FAULTS or pat == "past_2_31"
        if pat == "t0":
            continue
        assert st["flagged"] == [fault] * ol.shape[1], pat
    ol, ov, _, _ = cs.fuzz_expand(seed, ["delta_neg_4k"])["delta_neg_4k"]
    st = {}
    cs.expand_model(ol, ov, 1 << 17, None, None, st)
    assert not any(st["flagged"])


def test_lz_expand_constants_match_kernel_source():
    """The wrapper's scratch layout (scratch_words) reads the kernel's
    constants: the mask size past which the masks go to device memory,
    the blocks and the tile up to which it reads [T, B] as it is, and the
    packed path's bounds."""
    src = KERNEL_SRC.read_text()
    vals = {}
    for name in ("NT", "CPT", "TILE", "DIRECT_B", "MASK_SMEM"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        vals[name] = eval(expr, {"__builtins__": {}}, dict(vals))
    assert (vals["MASK_SMEM"], vals["DIRECT_B"], vals["TILE"]) == (
        xo._MASK_SMEM, xo._DIRECT_B, xo._TILE)
    assert "N <= 32768 && D + N <= 65536" in src
    assert xo.packed_path(32768, 32768) and not xo.packed_path(32768, 32769)
    assert not xo.packed_path(65536, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_lz_expand_kernel_matches_ref_on_fuzz(sets, cuda):
    for seed in SEEDS:
        for pat, (ol, ov, N, d, depth) in sets[seed].items():
            args = (torch.from_numpy(ol).to(cuda), torch.from_numpy(ov).to(cuda), N)
            dd = None if d is None else torch.from_numpy(d).to(cuda)
            for h in (None, 0, 1, depth):
                k_out, k_prod = xo.lz_expand_parallel(*args, h, dd)
                r_out, r_prod = xo.lz_expand_parallel_ref(*args, h, dd)
                assert torch.equal(k_out, r_out) and torch.equal(k_prod, r_prod), (seed, pat, h)
