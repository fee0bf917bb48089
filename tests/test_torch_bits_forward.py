"""bits_forward (nlzm_tpu_torch.ops.encode_ops) against JAX's bits_forward,
exact, on every chip_smoke.fuzz_bits class (nb below 0 and above 24;
24-bit fields crossing words and runs; all-zero blocks; caps 1, 3, 37,
just under and just over the section, and the largest the wrapper takes;
B = 1, 7, 9 and 1023), for two seeds: the plain version, and
chip_smoke.bits_model, the numpy model of csrc/bits_forward.cu's scheme
(runs of steps, whole words stored, shared words ORed, the row copied out
in 16-byte chunks). Also the model's constants against the kernel source,
the largest cap against the wrapper's limit and a card-only
kernel-vs-plain case."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.ops import encode_ops as jeo
from nlzm_tpu_torch.ops import encode_ops as teo

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = tuple(cs.fuzz_bits(0))
KERNEL_SRC = Path(teo.__file__).resolve().parent.parent / "csrc" / "bits_forward.cu"


@functools.cache
def _set(seed):
    return cs.fuzz_bits(seed)


@functools.cache
def _jax(seed, pattern):
    fields, cap = _set(seed)[pattern]
    out, n = jeo.bits_forward(tuple(jnp.asarray(f) for f in fields), cap)
    return np.asarray(out), np.asarray(n)


def _torch(fields, device="cpu"):
    return tuple(torch.from_numpy(f).to(device) for f in fields)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_ref_matches_jax(seed, pattern):
    fields, cap = _set(seed)[pattern]
    out, n = teo.bits_forward(_torch(fields), cap)
    j_out, j_n = _jax(seed, pattern)
    assert out.dtype == torch.uint8 and n.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(n.numpy(), j_n)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_model_matches_jax(seed, pattern):
    out, n = cs.bits_model(*_set(seed)[pattern])
    j_out, j_n = _jax(seed, pattern)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(n, j_n)


def test_bits_model_shares_only_edge_words():
    """A run ORs at most its first and its last word; every other word it
    stores (the model fails on a stored word that another run writes)."""
    fields, cap = _set(0)["straddle"]
    st = {}
    cs.bits_model(fields, cap, stats=st)
    B = fields[0].shape[1]
    runs = B * -(-fields[0].shape[0] // cs.BITS_R)
    assert st["ors"] <= 2 * runs < st["stores"]


def test_bits_constants_match_kernel():
    src = KERNEL_SRC.read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;/]+);", src).group(1).strip()
    assert int(const("NT")) == cs.BITS_NT
    assert int(const("R")) == cs.BITS_R
    assert const("SMEM_MAX") == "224 * 1024" and cs.BITS_SMEM_MAX == 224 * 1024


@pytest.mark.parametrize("B, cap, G", [
    (1024, 8448, 8), (1023, 8448, 8), (512, 8448, 4), (256, 8448, 4), (128, 8448, 2),
    (64, 8448, 2), (63, 8448, 2), (62, 8448, 1), (32, 8448, 1), (8, 8448, 1), (1, 8448, 1),
    (501, 23162, 4), (1023, 45719, 4), (3, cs.BITS_CAP_MAX, 1)])
def test_bits_group_rule(B, cap, G):
    """bits_group (the kernel's group_of) at the v1 fields' cap: the G
    that timed best of 1, 2, 4, 8 at B = 8 to 1024 on the card; fewer
    where G sections pass the shared memory."""
    assert cs.bits_group(B, cap) == G


def test_bits_group_matches_kernel():
    src = KERNEL_SRC.read_text()
    assert "while (G > 1 && (G * sec > SMEM_MAX || (B + G - 1) / G < 16 * G)) G >>= 1;" in src
    assert "const long long sec = 4LL * section_words(cap);" in src
    assert "int section_words(int cap) { return (((cap + 3) >> 2) + 1) | 1; }" in src


def test_bits_cap_max_is_the_wrappers():
    """BITS_CAP_MAX is the largest cap the wrapper lets through to the
    kernel, and one such section fits the kernel's shared memory."""
    fits = lambda cap: 4 * ((cap + 3) // 4 + 1) <= teo._BITS_SMEM_MAX
    assert fits(cs.BITS_CAP_MAX) and not fits(cs.BITS_CAP_MAX + 1)
    assert 4 * ((((cs.BITS_CAP_MAX + 3) // 4) + 1) | 1) <= cs.BITS_SMEM_MAX


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_bits_kernel_matches_ref_on_fuzz(cuda):
    for seed in SEEDS:
        for fields, cap in _set(seed).values():
            args = _torch(fields, cuda)
            for g, w in zip(teo.bits_forward(args, cap), teo.bits_forward_ref(args, cap)):
                assert torch.equal(g, w)
