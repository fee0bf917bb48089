"""stage_windows_fused (nlzm_tpu_torch.ops.wide_decode) against JAX's
stage_windows_fused, exact, on every chip_smoke.fuzz_windows class
(offsets below 0, past H, decreasing and wrapping past 2^31; ends below
the last chunk's offset; pair counts past the window; B = NC = H = 1;
widths and plane bases off 16 bytes; chunk counts that leave a CTA's
warps idle; H past 2^15, where JAX's packed gather asserts and the test
runs its 2-operand path), for two seeds: the plain version, and
chip_smoke.windows_model, the numpy model of csrc/stage_windows.cu's
scheme. Also the model's constants against the kernel source and a
card-only kernel-vs-plain case."""

import functools
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
PATTERNS = tuple(cs.fuzz_windows(0))
KERNEL_SRC = Path(twd.__file__).resolve().parent.parent / "csrc" / "stage_windows.cu"
PACK = 1 << 15  # JAX's packed gather: H and NC x sum(WHs) up to 2^15


@functools.cache
def _set(seed):
    return cs.fuzz_windows(seed)


@functools.cache
def _jax(seed, pattern):
    hw, offs, ends, WHs = _set(seed)[pattern]
    big = hw.shape[1] > PACK or offs.shape[2] * sum(WHs) > PACK
    wins = jwd.stage_windows_fused(jnp.asarray(hw), jnp.asarray(offs), jnp.asarray(ends), WHs,
                                   (0,) * len(WHs), big)
    return tuple(np.asarray(w) for w in wins)


def _torch(a, device="cpu"):
    hw, offs, ends, WHs = a
    return (torch.from_numpy(hw.view(np.int16)).to(device), torch.from_numpy(offs).to(device),
            torch.from_numpy(ends).to(device), WHs)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_stage_windows_ref_matches_jax(seed, pattern):
    got = twd.stage_windows_fused(*_torch(_set(seed)[pattern]))
    want = _jax(seed, pattern)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_windows_model_matches_jax(seed, pattern):
    for g, w in zip(cs.windows_model(*_set(seed)[pattern]), _jax(seed, pattern)):
        np.testing.assert_array_equal(g, w)


def test_windows_model_units():
    """16-byte units wherever a plane's width and base allow them: every
    plane at the shipping widths, none where the widths are odd, and from
    the first odd base on where a width breaks the alignment."""
    for pattern, widths in (("valid", [4] * 5), ("widths_odd", [1] * 5),
                            ("bases_odd", [4, 1, 1, 1, 1])):
        st = {}
        cs.windows_model(*_set(0)[pattern], stats=st)
        assert st["widths"] == widths, pattern
    hw, offs, ends, _ = _set(0)["valid"]
    st = {}
    cs.windows_model(hw, np.zeros((5, 5, 1), np.int32), ends, cs.PS_WH_SHIP, stats=st)
    assert st["units"] == sum(cs.PS_WH_SHIP) // 4 == st["wide_units"]


def test_windows_constants_match_kernel():
    src = KERNEL_SRC.read_text()
    assert int(re.search(r"constexpr int MAX_WARPS = (\d+);", src).group(1)) == cs.SW_MAX_WARPS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_stage_windows_kernel_matches_ref_on_fuzz(cuda):
    for seed in SEEDS:
        for a in _set(seed).values():
            args = _torch(a, cuda)
            for g, w in zip(twd.stage_windows_fused(*args), twd.stage_windows_fused_ref(*args)):
                assert torch.equal(g, w)
