"""Port row primitives (nlzm_tpu_torch.ops.sort_gather) against all six
JAX gather-via-sort functions, exact, at random widths within each one's
packing budget."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.ops import sort_gather as jsg
from nlzm_tpu_torch.ops.sort_gather import compact_by_rank, gather_rows

torch.set_num_threads(1)

# name -> (max row width, payload bits) of the JAX function's budget
GATHERS = {
    "gather_sorted": (jsg.PACK_MAX, 15),
    "gather_sorted16": (jsg.PACK_MAX, 16),
    "gather_sorted2": (1 << 31, 30),
}
COMPACTS = {
    "compact_by_rank": (jsg.PACK_MAX, 15),
    "compact_by_rank16": (jsg.PACK_MAX, 16),
    "compact_by_rank2": (1 << 31, 30),
}


@pytest.mark.parametrize("name", sorted(GATHERS))
def test_gather_rows_matches_jax(name):
    max_w, bits = GATHERS[name]
    rng = np.random.default_rng(len(name) * 7919 + bits)
    # packed variants: a narrow row, a mid one, and one at the packed
    # budget; the 2-operand variant (slow to compile on the CPU) only past it
    widths = (int(rng.integers(1, 64)), int(rng.integers(1000, 6000)), jsg.PACK_MAX)
    if max_w > jsg.PACK_MAX:
        widths = (jsg.PACK_MAX + 1000,)
    for N in widths:
        Q = int(rng.integers(1, min(N, 2000) + 1))
        B = 2
        src = rng.integers(0, 1 << bits, (B, N)).astype(np.int32)
        # in-range queries plus a few past the end (both sides clamp to N - 1)
        hi = min(N + 8, max_w)
        idx = rng.integers(0, hi, (B, Q)).astype(np.int32)
        want = np.asarray(getattr(jsg, name)(jnp.asarray(src), jnp.asarray(idx)))
        got = gather_rows(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(COMPACTS))
def test_compact_by_rank_matches_jax(name):
    max_w, bits = COMPACTS[name]
    rng = np.random.default_rng(len(name) * 104729 + bits)
    for K in (int(rng.integers(1, 64)), int(rng.integers(1000, 6000)),
              min(max_w, jsg.PACK_MAX + 1000)):
        B = 3
        vals = rng.integers(0, 1 << bits, (B, K)).astype(np.int32)
        pred = rng.random((B, K)) < rng.random()
        rank = (np.cumsum(pred, axis=1) - pred).astype(np.int32)
        out_w = int(rng.integers(1, K + 1))
        want = np.asarray(getattr(jsg, name)(
            jnp.asarray(vals), jnp.asarray(rank), jnp.asarray(pred), out_w))
        got = compact_by_rank(
            torch.from_numpy(vals), torch.from_numpy(rank), torch.from_numpy(pred), out_w
        ).numpy()
        np.testing.assert_array_equal(got, want)
        for b in range(B):  # zero tail past each row's count
            assert (got[b, int(pred[b].sum()):] == 0).all()
