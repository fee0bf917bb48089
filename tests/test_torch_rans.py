"""rans_backward (nlzm_tpu_torch.ops.encode_ops) against the JAX function,
exact, on the worst cases of csrc/rans_backward.cu (chip_smoke.fuzz_spans:
every slot full, every span at f = 2^14 (each renorms), at f = 1, at f in
(2^14, 2^16) with start 0xFFFF, random u32 spans, spans only in the last
row, empty blocks beside full ones, span counts 1, 2 and 3 mod 4 in
neighbouring blocks, every f from 1 to the span count, T no multiple of
128, T = 1) and on the spans JAX's emit_model gives for two corpus samples,
at the frame cap and at caps that cut the pairs and the seeds (101, 37, 17,
16, 1): the plain version and chip_smoke.rans_model, the numpy model of the
kernel's scheme (backward tiles, per-span records, the reciprocal
division). Also chip_smoke.recip_div, the kernel's division, against floor
division for every f in 1..65535 on the boundary quotients, its magic
against ceil(2^48 / f), and card-only kernel-vs-plain cases."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import RANS_R, fuzz_spans, rans_frame_cap, rans_magic, rans_model, recip_div
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu_torch.ops import encode_ops as tenc

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("dense", "f14", "f1", "wide_f", "random", "last_row", "empty_full", "mod4",
            "every_f", "ragged", "one_row")
CAPS = ("frame", 101, 37, 17, 16, 1)
SAMPLES = ("text", "random")
N4K = 4096
FUZZ = dict(T=320, B=8)  # 60 KiB of spans; three tiles of R rows, the last one partial
F_CHUNK = 8192


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


def _cap(cap, spans) -> int:
    return rans_frame_cap(spans.shape[0]) if cap == "frame" else cap


def _hold(spans, cap: int):
    """The plain version and the model against JAX, at one cap."""
    js, jn = jenc.rans_backward(jnp.asarray(spans.view(np.uint32)), cap)
    js, jn = np.asarray(js), np.asarray(jn)
    ts, tn = tenc.rans_backward(_t(spans), cap)
    assert ts.dtype == torch.uint8 and tn.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tn.numpy(), jn)
    ms, mn = rans_model(spans, cap)
    np.testing.assert_array_equal(ms, js)
    np.testing.assert_array_equal(mn, jn)
    return jn


@pytest.fixture(scope="module")
def sets():
    return {seed: fuzz_spans(seed, **FUZZ) for seed in SEEDS}


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_rans_fuzz_spans_match_jax(sets, seed, pattern, cap):
    spans = sets[seed][pattern]
    _hold(spans, _cap(cap, spans))


@pytest.fixture(scope="module")
def corpus_spans(corpus_samples):
    """sample -> JAX emit_model's spans (int32 bits) of its greedy commands
    at 4 KiB blocks."""
    out = {}
    for name in SAMPLES:
        arr, nv = jenc._blocks_arrays(corpus_samples[name], N4K)
        dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
        op_len, op_val = jenc.greedy_cover(dj, *jenc.find_matches(dj, nvj, N4K - 1), nvj, N4K)
        spans = jenc.emit_model(op_len, op_val, jenc.repify(op_len, op_val))[0]
        out[name] = np.asarray(spans).view(np.int32)
    return out


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", SAMPLES)
def test_rans_corpus_spans_match_jax(corpus_spans, name, cap):
    spans = corpus_spans[name]
    assert (spans != 0).sum() > 1000
    _hold(spans, _cap(cap, spans))


def test_f14_renorms_every_span(sets):
    """At f = 2^14 the threshold wraps to 0: every span emits a pair."""
    for seed in SEEDS:
        spans = sets[seed]["f14"]
        n = _hold(spans, _cap("frame", spans))
        np.testing.assert_array_equal(n, 16 + 2 * (spans != 0).sum(axis=(0, 2)))


@pytest.mark.parametrize("lo", range(1, 1 << 16, F_CHUNK))
def test_recip_div_is_floor_division(lo):
    """recip_div against x1 // f for every f of the chunk: x1 = 0, 1, f - 1,
    f, f + 1, the largest multiple of f below 2^32 and its neighbours,
    2^32 - 1, and 200 seeded random u32 values."""
    f = np.arange(lo, min(lo + F_CHUNK, 1 << 16), dtype=np.uint64)[:, None]
    top = (np.uint64(0xFFFFFFFF) // f) * f
    rnd = np.random.default_rng(lo).integers(0, 1 << 32, (1, 200), dtype=np.uint64)
    x1 = np.concatenate([np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1, top - 1, top,
                         np.minimum(top + 1, 0xFFFFFFFF), np.full_like(f, 0xFFFFFFFF),
                         np.broadcast_to(rnd, (f.shape[0], 200))], axis=1)
    np.testing.assert_array_equal(recip_div(x1, f), x1 // f)


def test_rans_magic_is_ceil():
    """The kernel's magic is ceil(2^48 / f) << 16 mod 2^64, 0 at f = 1."""
    f = np.arange(1, 1 << 16)
    hi, lo = rans_magic(f)
    got = [(int(h) << 32) | int(l) for h, l in zip(hi, lo)]
    want = [0 if v == 1 else (-(-(1 << 48) // int(v)) << 16) % (1 << 64) for v in f]
    assert got == want


def test_rans_scheme_matches_kernel_source():
    """RANS_R, which rans_model tiles by, is the kernel's default R."""
    src = (Path(tenc.__file__).resolve().parents[1] / "csrc" / "rans_backward.cu").read_text()
    assert int(re.search(r"constexpr int R = (\d+);", src)[1]) == RANS_R


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_spans_holds_every_case(sets, seed):
    """Every pattern is what its name says."""
    T, B = FUZZ["T"], FUZZ["B"]
    s = {k: v.view(np.uint32).astype(np.int64) for k, v in sets[seed].items()}
    for name in PATTERNS:
        want = {"ragged": (T - 37, B - 3), "one_row": (1, B - 1)}.get(name, (T, B))
        assert sets[seed][name].shape == (*want, 6) and sets[seed][name].dtype == np.int32
        assert sets[seed][name].flags.c_contiguous
    freq, start = {k: v >> 16 for k, v in s.items()}, {k: v & 0xFFFF for k, v in s.items()}
    assert (s["dense"] != 0).all() and (s["every_f"] != 0).all()
    live = s["f14"] != 0
    assert (freq["f14"][live] == 1 << 14).all() and 0.4 < live.mean() < 0.6
    live = s["f1"] != 0
    assert (freq["f1"][live] <= 1).all() and (freq["f1"][live] == 0).any()
    w = freq["wide_f"]
    assert ((w > 1 << 14) & (w < 1 << 16)).all() and (start["wide_f"] == 0xFFFF).all()
    assert (w == 65535).any() and (w == 1 << 15).any()
    r = s["random"]
    assert 0.25 < (r == 0).mean() < 0.42 and (freq["random"] >= 1 << 14).any()
    assert (s["last_row"][:-1] == 0).all() and (s["last_row"][-1] != 0).any(axis=1).all()
    e = (s["empty_full"] != 0).all(axis=(0, 2))
    assert not e[::2].any() and e[1::2].all() and (s["empty_full"][:, ::2] == 0).all()
    k = (s["mod4"] != 0).sum(axis=(0, 2))
    np.testing.assert_array_equal(k % 4, np.arange(B) % 4)
    assert len(np.unique(freq["every_f"])) == min(T * B * 6, 65535)
    assert s["ragged"].shape[0] % 128 and s["ragged"].shape[0] % RANS_R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_rans_backward_kernel_matches_ref_on_fuzz_spans(sets, cuda, pattern):
    spans = _t(sets[0][pattern]).to(cuda)
    for cap in (rans_frame_cap(spans.shape[0]), 101, 37, 16, 1):
        for g, w in zip(tenc.rans_backward(spans, cap), tenc.rans_backward_ref(spans, cap)):
            assert torch.equal(g, w)
