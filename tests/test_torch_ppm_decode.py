"""The NLZC block decode (nlzm_tpu_torch.research.ppm_tpu._decode_blocks)
against the JAX function, exact, on the worst cases of csrc/ppm_decode.cu
(chip_smoke.fuzz_ppm: real streams under the text's prior, an all-0 and an
all-255 prior, random and all-zero words, segments past steps and ragged
ones, the zeros and repetitive containers, a block under 32 bytes, the
smallest schedules, streams cut to 40 words, a truncated container): the
plain version, and chip_smoke.ppm_model, the numpy model of the kernel's
scheme (stamps and deferred shifts, rows built on demand, the row cache,
the fold of read rows only) with its cache at full size and at 8 rows.
Also the prior's domain (0..255, else ValueError in both versions), the
kernel's exact 32-bit division, the rows the model builds against the
bound's count, the scheme's constants against the kernel source, and
card-only kernel-vs-plain cases."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.research import ppm_tpu as jp
from nlzm_tpu_torch.research import ppm_tpu as tp

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("text", "random", "zero_words", "long_segs", "ragged_segs", "prior0", "prior255",
            "zeros", "repetitive", "short", "steps2", "steps16", "steps32", "cut40", "truncated")
CACHES = (cs.PPM_CACHE, 8)


# patterns that share a JAX call (one prior a call; random's words fix W)
STACKS = (("random", "text", "zero_words", "ragged_segs", "short", "long_segs", "steps2",
           "steps16", "steps32", "truncated"), ("cut40",), ("prior0",), ("prior255",),
          ("zeros", "repetitive"))


def _jax_stacked(sts):
    """JAX's [B, steps, 32] outputs of staged inputs that share a prior, from
    one call (JAX compiles each call anew): blocks decode independently,
    the schedule of fewer steps is a prefix of a longer one's, and words
    padded with zeros read as before where the last word already is zero
    (the clamped window reads a zero either way)."""
    W = max(st[0].shape[1] for st in sts)
    steps = max(st[3] for st in sts)
    for st in sts:
        assert np.array_equal(st[2], sts[0][2])
        assert st[0].shape[1] == W or not st[0][:, -1].any()
    words = np.concatenate([np.pad(st[0], ((0, 0), (0, W - st[0].shape[1]))) for st in sts])
    seg = np.concatenate([st[1] for st in sts])
    out = np.asarray(jp._decode_blocks(jnp.asarray(words.view(np.uint32)), jnp.asarray(seg),
                                       jnp.asarray(sts[0][2]), steps))
    ends = np.cumsum([st[0].shape[0] for st in sts])
    return [o[:, : st[3]] for o, st in zip(np.split(out, ends[:-1]), sts)]


def _torch(st):
    return tuple(torch.from_numpy(a) for a in st[:3]) + (st[3],)


@pytest.fixture(scope="module")
def sets():
    """seed -> pattern -> (staged arrays, JAX's [B, steps, 32] output)."""
    out = {}
    for seed in SEEDS:
        fz = cs.fuzz_ppm(seed)
        assert sorted(sum(STACKS, ())) == sorted(fz)
        out[seed] = {}
        for names in STACKS:
            for pat, want in zip(names, _jax_stacked([fz[p] for p in names])):
                out[seed][pat] = fz[pat], want
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_decode_blocks_ref_fuzz_matches_jax(sets, seed, pattern):
    st, want = sets[seed][pattern]
    got = tp._decode_blocks_ref(*_torch(st))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_ppm_model_fuzz_matches_jax(sets, seed, pattern, cache):
    st, want = sets[seed][pattern]
    stats = {}
    np.testing.assert_array_equal(cs.ppm_model(*st, cache_rows=cache, stats=stats), want)
    if cache == 8 and stats["rows"] > 8 * 16:
        assert stats["spilled"] > 0  # the slots past the cache were read


def test_fuzz_ppm_holds_every_case(sets):
    s = {p: st for p, (st, _) in sets[0].items()}
    assert set(s) == set(PATTERNS)
    text = s["text"]
    for p in ("random", "zero_words", "ragged_segs", "cut40"):
        assert np.array_equal(s[p][2], text[2]) and s[p][3] == text[3]
    assert not s["zero_words"][0].any() and s["random"][0].shape == text[0].shape
    assert text[2].max() > 0 and not s["prior0"][2].any() and (s["prior255"][2] == 255).all()
    assert (s["long_segs"][1] >= s["long_segs"][3]).all()
    assert s["long_segs"][0].shape[0] == 3 and s["short"][0].shape[0] == 3
    assert (s["short"][1][2] == 0).sum() > 0 and (s["short"][1][2] == 1).sum() == 20
    assert not s["zeros"][2].any() and not s["repetitive"][2].any()
    assert s["ragged_segs"][1].min() < 0 and s["ragged_segs"][1].max() > text[3]
    assert [s[f"steps{n}"][3] for n in (2, 16, 32)] == [2, 16, 32]
    assert s["zeros"][0].shape[0] == 2 and s["zeros"][1][1].sum() < s["zeros"][1][0].sum()
    assert s["cut40"][0].shape[1] == 40 and s["cut40"][0][:, 39].any()
    assert s["truncated"][0].shape[0] == text[0].shape[0]
    assert not np.array_equal(s["truncated"][0][-1], text[0][-1][: s["truncated"][0].shape[1]])
    # every row of both tables is read on random words, and the full cache spills
    stats = {}
    cs.ppm_model(*s["random"], stats=stats)
    assert stats["spilled"] > 0


@pytest.mark.parametrize("value", [0, 255])
def test_prior_extremes_match_jax(sets, value):
    st, want = sets[0][f"prior{value}"]
    assert (st[2] == value).all()
    got = tp._decode_blocks(*_torch(st))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("value", [-1, 256])
@pytest.mark.parametrize("fn", ["_decode_blocks", "_decode_blocks_ref", "_decode_blocks_cuda"])
def test_prior_outside_u8_raises(sets, fn, value):
    st = sets[0]["steps2"][0]
    pr = st[2].copy()
    pr[1, 4095, 15] = value
    with pytest.raises(ValueError, match="0..255"):
        getattr(tp, fn)(*_torch((st[0], st[1], pr, st[3])))


@pytest.mark.parametrize("steps", [3, 17, 40])
def test_steps_off_the_schedule_raise(sets, steps):
    """The kernel writes every step of chunk_schedule(steps): a step count
    that is no sum of it is refused before any launch (JAX's reshape and
    the plain version's step index fail on it too)."""
    st = sets[0]["steps2"][0]
    with pytest.raises(ValueError, match="chunk_schedule"):
        tp._decode_blocks_cuda(*_torch((st[0], st[1], st[2], steps)))
    with pytest.raises(IndexError):
        tp._decode_blocks_ref(*_torch((st[0], st[1], st[2], steps)))


def test_model_builds_the_rows_the_bound_counts(sets):
    st, want = sets[1]["text"]
    stats = {}
    cs.ppm_model(*st, stats=stats)
    rows, groups = cs.ppm_rows(_torch(st), torch.from_numpy(want.astype(np.uint8)))
    assert (stats["rows"], stats["groups"]) == (rows, groups)


def test_ppm_quot_is_floor_division():
    """The kernel's float quotient with one correction each way equals
    floor division for every divisor the tables can have (1..34,207) at
    dividends around each multiple of it below 2^26 with a quotient under
    2^14, and on random ones."""
    d = np.arange(1, 34208, dtype=np.int64)
    for q in (0, 1, 2, 3, 7, 100, 1023, 4095, 8191, 16367):
        for off in (-1, 0, 1):
            n = q * d + off
            keep = (n >= 0) & (n < 1 << 26) & (n // d < 1 << 14)
            np.testing.assert_array_equal(cs.ppm_quot(n[keep], d[keep]), n[keep] // d[keep])
    rng = np.random.default_rng(5)
    dd = rng.integers(1, 34208, 1 << 20)
    n = np.minimum(rng.integers(0, 1 << 26, 1 << 20), dd * 16368 - 1)
    np.testing.assert_array_equal(cs.ppm_quot(n, dd), n // dd)


def test_ppm_scheme_matches_kernel_source():
    """PPM_SLOTS, PPM_CACHE and PPM_SW_MAX, which ppm_model and the card's
    report use, and TABLES_INTS, by which the wrapper sizes the scratch,
    are the kernel's: its slots (2 tables x 32 lanes x 16 steps), its
    cache, the stream words left in 113 KiB of shared memory by its
    layout, and its tables ints a block."""
    src = (Path(tp.__file__).resolve().parent.parent / "csrc" / "ppm_decode.cu").read_text()
    num = lambda pat: int(re.search(pat, src)[1])
    assert re.search(r"constexpr int SLOTS = 2 \* LANES \* MAX_CHUNK;", src)
    assert num(r"constexpr int MAX_CHUNK = (\d+);") == tp.CHUNK_STEPS
    assert 2 * tp.LANES * tp.CHUNK_STEPS == cs.PPM_SLOTS
    assert num(r"#define NLZM_PPM_CACHE (\d+)") == cs.PPM_CACHE
    assert re.search(r"TABLES_INTS = SLOTS \* NS / 2 \+ 8;", src)
    assert tp.TABLES_INTS == cs.PPM_SLOTS * 16 // 2 + 8
    layout = [r"OFF_GTAG = OFF_STAMP \+ 4 \* KEYS;", r"OFF_CTRL = OFF_GTAG \+ 4 \* GROUPS;",
              r"OFF_SLOT1 = OFF_CTRL \+ 64;", r"OFF_GSUM = OFF_SLOT1 \+ 2 \* KEYS;",
              r"OFF_SKEY = OFF_GSUM \+ 2 \* KEYS;", r"OFF_LOG = OFF_SKEY \+ 2 \* SLOTS;",
              r"OFF_BKEY = OFF_LOG \+ 2 \* SLOTS;", r"OFF_CACHE = OFF_BKEY \+ 2 \* LANES;",
              r"OFF_WORDS = OFF_CACHE \+ 2 \* NS \* CACHE;",
              r"SMEM_MAX = 113 \* 1024;", r"SW_MAX = \(SMEM_MAX - OFF_WORDS\) / 16 \* 4;"]
    assert all(re.search(p, src) for p in layout)
    keys, groups, slots = 2 * tp.ROWS, 2 * tp.ROWS // tp.GROUP, cs.PPM_SLOTS
    words_at = (4 * keys + 4 * groups + 64 + 2 * keys + 2 * keys + 4 * slots + 2 * tp.LANES
                + 32 * cs.PPM_CACHE)
    assert (113 * 1024 - words_at) // 16 * 4 == cs.PPM_SW_MAX


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_ppm_decode_kernel_matches_ref_on_fuzz(sets, cuda, pattern):
    st, want = sets[0][pattern]
    args = tuple(a.to(cuda) for a in _torch(st)[:3]) + (st[3],)
    got = tp._decode_blocks(*args)
    assert torch.equal(got.cpu(), tp._decode_blocks_ref(*_torch(st)))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
