"""huff_scan (nlzm_tpu_torch.research.huff0) against the JAX function,
exact, on the worst cases of csrc/huff_scan.cu (chip_smoke.fuzz_huff: the
corpus, random bytes under all-8 code lengths, bytes of 64 and of 128
symbols (lengths 6 and 7, chains that rarely merge), one symbol repeated, codes
at the 14-bit limit, all-zero streams, noise rows of 301 bytes, hostile
int32 tables, a truncated payload, a short last block, T no multiple of
32, T = B = S = 1): the plain version and chip_smoke.huff_model, the numpy
model of the kernel's scheme (span maps merged by marks, their
composition, the periodic tail, pages) at K = 32, 256 and 512 and with
pages forced small. Also the port's vectorised encoder (huff0.encode,
_encode_payload) against JAX's bit writer, the maps' exits on random
bytes, on 7-bit data and on the corpus, the scheme's constants against the
kernel source, and card-only kernel-vs-plain cases."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.research import huff0 as jh
from nlzm_tpu_torch.research import huff0 as th
from nlzm_tpu_torch.research import ppm_tpu

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = ("corpus", "random", "uniform64", "uniform128", "repeat", "limit14", "zeros", "noise", "hostile", "truncated",
            "short_last", "ragged", "t1")
FUZZ = dict(B=8, T=4096)  # at most ~33 KB of streams a pattern
KS = (None, 32, 256, 512)  # None: the kernel's rule
PAGE = 2048  # bits a page, small enough to cross several


@pytest.fixture(scope="module")
def sets():
    """seed -> pattern -> (staged arrays, JAX's [B, T] output)."""
    out = {}
    for seed in SEEDS:
        out[seed] = {}
        for pat, st in cs.fuzz_huff(seed, **FUZZ).items():
            B = st[0].shape[0]
            want = jh._huff_scan(*(jnp.asarray(a) for a in st[:5]), jnp.zeros(B, jnp.int32),
                                 st[5])
            out[seed][pat] = st, np.asarray(want).T
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_huff_scan_ref_fuzz_matches_jax(sets, seed, pattern):
    st, want = sets[seed][pattern]
    got = th._huff_scan_ref(*(torch.from_numpy(a) for a in st[:5]), st[5])
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_huff_model_fuzz_matches_jax(sets, seed, pattern, K):
    st, want = sets[seed][pattern]
    np.testing.assert_array_equal(cs.huff_model(*st, K=K), want)
    if K is None:  # at most 4 spans a page a block
        np.testing.assert_array_equal(cs.huff_model(*st, threads=4), want)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_huff_model_pages_match_jax(sets, seed, pattern, K):
    st, want = sets[seed][pattern]
    np.testing.assert_array_equal(cs.huff_model(*st, K=K, page=PAGE, threads=4), want)


def test_fuzz_huff_holds_every_case(sets):
    s = {p: st for p, (st, _) in sets[0].items()}
    B, T = FUZZ["B"], FUZZ["T"]
    assert set(s) == set(PATTERNS)
    assert (s["random"][2][:, 1:8] == 0).all() and (s["random"][2][:, 8:] == 1 << 14).all()
    for k, ln in ((64, 6), (128, 7)):  # mostly one length: chains that rarely merge
        L, _ = cs.huff_decode_table(*s[f"uniform{k}"][1:5])
        assert (L == ln).mean() > 0.8
    assert (s["repeat"][2][:, 1] > 0).all()  # a code of length 1
    assert s["limit14"][2][:, 13].min() < s["limit14"][2][:, 14].max() == 1 << 14
    assert not s["zeros"][0].any()
    for p in ("noise", "hostile"):
        assert s[p][0].shape[1] == 301 and s[p][0][:, 300].any()
    assert len({st[5] for st in s.values()} - {T, T - 37, 1}) == 0
    assert s["ragged"][5] % 32 and s["ragged"][0].shape[0] == B - 3
    assert s["t1"][0].shape == (1, 1) and s["t1"][5] == 1
    assert s["truncated"][0][1].any() and not np.array_equal(s["truncated"][0], s["corpus"][0])
    # the tail: T symbols of at least a bit each pass the end of a 301-byte row
    assert 32 * (-(-301 // 4) - 1) < T


@pytest.mark.parametrize("name", ["text", "random", "repetitive", "zeros", "tiny"])
def test_huff_payload_matches_bit_writer(corpus_samples, name):
    data = corpus_samples[name]
    lengths = jh.code_lengths(np.bincount(np.frombuffer(data, np.uint8), minlength=256))
    assert th._encode_payload(data, lengths) == jh._encode_payload(data, lengths)
    assert th.encode(data, 4096) == jh.encode(data, 4096)


def test_huff_payload_at_the_length_limit():
    fib = [1, 1]
    while len(fib) < 256:
        fib.append(fib[-1] + fib[-2])
    lengths = jh.code_lengths(np.minimum(np.asarray(fib, object), 1 << 40).astype(np.int64))
    assert lengths.max() == 14
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 3000, np.uint8).tobytes()
    assert th._encode_payload(data, lengths) == jh._encode_payload(data, lengths)


def _maps(st, K):
    """huff_maps over the whole stream of staged arrays, spans of K bits."""
    words = cs.huff_words(st[0])
    L, _ = cs.huff_decode_table(*st[1:5])
    E = 32 * (words.shape[1] - 1)
    a = np.arange(0, E - K + 1, K, dtype=np.int64)
    return cs.huff_maps(words, L, a, a + K)


def test_random_spans_have_8_exits(sets):
    st, _ = sets[0]["random"]
    ex, cnt = _maps(st, 256)
    full = (np.arange(ex.shape[1]) + 1) * 256 <= 8 * FUZZ["T"]  # spans inside the data
    assert full.sum() > 100
    assert all(len(set(e)) == 8 for e in ex[:, full].reshape(-1, cs.HUFF_NE).tolist())
    # entries 8..13 join entry 0's chain at once, one codeword short
    assert (cnt[:, full, :8] == 32).all() and (cnt[:, full, 8:] == 31).all()


def test_uniform128_spans_rarely_merge(sets):
    """7-bit data at the kernel's least span (9 words, 288 = 1 mod 7 bits):
    most spans keep several exits, and the true chain enters over a fifth
    of the spans neither at entry 0 nor at e1 (the previous span's entry-0
    exit), so phase B computes maps at other entries."""
    st, _ = sets[0]["uniform128"]
    K = 32 * cs.HUFF_KW_MIN
    ex, cnt = _maps(st, K)
    full = (np.arange(ex.shape[1]) + 1) * K <= 7 * FUZZ["T"]
    distinct = np.asarray([len(set(e)) for e in ex[:, full].reshape(-1, cs.HUFF_NE).tolist()])
    assert (distinct >= 2).mean() > 0.6
    entry, other = np.zeros(ex.shape[0], np.int64), 0
    for s in range(int(full.sum())):
        e1 = ex[:, s - 1, 0] if s else entry
        other += ((entry != 0) & (entry != e1)).sum()
        entry = ex[np.arange(ex.shape[0]), s, entry]
    assert other > 0.2 * full.sum() * ex.shape[0]


def test_chunk_guesses_fail_where_chains_never_merge(sets):
    """Phase B's guess of each chunk's entry always holds on random bytes
    (every length 8 and K a multiple of 8) and fails on every block of 7-bit
    data, so the kernel's whole chunk maps (its repair) are exercised."""
    got = {}
    for pat in ("random", "uniform128"):
        got[pat] = {}
        cs.huff_model(*sets[0][pat][0], stats=got[pat])
    B = FUZZ["B"]
    assert got["random"] == {"repaired": 0, "pages": B}
    assert got["uniform128"] == {"repaired": B, "pages": B}


def test_corpus_spans_merge(sets):
    st, _ = sets[0]["corpus"]
    ex, cnt = _maps(st, 512)
    one = np.asarray([len(set(e)) == 1 for e in ex.reshape(-1, cs.HUFF_NE).tolist()])
    assert one.mean() > 0.5
    assert (cnt[..., 0] > 0).all()


def test_nlzc_prior_container_matches_compress(corpus_text):
    data = corpus_text(ppm_tpu.PRIOR_MIN)
    prior = ppm_tpu.parse_container(ppm_tpu.compress(data, 16384))[2]
    assert cs.nlzc_prior_container(data, 16384) == prior


def test_huff_scheme_matches_kernel_source():
    """HUFF_NE, HUFF_SPAN_BYTES and HUFF_PAGE, which huff_model maps, chunks
    and pages by, are the kernel's: its entries, its chunks (threads / 14),
    its shared bytes at 512 and 1024 threads, the decode table, its bytes a
    span and a word."""
    src = (Path(th.__file__).resolve().parent.parent / "csrc" / "huff_scan.cu").read_text()
    num = lambda pat: int(re.search(pat, src)[1])
    assert re.search(r"constexpr int NCH = NT / LIMIT;", src)
    assert cs.HUFF_NE == th.CODE_LEN_LIMIT == num(r"constexpr int LIMIT = (\d+);")
    assert re.search(r"SMEM = NT == 512 \? 108 \* 1024 : 216 \* 1024;", src)
    assert re.search(r"TAB_BYTES = 2 << LIMIT;", src)
    assert num(r"constexpr int SPAN_BYTES = (\d+);") == cs.HUFF_SPAN_BYTES
    assert num(r"constexpr int WORD_BYTES = (\d+);") == 8
    assert re.search(r"WORDS = \(SMEM - TAB_BYTES - NT \* SPAN_BYTES - 16\) / WORD_BYTES - 2;", src)
    assert num(r"#define NLZM_HUFF_KW (\d+)") == 0  # the rule
    assert num(r"constexpr int KW_MIN = (\d+);") == cs.HUFF_KW_MIN


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_huff_scan_kernel_matches_ref_on_fuzz(sets, cuda, pattern):
    st, want = sets[0][pattern]
    args = [torch.from_numpy(a).to(cuda) for a in st[:5]]
    got = th._huff_scan(*args, st[5])
    assert torch.equal(got.cpu(), th._huff_scan_ref(*(a.cpu() for a in args), st[5]))
    np.testing.assert_array_equal(got.cpu().numpy(), want)
