"""The port's own copies of the host modules, pinned to the originals:
container encode (byte-identical), container and payload parsing, the
wide format tables and chunk schedule, the constants, CRC32,
chip_smoke.py's copy of the bench corpus generator, and the host side of
the device wide encode (native parse, lift, rep classification and plane
encode bindings; plane batching, priors, payload assembly, bit packing,
slot and minimum-length helpers), the fence rule build_cdf, and the host
sides of the research codecs (huff0's tables and both of its containers;
NLZC's constants, schedule, layout, prior and block encode)."""

import dataclasses

import numpy as np
import pytest

import bench
import chip_smoke
from nlzm_tpu import constants as jconst
from nlzm_tpu import native as jnative
from nlzm_tpu.format import wide as jwide
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.research import huff0 as jhuff
from nlzm_tpu.research import ppm_tpu as jppm
from nlzm_tpu.utils.crc32 import crc32 as jcrc32
from nlzm_tpu_torch import constants as tconst
from nlzm_tpu_torch import native as tnative
from nlzm_tpu_torch.format import wide as twide
from nlzm_tpu_torch.parallel import blocks as tblocks
from nlzm_tpu_torch.research import huff0 as thuff
from nlzm_tpu_torch.research import ppm_tpu as tppm
from nlzm_tpu_torch.utils.crc32 import crc32 as tcrc32

# case -> (input bytes, encode_container keywords)
CASES = {
    "wide_dict": (60_000, dict(block_size=16384, parser="optimal", profile="wide",
                               dict_size=8192)),
    "wide_no_dict": (40_000, dict(block_size=8192, parser="optimal", profile="wide")),
    "v1_greedy": (30_000, dict(block_size=4096, parser="greedy")),
    "v1_optimal": (30_000, dict(block_size=8192, parser="optimal")),
    "v1_empty": (0, dict()),
    "wide_empty": (0, dict(profile="wide", parser="optimal", dict_size=4096)),
}


@pytest.fixture(scope="module")
def containers(corpus_text):
    """case -> (JAX container, port container)."""
    out = {}
    for name, (n, kw) in CASES.items():
        data = corpus_text(n) if n else b""
        out[name] = (jblocks.encode_container(data, **kw), tblocks.encode_container(data, **kw))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_container_byte_identical(containers, case):
    j, t = containers[case]
    assert t == j


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_container_fields(containers, case):
    j, _ = containers[case]
    assert dataclasses.asdict(tblocks.parse_container(j)) == dataclasses.asdict(
        jblocks.parse_container(j))


@pytest.mark.parametrize("case", ["wide_dict", "wide_no_dict"])
def test_parse_payload_and_priors(containers, case):
    j, _ = containers[case]
    info = jblocks.parse_container(j)
    assert tblocks.block_payloads(j, info) == jblocks.block_payloads(j, info)
    for p in jblocks.block_payloads(j, info):
        tc, ts, to, tb = twide.parse_payload(p)
        jc, js, jo, jb = jwide.parse_payload(p)
        assert (tc, ts, tb) == (jc, js, jb)
        assert all(np.array_equal(a, b) for a, b in zip(to, jo, strict=True))
    tp, jp = twide.parse_priors(info.wide_priors), jwide.parse_priors(info.wide_priors)
    assert tp.keys() == jp.keys()
    for k in jp:
        assert all(np.array_equal(a, b) for a, b in zip(tp[k], jp[k], strict=True))
    assert twide.priors_blob_size() == jwide.priors_blob_size() == len(info.wide_priors)


@pytest.mark.parametrize("case", ["v1_greedy", "v1_optimal"])
def test_pack_streams(containers, case):
    j, _ = containers[case]
    info = jblocks.parse_container(j)
    np.testing.assert_array_equal(tblocks.pack_streams(j, info), jblocks.pack_streams(j, info))


def test_format_tables():
    assert twide.PLANES == tuple(
        twide.PlaneSpec(p.name, p.lanes, p.reads, p.alphabets, p.rows) for p in jwide.PLANES)
    for name in ("N_PLANES", "HDR_BYTES", "TOK_LIT", "TOK_DICT", "TOK_REP", "CHUNK_STEPS",
                 "WARMUP_CHUNKS"):
        assert getattr(twide, name) == getattr(jwide, name), name
    for n in range(1, 4097):
        assert twide.chunk_schedule(n) == jwide.chunk_schedule(n)
    for lanes in (16, 32, 64):
        for n in range(0, 20000, 97):
            assert twide.padded_steps(n, lanes) == jwide.padded_steps(n, lanes)


def test_empty_payload():
    """The mesh's padding payload, byte for byte, and what it parses to."""
    assert twide.empty_payload() == jwide.empty_payload()
    counts, streams, offsets, bits = twide.parse_payload(twide.empty_payload())
    assert list(counts) == [0] * twide.N_PLANES and bits == b""


def test_container_constants():
    for name in ("MAGIC", "VERSION", "FLAG_CRC32", "FLAG_WIDE", "FLAG_PRIORS", "FLAG_DICT",
                 "DEFAULT_BLOCK_SIZE", "WIDE_MAX_BLOCK"):
        assert getattr(tblocks, name) == getattr(jblocks, name), name
    assert tblocks._HDR.format == jblocks._HDR.format
    assert tblocks._BLK.format == jblocks._BLK.format
    for name in ("CDF_ADAPT_BITS", "CDF_SCALE_BITS", "CDF_SCALE_TOTAL"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for hb in range(8, 30):
        assert tconst.frame_bits_for(hb) == jconst.frame_bits_for(hb)
        assert tblocks.hist_bits_for_block(1 << hb) == jblocks.hist_bits_for_block(1 << hb)
    data = bytes(range(256)) * 300
    for size in (0, 100, 4096, 20000, 100000):
        assert tblocks.sample_dict(data, size) == jblocks.sample_dict(data, size)


def test_chunk_size_for():
    for fb in range(10, 24):
        assert tconst.chunk_size_for(fb) == jconst.chunk_size_for(fb)
    for hb in range(10, 30):
        fb = jconst.frame_bits_for(hb)
        assert tconst.chunk_size_for(tconst.frame_bits_for(hb)) == jconst.chunk_size_for(fb)


def test_crc32():
    rng = np.random.default_rng(5)
    prev = 0
    for n in (0, 1, 7, 4096, 100_003):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tcrc32(buf) == jcrc32(buf)
        assert tcrc32(buf, prev) == jcrc32(buf, prev)
        prev = jcrc32(buf, prev)


def test_build_corpus_copy():
    assert chip_smoke.build_corpus(1 << 20) == bench.build_corpus(1 << 20)


# ---- the host side of the device wide encode


@pytest.fixture(scope="module")
def parsed(corpus_text):
    """Native-parsed commands (JAX package binding) of 50 KB at 8 KiB
    blocks, lifted and rep-classified, as [T, B] int32."""
    op_len, op_val = jnative.parse_blocks(corpus_text(50_000), 8192, 13)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    jnative.lift_deep(op_len, op_val, 8192)
    return op_len, op_val, jnative.classify_reps(op_len, op_val)


def test_hash_constant():
    assert tconst.HASH4_MULT == jconst.HASH4_MULT


def test_native_parse_lift_classify(corpus_text):
    data = corpus_text(50_000)
    tl, tv = tnative.parse_blocks(data, 8192, 13)
    jl, jv = jnative.parse_blocks(data, 8192, 13)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)
    tl, tv = np.ascontiguousarray(tl, np.int32), np.ascontiguousarray(tv, np.int32)
    jl, jv = tl.copy(), tv.copy()
    np.testing.assert_array_equal(tnative.lift_deep(tl, tv, 8192), jnative.lift_deep(jl, jv, 8192))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tnative.classify_reps(tl, tv), jnative.classify_reps(jl, jv))
    for a, b in zip(tnative.parse_blocks(b"", 8192, 13), jnative.parse_blocks(b"", 8192, 13)):
        assert a.shape == b.shape == (0, 0)


@pytest.mark.parametrize("with_priors", [False, True])
def test_native_wide_encode(parsed, with_priors):
    assert tnative.wide_encode(*parsed, with_priors) == jnative.wide_encode(*parsed, with_priors)


def test_batch_plane_arrays_and_priors(parsed):
    tp, tb, tc = twide.batch_plane_arrays(*parsed)
    jp, jb, jc = jwide.batch_plane_arrays(*parsed)
    assert tp == jp
    assert all(np.array_equal(a, b) for a, b in zip(tc, jc, strict=True))
    assert tb.keys() == jb.keys()
    for k in jb:
        (ts, tr, tn, tm), (js, jr, jn, jm) = tb[k], jb[k]
        assert all(np.array_equal(a, b) for a, b in zip(ts, js, strict=True))
        assert tr == jr
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tm, jm)
    tpri, jpri = twide.build_priors_from_batched(tb), jwide.build_priors_from_batched(jb)
    assert tpri.keys() == jpri.keys()
    for k in jpri:
        assert all(np.array_equal(a, b) for a, b in zip(tpri[k], jpri[k], strict=True))
    assert twide.serialize_priors(tpri) == jwide.serialize_priors(jpri)
    assert twide.PRIOR_ROW_BUDGET == jwide.PRIOR_ROW_BUDGET


def test_assemble_payloads(parsed):
    """The numpy encoder's payloads, rebuilt from its own plane streams by
    the port's copy of assemble_payloads."""
    per_block, batched, counts = jwide.batch_plane_arrays(*parsed)
    priors = jwide.build_priors_from_batched(batched)
    streams, offsets = [], []
    for spec in jwide.PLANES:
        syms, rows, n, _ = batched[spec.name]
        s, o = jwide._rans_encode_plane(spec, syms, rows, n, len(per_block), priors[spec.name])
        streams.append(s)
        offsets.append(o)
    want = jwide.assemble_payloads(per_block, counts, streams, offsets)
    assert twide.assemble_payloads(per_block, counts, streams, offsets) == want
    assert want == jwide.encode_wide_blocks(*parsed)[0]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_slot_and_mmin_helpers(dtype):
    rng = np.random.default_rng(3)
    dv = np.concatenate([np.arange(0, 70000), rng.integers(0, 1 << 23, 5000)]).astype(dtype)
    for a, b in zip(twide.dist_slot_of(dv), jwide.dist_slot_of(dv), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    d = dv + dtype(1)
    np.testing.assert_array_equal(twide.mmin_of(d), jwide.mmin_of(d))
    assert twide.mmin_of(d).dtype == jwide.mmin_of(d).dtype


def test_pack_bits():
    rng = np.random.default_rng(4)
    assert twide._pack_bits(np.zeros(3, np.int32), np.zeros(3, np.int32)) == b""
    for n in (1, 7, 100, 3001):
        widths = rng.integers(0, 17, n).astype(np.int32)
        values = (rng.integers(0, 1 << 16, n) & ((1 << widths) - 1)).astype(np.int32)
        assert twide._pack_bits(widths, values) == jwide._pack_bits(widths, values)


@pytest.mark.parametrize("nsym", [1, 3, 4, 8, 16, 17, 64, 256])
def test_build_cdf(nsym):
    rng = np.random.default_rng(nsym)
    for counts in (np.zeros((2, nsym), np.int64), rng.integers(0, 3000, (3, 5, nsym)),
                   rng.integers(0, 1 << 16, (nsym,))):
        got, want = twide.build_cdf(counts, nsym), jwide.build_cdf(counts, nsym)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---- the research codecs' host sides


def _huff_count_sets(corpus_samples):
    skew = np.ones(256, np.int64)
    skew[0] = 1 << 40
    yield skew
    yield np.zeros(256, np.int64)
    yield np.arange(256)
    for name in ("text", "random", "zeros", "tiny"):
        yield np.bincount(np.frombuffer(corpus_samples[name], np.uint8), minlength=256)


def test_huff0_tables(corpus_samples):
    assert (thuff.CODE_LEN_LIMIT, thuff.MAGIC, thuff._HDR.format) == (
        jhuff.CODE_LEN_LIMIT, jhuff.MAGIC, jhuff._HDR.format)
    for counts in _huff_count_sets(corpus_samples):
        lengths = jhuff.code_lengths(counts)
        np.testing.assert_array_equal(thuff.code_lengths(counts), lengths)
        np.testing.assert_array_equal(thuff._huffman_depths(np.maximum(counts, 1)),
                                      jhuff._huffman_depths(np.maximum(counts, 1)))
        for fn in ("canonical_codes", "left_tables"):
            got, want = getattr(thuff, fn)(lengths), getattr(jhuff, fn)(lengths)
            for a, b in zip(got, want, strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block_size", [1000, 4096, 32768])
def test_huff0_containers(corpus_samples, corpus_text, block_size):
    for data in (corpus_text(70_000), corpus_samples["random"], corpus_samples["tiny"], b""):
        c = thuff.encode(data, block_size)
        assert c == jhuff.encode(data, block_size)
        got, want = thuff._parse(c), jhuff._parse(c)
        assert got[:3] + got[4:] == want[:3] + want[4:]
        assert all(np.array_equal(a, b) for a, b in zip(got[3], want[3], strict=True))
        assert thuff.decode(c, engine="host") == data
    text = corpus_text(50_000)
    a = thuff.adaptive_encode(text)
    assert a == jhuff.adaptive_encode(text)
    assert thuff.adaptive_decode(a) == text


def test_nlzc_constants_and_schedule():
    for name in ("CHUNK_STEPS", "WARMUP_CHUNKS", "MAGIC", "VERSION", "LANES", "DEFAULT_BLOCK",
                 "ROWS", "GROUP", "PRIOR_W", "PRIOR_QUANT", "BLEND", "PRIOR_MIN"):
        assert getattr(tppm, name) == getattr(jppm, name), name
    for n in range(1, 3000):
        assert tppm.chunk_schedule(n) == jppm.chunk_schedule(n)
        assert tppm.padded_steps(n, 1) == jppm.padded_steps(n, 1)
    for nb in (0, 1, 31, 32, 33, 1000, 32768):
        (ts, tl), (js, jl) = tppm._seg_lens(nb), jppm._seg_lens(nb)
        assert ts == js
        np.testing.assert_array_equal(tl, jl)
    rng = np.random.default_rng(2)
    prev, prev2, hi = (rng.integers(0, 256, 50), rng.integers(0, 256, 50), rng.integers(0, 16, 50))
    for a, b in zip(tppm._rows_of(prev, prev2, hi), jppm._rows_of(prev, prev2, hi), strict=True):
        np.testing.assert_array_equal(a, b)
    carry = rng.integers(0, 1100, (2, tppm.ROWS, 16))
    prior = rng.integers(0, 65, (tppm.ROWS, 16))
    np.testing.assert_array_equal(tppm._effective_counts(carry, prior),
                                  jppm._effective_counts(carry, prior))


def test_nlzc_layout_prior_and_encode(corpus_text, corpus_samples):
    blocks = [corpus_text(9000)[i : i + 4096] for i in (0, 4096, 8192)] + [corpus_samples["tiny"]]
    got, want = tppm._layout(blocks), jppm._layout(blocks)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4], strict=True):
        np.testing.assert_array_equal(a, b)
    prior = jppm.build_prior(*want[:4])
    np.testing.assert_array_equal(tppm.build_prior(*got[:4]), prior)
    assert tppm.encode_blocks(blocks, prior) == jppm.encode_blocks(blocks, prior)
    data = corpus_text(5000)
    assert tppm.compress(data, 1024) == jppm.compress(data, 1024)
