"""The port's own copies of the host modules, pinned to the originals:
container encode (byte-identical), container and payload parsing, the
wide format tables and chunk schedule, the constants, CRC32, and
chip_smoke.py's copy of the bench corpus generator."""

import dataclasses

import numpy as np
import pytest

import bench
import chip_smoke
from nlzm_tpu import constants as jconst
from nlzm_tpu.format import wide as jwide
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.utils.crc32 import crc32 as jcrc32
from nlzm_tpu_torch import constants as tconst
from nlzm_tpu_torch.format import wide as twide
from nlzm_tpu_torch.parallel import blocks as tblocks
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
