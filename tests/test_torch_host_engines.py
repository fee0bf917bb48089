"""The port's host engines against nlzm_tpu's, exact, on the CPU: the
containers' native decode (in memory and from files, wide with and
without a dictionary, v1), the host plane decode and its tables of the wide
profile, the wide greedy encode on the host engine, the single-stream
codec's native paths (codec.py), the native bindings they run, the
metrics module (memory report, progress line, stage timers), the new
constants, corrupt containers on the native engine, and the guard on a
missing native library."""

import io
import subprocess
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from nlzm_tpu import codec as jcodec
from nlzm_tpu import constants as jconst
from nlzm_tpu import native as jnative
from nlzm_tpu.format import frame as jframe
from nlzm_tpu.format import wide as jwide
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.parallel import stream as jstream
from nlzm_tpu.utils import metrics as jmetrics
from nlzm_tpu_torch import codec as tcodec
from nlzm_tpu_torch import constants as tconst
from nlzm_tpu_torch import native as tnative
from nlzm_tpu_torch.format import wide as twide
from nlzm_tpu_torch.parallel import blocks as tblocks
from nlzm_tpu_torch.parallel import stream as tstream
from nlzm_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# case -> (input bytes, container config, file-decode bucket bytes)
CASES = {
    "wide_dict": (60_000, dict(block_size=16384, parser="optimal", profile="wide",
                               dict_size=8192), 33_000),
    "wide_no_dict": (40_000, dict(block_size=8192, parser="optimal", profile="wide"), 20_000),
    "v1": (30_000, dict(block_size=4096, parser="greedy"), 9_000),
}


@pytest.fixture(scope="module")
def containers(corpus_text):
    """case -> (input, JAX native-encoded container, bucket bytes)."""
    out = {}
    for name, (n, cfg, bucket) in CASES.items():
        data = corpus_text(n)
        out[name] = (data, jblocks.encode_container(data, engine="native", **cfg), bucket)
    return out


@pytest.fixture(scope="module")
def parsed(corpus_text):
    """Native-parsed commands of 40 KB at 8 KiB blocks, lifted and
    rep-classified, as [T, B] int32."""
    op_len, op_val = jnative.parse_blocks(corpus_text(40_000), 8192, 13)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    jnative.lift_deep(op_len, op_val, 8192)
    return op_len, op_val, jnative.classify_reps(op_len, op_val)


# ---------------------------------------------------------------- containers


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_container_native_matches_jax(containers, case):
    data, c, _ = containers[case]
    got = tblocks.decode_container(c, engine="native")
    assert got == jblocks.decode_container(c, engine="native") == data


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_container_stream_native_matches_jax(containers, case, tmp_path):
    data, c, bucket = containers[case]
    src = tmp_path / "c.nlzp"
    src.write_bytes(c)
    j_out, t_out = tmp_path / "j.out", tmp_path / "t.out"
    j = jstream.decode_container_stream(str(src), str(j_out), engine="native",
                                        bucket_bytes=bucket)
    t = tstream.decode_container_stream(str(src), str(t_out), engine="native",
                                        bucket_bytes=bucket)
    assert t == j
    assert t_out.read_bytes() == j_out.read_bytes() == data
    assert tstream.decode_container_stream(str(src), None, engine="native",
                                           bucket_bytes=bucket) == j


def test_decode_empty_containers_native():
    for kw in (dict(profile="wide", parser="optimal"), dict()):
        c = jblocks.encode_container(b"", block_size=4096, **kw)
        assert tblocks.decode_container(c, engine="native") == b""


@pytest.mark.parametrize("engine", ["tpu", "serial", "auto"])
def test_decode_unknown_engine_raises(containers, engine, tmp_path):
    _, c, _ = containers["v1"]
    with pytest.raises(ValueError, match="'device' or 'native'"):
        tblocks.decode_container(c, engine=engine)
    src = tmp_path / "c.nlzp"
    src.write_bytes(c)
    with pytest.raises(ValueError, match="'device' or 'native'"):
        tstream.decode_container_stream(str(src), None, engine=engine)


def _flip(c: bytes, off: int) -> bytes:
    b = bytearray(c)
    b[off] ^= 0xFF
    return bytes(b)


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the reference's error, whatever its type
        return e


@pytest.mark.parametrize("case", sorted(CASES))
def test_corrupt_container_native_is_integrity_error(containers, case, tmp_path):
    """One payload byte flipped at a time: wherever nlzm_tpu's native engine
    rejects the container (a plane decoder's ValueError, a native
    RuntimeError, or a CRC mismatch), the port raises IntegrityError, in
    memory and from a file; where it raises an IndexError, so does the
    port; wherever it decodes, the port gives the same bytes. The fixed
    offsets are ones JAX rejects."""
    data, c, bucket = containers[case]
    info = jblocks.parse_container(c)
    rng = np.random.default_rng(len(case))
    offs = [50, 1000] + rng.integers(0, len(c) - info.payload_off, 4).tolist()
    rejected = 0
    for off in offs:
        bad = _flip(c, info.payload_off + off)
        want = _outcome(lambda: jblocks.decode_container(bad, engine="native"))
        if isinstance(want, bytes):
            assert tblocks.decode_container(bad, engine="native") == want
            continue
        if isinstance(want, IndexError):  # not a rejection: it passes through
            with pytest.raises(IndexError):
                tblocks.decode_container(bad, engine="native")
            continue
        assert isinstance(want, (ValueError, RuntimeError)), repr(want)
        rejected += 1
        with pytest.raises(tblocks.IntegrityError):
            tblocks.decode_container(bad, engine="native")
        if rejected == 1:
            src = tmp_path / "bad.nlzp"
            src.write_bytes(bad)
            with pytest.raises(tblocks.IntegrityError):
                tstream.decode_container_stream(str(src), None, engine="native",
                                                bucket_bytes=bucket)
    assert rejected >= 2
    # a valid decode right after still succeeds
    assert tblocks.decode_container(c, engine="native") == data


def test_native_decode_lets_other_errors_through(containers, monkeypatch):
    """Only the decoders' rejections become IntegrityError: an IndexError
    (a fault of the decoder, not of the payload) passes through."""
    _, c, _ = containers["wide_no_dict"]

    def broken(payload, priors_blob=None):
        raise IndexError("decoder fault")

    monkeypatch.setattr(tblocks, "decode_wide_block", broken)
    with pytest.raises(IndexError, match="decoder fault"):
        tblocks.decode_container(c, engine="native")


def test_missing_native_library_raises(containers, tmp_path, monkeypatch):
    """No fallback: without the library the native engine raises
    NativeUnavailable, in memory and from a file (nlzm_tpu's file decode
    fails on a missing symbol instead)."""
    _, c, bucket = containers["wide_no_dict"]
    src = tmp_path / "c.nlzp"
    src.write_bytes(c)

    def gone():
        raise tnative.NativeUnavailable("no library")

    monkeypatch.setattr(tnative, "load", gone)
    with pytest.raises(tnative.NativeUnavailable):
        tblocks.decode_container(c, engine="native")
    with pytest.raises(tnative.NativeUnavailable):
        tstream.decode_container_stream(str(src), None, engine="native", bucket_bytes=bucket)
    with pytest.raises(tnative.NativeUnavailable):
        tcodec.encode_bytes(b"abc" * 100)


# ---------------------------------------------------------------- wide host planes


@pytest.mark.parametrize("case", ["wide_dict", "wide_no_dict"])
def test_decode_wide_block_matches_jax(containers, case):
    _, c, _ = containers[case]
    info = jblocks.parse_container(c)
    for p in jblocks.block_payloads(c, info):
        tl, tv = twide.decode_wide_block(p, info.wide_priors)
        jl, jv = jwide.decode_wide_block(p, info.wide_priors)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tv, jv)
        assert tl.dtype == jl.dtype


def test_decode_wide_block_without_priors(parsed):
    payloads, _ = jwide.encode_wide_blocks(*parsed, with_priors=False)
    for p in payloads:
        for a, b in zip(twide.decode_wide_block(p), jwide.decode_wide_block(p), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("plane", range(5))
def test_table_bank_matches_jax(parsed, plane):
    """The decoder's fence tables, with and without priors, at the start
    and after two chunk boundaries on the same counts."""
    _, batched, _ = jwide.batch_plane_arrays(*parsed)
    priors = jwide.build_priors_from_batched(batched)
    spec = jwide.PLANES[plane]
    rng = np.random.default_rng(plane)
    for prior in (None, priors[spec.name]):
        tb, jb = twide._TableBank(2, spec, prior), jwide._TableBank(2, spec, prior)
        for _ in range(2):
            for r in range(spec.reads):
                np.testing.assert_array_equal(tb.tables[r], jb.tables[r])
                bump = rng.integers(0, 50, tb.counts[r].shape)
                tb.counts[r] += bump
                jb.counts[r] += bump
            tb.boundary()
            jb.boundary()
        for r in range(spec.reads):
            np.testing.assert_array_equal(tb.tables[r], jb.tables[r])
            np.testing.assert_array_equal(tb.carry[r], jb.carry[r])


@pytest.mark.parametrize("engine", ["auto", "native"])
@pytest.mark.parametrize("block_size,n", [(8192, 40_000), (5000, 21_000)])
def test_wide_greedy_host_encode_matches_jax(corpus_text, engine, block_size, n):
    """The device parse on the CPU, then the host plane encode: the
    container of nlzm_tpu's engine "auto" (its device parse, host planes)."""
    data = corpus_text(n)
    kw = dict(block_size=block_size, profile="wide", parser="greedy")
    got = tblocks.encode_container(data, engine=engine, device="cpu", **kw)
    assert got == jblocks.encode_container(data, engine="auto", **kw)
    assert tblocks.decode_container(got, engine="native") == data


def test_wide_greedy_host_encode_refuses_a_dictionary(corpus_text):
    with pytest.raises(ValueError, match="dictionaries"):
        tblocks.encode_container(corpus_text(20_000), block_size=4096, profile="wide",
                                 parser="greedy", dict_size=4096, device="cpu")


# ---------------------------------------------------------------- single stream


@pytest.mark.parametrize("parser", ["greedy", "optimal"])
@pytest.mark.parametrize("window", [12, 16, 22])
def test_encode_decode_bytes_match_jax(corpus_samples, parser, window):
    for name, data in corpus_samples.items():
        got = tcodec.encode_bytes(data, window, parser=parser)
        assert got == jcodec.encode_bytes(data, window, parser=parser, engine="native"), name
        assert tcodec.decode_bytes(got) == jcodec.decode_bytes(got, engine="native") == data


@pytest.mark.parametrize("chunk", [None, 3000])
@pytest.mark.parametrize("parser", ["greedy", "optimal"])
def test_encode_decode_file_match_jax(corpus_text, tmp_path, monkeypatch, parser, chunk):
    """File to file, with the codec's own read size and with 3000-byte
    reads (many feeds a file, the decoder's pump loop each)."""
    if chunk:
        monkeypatch.setattr(tcodec, "_IO_CHUNK", chunk)
        monkeypatch.setattr(jcodec, "_IO_CHUNK", chunk)
    data = corpus_text(60_000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    tz, jz = tmp_path / "t.nlzm", tmp_path / "j.nlzm"
    t = tcodec.encode_file(str(src), str(tz), 18, parser=parser)
    j = jcodec.encode_file(str(src), str(jz), 18, parser=parser)
    assert t == j
    assert tz.read_bytes() == jz.read_bytes() == tcodec.encode_bytes(data, 18, parser=parser)
    to, jo = tmp_path / "t.out", tmp_path / "j.out"
    assert tcodec.decode_file(str(tz), str(to)) == jcodec.decode_file(str(jz), str(jo))
    assert to.read_bytes() == jo.read_bytes() == data
    assert tcodec.decode_file(str(tz), None) == jcodec.decode_file(str(jz), None)


def test_codec_refuses_unported_engines():
    for engine in ("python", "serial", "device", "tpu"):
        with pytest.raises(ValueError, match="native host engine"):
            tcodec.encode_bytes(b"abc", engine=engine)
        with pytest.raises(ValueError, match="native host engine"):
            tcodec.decode_bytes(tcodec.encode_bytes(b"abc"), engine=engine)
    with pytest.raises(ValueError, match="unknown parser"):
        tcodec.encode_bytes(b"abc", parser="lazy")


def test_codec_format_errors(tmp_path):
    good = tcodec.encode_bytes(b"hello world " * 100, 16)
    bad_hist = (40).to_bytes(2, "big") + good[2:]
    bad_frame = good[:2] + (30).to_bytes(2, "big") + good[4:]
    for data in (b"\x00", bad_hist):
        with pytest.raises(tcodec.FormatError):
            tcodec.decode_bytes(data)
        with pytest.raises(jcodec.FormatError):
            jcodec.decode_bytes(data, engine="native")
    for name, data in (("short", good[:3]), ("hist", bad_hist), ("frame", bad_frame),
                       ("no_sentinel", good[:-4])):
        p = tmp_path / f"{name}.nlzm"
        p.write_bytes(data)
        with pytest.raises(jcodec.FormatError):
            jcodec.decode_file(str(p), None)
        with pytest.raises(tcodec.FormatError):
            tcodec.decode_file(str(p), None)


def test_native_bindings_match_jax(containers, corpus_text):
    data = corpus_text(30_000)
    for prev in (0, 0x12345678):
        assert tnative.crc32(data, prev) == jnative.crc32(data, prev)
    assert tnative.crc32(b"", 7) == 7
    _, c, _ = containers["v1"]
    info = jblocks.parse_container(c)
    payloads = jblocks.block_payloads(c, info)
    assert tnative.decode_blocks(payloads, info.hist_bits, info.block_size, info.total_len) == (
        jnative.decode_blocks(payloads, info.hist_bits, info.block_size, info.total_len))
    assert tnative.decode_blocks([], 12, 4096, 0) == b""
    for case in ("wide_dict", "wide_no_dict"):
        _, c, _ = containers[case]
        info = jblocks.parse_container(c)
        for p in jblocks.block_payloads(c, info)[:2]:
            ol, ov = (np.asarray(a, np.int32) for a in jwide.decode_wide_block(p, info.wide_priors))
            assert tnative.expand_ops(ol, ov, info.block_size, info.dictionary) == (
                jnative.expand_ops(ol, ov, info.block_size, info.dictionary))


def test_stream_coders_match_jax(corpus_text):
    data = corpus_text(50_000)
    te, je = tnative.StreamEncoder(16, "optimal"), jnative.StreamEncoder(16, "optimal")
    tout = te.feed(data[:20_000]) + te.feed(data[20_000:], final=True)
    jout = je.feed(data[:20_000]) + je.feed(data[20_000:], final=True)
    te.close()
    je.close()
    assert tout == jout
    td, jd = tnative.StreamDecoder(16), jnative.StreamDecoder(16)
    stream = tout + jframe.SENTINEL_FRAME
    got = td.feed(stream[:7000]) + td.feed(stream[7000:])
    assert got == jd.feed(stream[:7000]) + jd.feed(stream[7000:]) == data
    assert td.done and jd.done
    td.close()
    jd.close()
    with pytest.raises(RuntimeError, match="corrupt"):
        tnative.StreamDecoder(16).feed(b"\xff" * 64)


def test_new_constants_match_jax():
    for name in ("PARSE_TABLE_SIZE", "FILE_HEADER_BYTES", "MIN_HIST_BITS_DECODE",
                 "MAX_HIST_BITS", "MIN_FRAME_BITS", "MAX_FRAME_BITS", "DEFAULT_HIST_BITS"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert tconst.SENTINEL_FRAME == jframe.SENTINEL_FRAME
    for hb in range(8, 30):
        for n in (0, 1, 100, 5000, 1 << 16, 3 << 20, 1 << 28):
            assert tconst.shrink_hist_bits(hb, n) == jconst.shrink_hist_bits(hb, n)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("cfg", [(22, 0, 0), (15, 0, 0), (28, 0, 0), (15, 32768, 245),
                                 (17, 131072, 62), (13, 8192, 1)])
def test_memory_report_matches_jax(cfg):
    t = tmetrics.memory_report(*cfg).splitlines()
    j = jmetrics.memory_report(*cfg).splitlines()
    assert len(t) == len(j)
    for a, b in zip(t, j, strict=True):
        assert a.split() == b.replace("TPU", "device").replace(":", ": ").split()


def test_device_peak_report_on_cpu():
    assert tmetrics.device_peak_report("cpu") == ""


def test_progress_line_matches_jax():
    outs = []
    for mod in (tmetrics, jmetrics):
        buf = io.StringIO()
        with redirect_stderr(buf):
            p = mod.ProgressLine(1000, label="Packing", interval=0.0, force=True)
            for done, out in ((10, 5), (500, None), (999, 400), (1000, 420)):
                p.update(done, out)
            p.finish()
            q = mod.ProgressLine(1000)  # stderr is no TTY here: silent
            q.update(500)
            q.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "Packing... 999 / 1000 -> 400" in outs[0]


def test_metrics_stages():
    m = tmetrics.Metrics()
    for _ in range(2):
        with m.stage("encode", 1_000_000) as st:
            assert st.name == "encode"
    with m.stage("crc"):
        pass
    assert m.stages["encode"].calls == 2 and m.stages["encode"].bytes == 2_000_000
    lines = m.report().splitlines()
    assert lines[0].split()[0] == "encode" and lines[0].split()[3] == "x2"
    assert lines[0].endswith("MB/s") and not lines[1].endswith("MB/s")
    assert tmetrics.Stage("x").mb_per_s == jmetrics.Stage("x").mb_per_s == 0.0


def test_host_engines_run_without_jax():
    """The native engines (container and single stream) load nothing of
    jax, nlzm_tpu or bench.py; a subprocess, since this test process has
    them loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import nlzm_tpu_torch\n"
        "from nlzm_tpu_torch.parallel.blocks import decode_container, encode_container\n"
        "from nlzm_tpu_torch.utils import metrics\n"
        "data = bytes(range(256)) * 40 + b'host engines ' * 300\n"
        "for kw in (dict(profile='wide', parser='optimal'), dict(parser='greedy'),\n"
        "           dict(profile='wide', parser='greedy', device='cpu')):\n"
        "    c = encode_container(data, block_size=4096, **kw)\n"
        "    assert decode_container(c, engine='native') == data\n"
        "assert nlzm_tpu_torch.decode_bytes(nlzm_tpu_torch.encode_bytes(data, 14)) == data\n"
        "metrics.memory_report(15, 32768, 8)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'nlzm_tpu')\n"
        "             or m.startswith(('jax.', 'nlzm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
