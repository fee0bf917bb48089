"""Port v1 device encode against the JAX functions, exact: emit_model on
the greedy commands of the text, repetitive, random and zeros samples at
4 KiB blocks (with their rep slots and with none), on rep-heavy sensor
records, on a hand-made set that reaches every read, field and clamp,
and on chip_smoke.py's seeded fuzz set, and its spans replayed row by
row (what the kernel's design rests on); rans_backward and bits_forward
on those outputs, also at caps small enough to drop writes;
encode_blocks_device against encode_blocks_tpu;
encode_container(profile="v1", engine="device") and
encode_container_stream against the JAX containers and files; decodes of
the port's containers; card-only kernel-vs-plain cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import fuzz_commands
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.parallel import stream as jstream
from nlzm_tpu_torch import native as tnative
from nlzm_tpu_torch.ops import cdf_ops as tcdf
from nlzm_tpu_torch.ops import encode_ops as tenc
from nlzm_tpu_torch.parallel import blocks as tblocks
from nlzm_tpu_torch.parallel import stream as tstream

torch.set_num_threads(1)

SAMPLES = ("text", "repetitive", "random", "zeros")
N4K = 4096


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


def _sensor_records() -> bytes:
    """The rep-heavy fixed-stride records of tests/test_tpu_encode.py."""
    recs = [b"%08d,SENSOR_%02d,%06d,OK;" % (i, i % 16, (i * 2654435761) % 999983)
            for i in range(2000)]
    return b"".join(recs)[:48000]


def _jax_commands(data: bytes, N: int, hist_bits: int):
    """The JAX greedy parse and rep replay: (op_len, op_val, op_rep) numpy."""
    arr, nv = jenc._blocks_arrays(data, N)
    dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
    delta, mlen = jenc.find_matches(dj, nvj, (1 << hist_bits) - 1)
    op_len, op_val = jenc.greedy_cover(dj, delta, mlen, nvj, ((N + 255) // 256) * 256)
    return tuple(np.asarray(a) for a in (op_len, op_val, jenc.repify(op_len, op_val)))


def _hand_made():
    """[T, B] commands, one block per column, padded with dead rows:
    literals with all 16 high nibbles; direct and escaped lengths up to
    ext = 255; dictionary distances on both sides of dv = 4, of each mmin
    step and of ab = 4; all four rep slots; dead rows between live ones;
    and the clamps: literals above 255 and below 0, escapes past 255, a
    rep slot past 3."""
    cols = [
        [(0, 16 * h + (7 * h) % 16, -1) for h in range(16)] * 2,
        [(L, 100, -1) for L in range(2, 10)]
        + [(2 + 7 + e, 100, -1) for e in (0, 1, 15, 16, 17, 100, 254, 255)]
        + [(5 + 7 + e, 0x123456, -1) for e in (0, 200, 255)],
        [(12, v, -1) for v in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 31, 32, 33, 255, 256, 257,
                               4095, 4096, 4097, 0xFFFFF, 0x100000, 0x100001, 12345, 1 << 30)],
        [(6, 40, -1), (7, 40, 0), (0, 65, -1), (9, 300, -1), (4, 300, 0), (5, 40, 1),
         (8, 5000, -1), (8, 300, 1), (8, 40, 2), (3, 7, -1), (30, 5000, 2), (11, 7, 3)],
        [(0, 97, -1), (-1, 0, -1), (5, 2, -1), (-1, 3, 2), (-7, 99, -1), (0, 98, -1),
         (20, 1000, -1), (-1, 0, -1), (4, 1, 0)],
        [(0, 300, -1), (0, 256 + 3, -1), (0, -5, -1), (0, 271, -1), (600, 2, -1),
         (2 + 7 + 256, 50, -1), (2 + 7 + 257, 50, 1), (40, 3, 7), (9, 70000, 5), (0, 65, -1)],
    ]
    T = max(map(len, cols)) + 3
    arrs = np.zeros((3, T, len(cols)), np.int32)
    arrs[0] = -1
    arrs[2] = -1
    for b, col in enumerate(cols):
        for t, cmd in enumerate(col):
            arrs[:, t, b] = cmd
    return tuple(arrs)


@pytest.fixture(scope="module")
def commands(corpus_samples):
    """case -> (op_len, op_val, op_rep) numpy [T, B]."""
    out = {name: _jax_commands(corpus_samples[name], N4K, 12) for name in SAMPLES}
    out["sensor"] = _jax_commands(_sensor_records(), 8192, 13)
    out["hand_made"] = _hand_made()
    out["fuzz"] = fuzz_commands(5)  # chip_smoke.py holds the kernels on the same set
    return out


@pytest.fixture(scope="module")
def jax_emitted(commands):
    """case -> the JAX emit_model outputs as numpy (spans as int32 bits)."""
    out = {}
    for name, cmds in commands.items():
        spans, fields, nops = jenc.emit_model(*(jnp.asarray(a) for a in cmds))
        out[name] = (np.asarray(spans).view(np.int32), tuple(np.asarray(f) for f in fields),
                     np.asarray(nops))
    return out


def _assert_emit_equal(got, want):
    spans, fields, nops = got
    assert spans.dtype == nops.dtype == torch.int32
    np.testing.assert_array_equal(spans.numpy(), want[0])
    for g, w in zip(fields, want[1], strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(nops.numpy(), want[2])


@pytest.mark.parametrize("reps", ["replayed", "none"])
@pytest.mark.parametrize("name", SAMPLES)
def test_emit_model_matches_jax(commands, jax_emitted, name, reps):
    op_len, op_val, op_rep = commands[name]
    if reps == "none":
        op_rep = np.full_like(op_rep, -1)
        want = jenc.emit_model(jnp.asarray(op_len), jnp.asarray(op_val), jnp.asarray(op_rep))
        want = (np.asarray(want[0]).view(np.int32), tuple(np.asarray(f) for f in want[1]),
                np.asarray(want[2]))
    else:
        want = jax_emitted[name]
    _assert_emit_equal(tenc.emit_model(_t(op_len), _t(op_val), _t(op_rep)), want)


@pytest.mark.parametrize("name", ["sensor", "hand_made", "fuzz"])
def test_emit_model_special_commands_match_jax(commands, jax_emitted, name):
    op_len, op_val, op_rep = commands[name]
    if name == "sensor":
        assert (op_rep >= 0).sum() > 100  # rep-heavy
    _assert_emit_equal(tenc.emit_model(_t(op_len), _t(op_val), _t(op_rep)), jax_emitted[name])


def test_hand_made_reaches_every_read(jax_emitted):
    """The hand-made set codes all six reads, escapes, both raw-bit
    fields and the rep slot field."""
    spans, (va, nb_a, vb, nb_b), _ = jax_emitted["hand_made"]
    assert (spans != 0).any(axis=(0, 1)).all()
    assert nb_a.max() > 2 and (nb_a == 2).any() and nb_b.max() == 4


def _spans_row_by_row(op_len, op_val, op_rep):
    """emit_model's spans with each bank row's chain replayed apart from
    the others: a row changes only on a read of it, so its reads in step
    order (from the reads each command codes, ops/encode_ops.py
    _emit_commands) give its spans, whatever the other rows do. A numpy
    loop per block and row."""
    desc = tenc._emit_commands(*(_t(a) for a in (op_len, op_val, op_rep)))[0].numpy()
    rows = desc & 127
    ys = ((desc >> 7) & 31) - 2
    ns = 4 << (desc >> 12)
    bank0 = tcdf.initial_bank()
    full = 1 << 14
    spans = np.zeros(desc.shape, np.int64)
    for b in range(desc.shape[1]):
        for r in np.unique(rows[:, b]):
            if r == tcdf.NUM_CTX:  # the JAX zero row: span 0, no state
                continue
            ts, ss = np.nonzero(rows[:, b] == r)  # in step order
            assert len(set(ts.tolist())) == len(ts)  # a step reads a row at most once
            f = [int(v) for v in bank0[r]]
            for t, s in zip(ts.tolist(), ss.tolist()):
                y, n = int(ys[t, b, s]), int(ns[t, b, s])
                start = f[y] if 0 <= y < 17 else 0
                nxt = f[y + 1] if 0 <= y + 1 < 17 else 0
                spans[t, b, s] = ((nxt - start) << 16 | start) & 0xFFFFFFFF
                yc = min(max(y, 0), n - 1)
                f = [v + (((full if j >= n else (j if j <= yc else full + j + 127 - n)) - v) >> 7)
                     for j, v in enumerate(f)]
    return spans.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("name", SAMPLES + ("sensor", "hand_made", "fuzz"))
def test_emit_model_rows_replay_apart(commands, jax_emitted, name):
    np.testing.assert_array_equal(_spans_row_by_row(*commands[name]), jax_emitted[name][0])


RANS_CAPS = {"frame": lambda N: ((3 * N + 64 + 255) // 256) * 256, "17": lambda N: 17,
             "101": lambda N: 101}
CASES = SAMPLES + ("sensor", "hand_made", "fuzz")


@pytest.mark.parametrize("cap", sorted(RANS_CAPS))
@pytest.mark.parametrize("name", CASES)
def test_rans_backward_matches_jax(jax_emitted, name, cap):
    spans = jax_emitted[name][0]
    cap = RANS_CAPS[cap](spans.shape[0])
    js, jn = jenc.rans_backward(jnp.asarray(spans.view(np.uint32)), cap)
    ts, tn = tenc.rans_backward(_t(spans), cap)
    assert ts.dtype == torch.uint8 and tn.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("name", CASES)
def test_bits_forward_matches_jax(jax_emitted, name):
    """At the frame's cap, at 1 and 3, and at every cap from n_full to
    n_full + 5 of the shortest section: the drain's clamped writes."""
    fields = jax_emitted[name][1]
    T = fields[0].shape[0]
    jfields = tuple(jnp.asarray(f) for f in fields)
    n_full = int(np.asarray(jenc.bits_forward(jfields, 4)[1]).min()) - 4
    for cap in (((T + 64 + 255) // 256) * 256, 1, 3, *range(max(n_full, 1), n_full + 6)):
        jb, jn = jenc.bits_forward(jfields, cap)
        tb, tn = tenc.bits_forward(tuple(_t(f) for f in fields), cap)
        assert tb.dtype == torch.uint8 and tn.dtype == torch.int32
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("name", SAMPLES)
def test_encode_blocks_device_matches_jax(corpus_samples, name):
    data = corpus_samples[name]
    want = jenc.encode_blocks_tpu(data, N4K, 12)
    got = tenc.encode_blocks_device(data, N4K, 12, device="cpu")
    assert got == want


@pytest.mark.parametrize("block_size", [4096, 8192])
def test_encode_container_v1_device_matches_jax(corpus_text, block_size):
    data = corpus_text(40_000)
    want = jblocks.encode_container(data, block_size=block_size, parser="greedy", engine="tpu")
    got = tblocks.encode_container(data, block_size=block_size, parser="greedy",
                                   engine="device", device="cpu")
    assert got == want


def test_sensor_container_matches_jax_and_decodes():
    """The rep-heavy records: byte-identical to JAX, and the native host
    decoder returns the input."""
    data = _sensor_records()
    got = tblocks.encode_container(data, block_size=8192, engine="device", device="cpu")
    assert got == jblocks.encode_container(data, block_size=8192, engine="tpu")
    info = tblocks.parse_container(got)
    for b, p in enumerate(tblocks.block_payloads(got, info)):
        assert tnative.decode_block(p, info.hist_bits, 8192) == data[b * 8192 : (b + 1) * 8192]


def test_empty_input():
    assert tenc.encode_blocks_device(b"", N4K, 12, device="cpu") == ([], [], [])
    got = tblocks.encode_container(b"", block_size=N4K, engine="device", device="cpu")
    assert got == jblocks.encode_container(b"", block_size=N4K, engine="tpu")
    assert tblocks.decode_container(got, device="cpu") == b""


def test_block_larger_than_a_frame_raises():
    data = b"x" * 100000
    with pytest.raises(ValueError, match="frame chunk capacity"):
        tenc.encode_blocks_device(data, 65536, 14, device="cpu")
    with pytest.raises(ValueError, match="frame chunk capacity"):
        jenc.encode_blocks_tpu(data, 65536, 14)
    with pytest.raises(ValueError, match="frame chunk capacity"):
        tblocks.encode_container(data, block_size=65536, engine="device", device="cpu")


def test_optimal_device_parse_raises():
    """It no longer raises: the v1 block encode with the optimal parse
    equals encode_blocks_tpu's."""
    data = b"abc" * 100
    got = tenc.encode_blocks_device(data, N4K, 12, parser="optimal", device="cpu")
    assert got == jenc.encode_blocks_tpu(data, N4K, 12, parser="optimal")


@pytest.mark.parametrize("before", ["absent", "present"])
def test_failed_stream_encode_leaves_dst_as_it_was(tmp_path, monkeypatch, before):
    """A file encode that fails, before its first bucket (a block above
    one frame) or inside its bucket loop, leaves no new dst, does not touch
    an existing one, and leaves no temporary file."""
    src, dst = tmp_path / "in.bin", tmp_path / "out.nlzp"
    src.write_bytes(b"stream" * 30000)
    old = b"an older archive"
    if before == "present":
        dst.write_bytes(old)
    with pytest.raises(ValueError, match="frame chunk capacity"):
        tstream.encode_container_stream(str(src), str(dst), 65536, parser="greedy",
                                        engine="device", device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError("encode failed")

    monkeypatch.setattr(tstream, "encode_blocks_device", fail)
    with pytest.raises(RuntimeError, match="encode failed"):
        tstream.encode_container_stream(str(src), str(dst), 4096, engine="device",
                                        device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["in.bin"] + (["out.nlzp"] if before == "present" else []))
    if before == "present":
        assert dst.read_bytes() == old


def test_port_container_decodes(corpus_text):
    """A port container of several blocks, a short last one: the port's
    decode and native.decode_block per payload return the input."""
    data = corpus_text(12_000) + b"#"
    c = tblocks.encode_container(data, block_size=4096, engine="device", device="cpu")
    assert tblocks.decode_container(c, device="cpu") == data
    info = tblocks.parse_container(c)
    for b, p in enumerate(tblocks.block_payloads(c, info)):
        want = data[b * 4096 : (b + 1) * 4096]
        assert tnative.decode_block(p, info.hist_bits, len(want)) == want


# case -> (input bytes, encode keywords, bucket_bytes): several buckets each
STREAM_CASES = {
    "v1_device": (24_000, dict(block_size=4096, parser="greedy"), 9_000),
    "v1_native": (24_000, dict(block_size=4096, parser="optimal", engine="native"), 9_000),
    "wide_native": (50_000, dict(block_size=8192, parser="optimal", profile="wide",
                                 engine="native", dict_size=4096), 20_000),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_encode_container_stream_matches_jax(corpus_text, tmp_path, case):
    n, kw, bucket = STREAM_CASES[case]
    data = corpus_text(n)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    assert -(-n // kw["block_size"]) > tstream._bucket_blocks(kw["block_size"], bucket)
    jkw = dict(kw, engine="tpu") if case == "v1_device" else kw
    j = jstream.encode_container_stream(str(src), str(tmp_path / "jax.nlzp"),
                                        bucket_bytes=bucket, **jkw)
    tkw = dict(kw, engine="device") if case == "v1_device" else kw
    t = tstream.encode_container_stream(str(src), str(tmp_path / "port.nlzp"),
                                        bucket_bytes=bucket, device="cpu", **tkw)
    assert t == j
    got = (tmp_path / "port.nlzp").read_bytes()
    assert got == (tmp_path / "jax.nlzp").read_bytes()
    assert tblocks.decode_container(got, device="cpu") == data


def test_encode_container_stream_refuses(tmp_path):
    src, dst = tmp_path / "in.bin", str(tmp_path / "out.nlzp")
    src.write_bytes(b"abc" * 100)
    with pytest.raises(ValueError, match="engine"):
        tstream.encode_container_stream(str(src), dst, 4096, engine="serial")
    with pytest.raises(ValueError, match="native optimal-parse"):
        tstream.encode_container_stream(str(src), dst, 4096, parser="optimal",
                                        engine="device", profile="wide")


def test_sample_dict_file_matches_jax(tmp_path):
    data = bytes(range(256)) * 300
    src = tmp_path / "d.bin"
    src.write_bytes(data)
    for size in (0, 100, 4096, 20000, 100000):
        with open(src, "rb") as f:
            got = tstream.sample_dict_file(f, len(data), size)
        with open(src, "rb") as f:
            assert got == jstream.sample_dict_file(f, len(data), size)


def test_v1_encode_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; meta tensors raise, and no
    launch is counted."""
    i32 = dict(dtype=torch.int32, device=torch.device("meta"))
    cmd = torch.empty(256, 2, **i32)
    with pytest.raises(ValueError):
        tenc.emit_model(cmd, cmd, cmd)
    with pytest.raises(ValueError):
        tenc.rans_backward(torch.empty(256, 2, 6, **i32), 1024)
    with pytest.raises(ValueError):
        tenc.bits_forward((cmd, cmd, cmd, cmd), 1024)
    assert tenc.emit_model.launches == tenc.rans_backward.launches == 0
    assert tenc.bits_forward.launches == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CASES)
def test_emit_model_kernel_matches_ref(commands, cuda, name):
    args = tuple(_t(a).to(cuda) for a in commands[name])
    got, want = tenc.emit_model(*args), tenc.emit_model_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))


@pytest.mark.parametrize("name", CASES)
def test_rans_backward_kernel_matches_ref(jax_emitted, cuda, name):
    spans = _t(jax_emitted[name][0]).to(cuda)
    for cap in (RANS_CAPS["frame"](spans.shape[0]), 17, 101):
        for g, w in zip(tenc.rans_backward(spans, cap), tenc.rans_backward_ref(spans, cap)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", CASES)
def test_bits_forward_kernel_matches_ref(jax_emitted, cuda, name):
    fields = tuple(_t(f).to(cuda) for f in jax_emitted[name][1])
    for cap in (((fields[0].shape[0] + 64 + 255) // 256) * 256, 1, 3, 41):
        for g, w in zip(tenc.bits_forward(fields, cap), tenc.bits_forward_ref(fields, cap)):
            assert torch.equal(g, w)
