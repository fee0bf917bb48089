"""Port unfused plane decode (nlzm_tpu_torch.ops.wide_decode stage_plane
and plane_scan) against the JAX one, exact: staging, the plain scan on
the cases of tests/test_wide.py (planes lit and dst, the synthetic 4-row
spec with and without a prior), two 2-read specs (a lit-named one whose
second read is keyed by the first symbol, a dst-named one keyed by
row0 * 8 + symbol), hostile context rows and truncated streams; round
trips through the port's plane_encode; card-only kernel-vs-plain
cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.format import wide as jwide
from nlzm_tpu.ops import wide_decode as jdec
from nlzm_tpu_torch.format import wide as twide
from nlzm_tpu_torch.ops import wide_decode as tdec
from nlzm_tpu_torch.ops import wide_encode_dev as tdev

torch.set_num_threads(1)

# name -> (plane index, spec, counts); specs as PlaneSpec fields
SPECS = {
    "four_row": (4, ("dst", 8, 1, (16,), (4,)), (300, 41)),
    "lit_two_read": (1, ("lit", 16, 2, (16, 16), (1, 16)), (500, 77, 0)),
    "dst_two_read": (4, ("dst", 24, 2, (8, 16), (4, 32)), (450, 3)),
    "wide_lanes": (4, ("dst", 128, 1, (64,), (1,)), (1500, 9, 0)),
}


def _symbols(spec, counts, seed):
    """Random per-read symbols and the rows each read is keyed on, as the
    decoder derives them: [B, steps * L] int32 arrays, zero past counts."""
    rng = np.random.default_rng(seed)
    steps = jwide.padded_steps(int(max(counts)), spec.lanes)
    shape = (len(counts), steps * spec.lanes)
    live = np.arange(shape[1])[None, :] < np.asarray(counts)[:, None]
    ctx = np.where(live, rng.integers(0, spec.rows[0], shape), 0).astype(np.int32)
    syms, rows = [], []
    for r in range(spec.reads):
        if r == 0:
            row = ctx
        elif spec.name == "dst":
            row = ctx * 8 + syms[-1]
        else:
            row = syms[-1]
        rows.append(row.astype(np.int32))
        syms.append(np.where(live, rng.integers(0, spec.alphabets[r], shape), 0).astype(np.int32))
    return syms, rows, ctx, steps


@pytest.fixture(params=sorted(SPECS))
def synthetic(request, monkeypatch):
    """A synthetic spec swapped into the plane table of both packages, its
    symbols, rows and numpy-encoded streams, and a prior."""
    idx, fields, counts = SPECS[request.param]
    jspec, tspec = jwide.PlaneSpec(*fields), twide.PlaneSpec(*fields)
    planes = list(jwide.PLANES)
    planes[idx] = jspec
    monkeypatch.setattr(jwide, "PLANES", tuple(planes))
    monkeypatch.setattr(jdec, "PLANES", tuple(planes))
    tplanes = list(twide.PLANES)
    tplanes[idx] = tspec
    monkeypatch.setattr(twide, "PLANES", tuple(tplanes))
    syms, rows, ctx, steps = _symbols(jspec, counts, seed=len(request.param))
    rng = np.random.default_rng(5)
    prior = [rng.integers(0, 300, (jspec.rows[r], jspec.alphabets[r])).astype(np.int32)
             for r in range(jspec.reads)]
    enc_rows = [None if jspec.rows[r] == 1 else rows[r] for r in range(jspec.reads)]
    return dict(idx=idx, spec=jspec, counts=np.asarray(counts), syms=syms, rows=rows,
                enc_rows=enc_rows, ctx=ctx, steps=steps, prior=prior)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a, np.int32)).to(device)


def _both(streams, offsets, counts, ctx, idx, steps, prior=None):
    """Stage and scan with both packages; check the staging is equal;
    returns (port symbols, JAX symbols) as numpy, per read."""
    seeds, wins = tdec.stage_plane(streams, list(offsets), idx, steps, device="cpu")
    jseeds, jwins = jdec.stage_plane(streams, list(offsets), idx, steps)
    assert seeds.dtype == wins.dtype == torch.int32
    np.testing.assert_array_equal(seeds.numpy().view(np.uint32), np.asarray(jseeds))
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    got = tdec.plane_scan(seeds, wins, _t(counts), _t(ctx), idx, steps,
                          None if prior is None else tuple(_t(p) for p in prior))
    want = jdec.plane_scan(jseeds, jwins, jnp.asarray(counts, jnp.int32),
                           jnp.asarray(ctx, jnp.int32), idx, steps,
                           None if prior is None else tuple(jnp.asarray(p) for p in prior))
    assert all(g.dtype == torch.int32 for g in got)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_decoded(ys, syms, counts):
    for y, s in zip(ys, syms, strict=True):
        for b, n in enumerate(counts):
            np.testing.assert_array_equal(y[b, :n], s[b, :n])


@pytest.mark.parametrize("plane_idx", [1, 4])
def test_wire_plane_matches_jax(plane_idx):
    """The cases of tests/test_wide.py::test_device_plane_matches_host_encoder."""
    rng = np.random.default_rng(3)
    spec = jwide.PLANES[plane_idx]
    counts = np.array([700, 1023, 1])
    steps = jwide.padded_steps(int(counts.max()), spec.lanes)
    syms = np.zeros((3, steps * spec.lanes), np.int64)
    for b, n in enumerate(counts):
        syms[b, :n] = rng.integers(0, spec.alphabets[0], n)
    ctx = np.zeros_like(syms)
    streams, offsets = jwide._rans_encode_plane(spec, [syms], [ctx], counts, 3)
    got, want = _both(streams, offsets, counts, ctx, plane_idx, steps)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_decoded(got, [syms], counts)


@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
def test_synthetic_spec_matches_jax(synthetic, with_prior):
    d = synthetic
    prior = d["prior"] if with_prior else None
    streams, offsets = jwide._rans_encode_plane(d["spec"], d["syms"], d["enc_rows"], d["counts"],
                                                len(d["counts"]), prior)
    got, want = _both(streams, offsets, d["counts"], d["ctx"], d["idx"], d["steps"], prior)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    _assert_decoded(got, d["syms"], d["counts"])


def test_hostile_ctx_and_truncated_streams_match_jax(synthetic):
    """Context rows outside [0, rows) (negative, past the table, and large
    enough that row0 * 8 wraps in i32) and streams cut short under their
    chunk offsets: the port gives JAX's symbols, not a fault."""
    d = synthetic
    streams, offsets = jwide._rans_encode_plane(d["spec"], d["syms"], d["enc_rows"], d["counts"],
                                                len(d["counts"]), d["prior"])
    rng = np.random.default_rng(17)
    ctx = d["ctx"].copy()
    hostile = np.array([-1, -7, 4, 5, 31, 32, 1 << 29, (1 << 29) + 3, 1 << 28, -(1 << 31),
                        (1 << 31) - 1], np.int64)
    hit = rng.random(ctx.shape) < 0.3
    ctx[hit] = rng.choice(hostile, int(hit.sum())).astype(np.int32)
    got, want = _both(streams, offsets, d["counts"], ctx, d["idx"], d["steps"], d["prior"])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    L = d["spec"].lanes
    cut = [s[: 4 * L + 2 * ((len(s) - 4 * L) // 5)] for s in streams]
    got, want = _both(cut, offsets, d["counts"], d["ctx"], d["idx"], d["steps"], d["prior"])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def _port_roundtrip(d, prior, device):
    """plane_encode -> plane_streams -> stage_plane -> plane_scan on
    `device`; returns the decoded symbols as numpy, per read."""
    spec, idx, steps = d["spec"], d["idx"], d["steps"]
    pr = None if prior is None else tuple(_t(p, device) for p in prior)
    enc = tdev.plane_encode(tuple(_t(s, device) for s in d["syms"]),
                            tuple(None if r is None else _t(r, device) for r in d["enc_rows"]),
                            _t(d["counts"], device), idx, steps, pr)
    streams, offsets = tdev.plane_streams(spec, steps, *enc)
    seeds, wins = tdec.stage_plane(streams, list(offsets), idx, steps, device=device)
    ys = tdec.plane_scan(seeds, wins, _t(d["counts"], device), _t(d["ctx"], device), idx,
                         steps, pr)
    return [y.cpu().numpy() for y in ys]


@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
def test_port_plane_encode_round_trip(synthetic, with_prior):
    d = synthetic
    _assert_decoded(_port_roundtrip(d, d["prior"] if with_prior else None, "cpu"),
                    d["syms"], d["counts"])


@pytest.mark.parametrize("which", ["mixed", "short"])
def test_prior_is_none_or_one_per_read(which):
    """Like JAX's plane_scan, a prior is None or a tensor for every read;
    a tuple holding None, or one of the wrong length, is refused before
    any device is chosen."""
    spec = twide.PLANES[4]
    L, steps = spec.lanes, 2
    prior = {"mixed": (None,) * spec.reads,
             "short": (torch.zeros(spec.rows[0], spec.alphabets[0], dtype=torch.int32),) * 2}
    args = (torch.zeros(1, L, dtype=torch.int32), torch.zeros(1, 1, 8, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.zeros(1, steps * L, dtype=torch.int32))
    with pytest.raises(ValueError):
        tdec.plane_scan(*args, 4, steps, prior[which])


def test_stage_plane_empty_streams():
    """Streams of seeds only (no pair in any chunk): zero windows of 8."""
    L = jwide.PLANES[2].lanes
    streams = [bytes(range(4 * L)), bytes(4 * L)]
    offsets = [np.zeros(1, np.int64)] * 2
    seeds, wins = tdec.stage_plane(streams, offsets, 2, 2, device="cpu")
    jseeds, jwins = jdec.stage_plane(streams, offsets, 2, 2)
    np.testing.assert_array_equal(seeds.numpy().view(np.uint32), np.asarray(jseeds))
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_plane_scan_kernel_round_trip(synthetic, cuda):
    d = synthetic
    _assert_decoded(_port_roundtrip(d, d["prior"], cuda), d["syms"], d["counts"])


def test_plane_scan_kernel_matches_ref(synthetic, cuda):
    d = synthetic
    streams, offsets = jwide._rans_encode_plane(d["spec"], d["syms"], d["enc_rows"], d["counts"],
                                                len(d["counts"]), d["prior"])
    seeds, wins = tdec.stage_plane(streams, list(offsets), d["idx"], d["steps"], device=cuda)
    args = (seeds, wins, _t(d["counts"], cuda), _t(d["ctx"], cuda), d["idx"], d["steps"],
            tuple(_t(p, cuda) for p in d["prior"]))
    for g, w in zip(tdec.plane_scan(*args), tdec.plane_scan_ref(*args), strict=True):
        assert torch.equal(g, w)


# ------------------------------------------------ priors outside u16

def _dst_plane(prior_value, seed=23):
    """Two blocks of the dst wire plane encoded by the JAX package's numpy
    encoder (int64 tables) under a one-row prior of random values around
    prior_value: (symbols, ctx, counts, steps, streams, offsets, prior)."""
    rng = np.random.default_rng(seed)
    spec = jwide.PLANES[4]
    counts = np.array([300, 41])
    steps = jwide.padded_steps(int(counts.max()), spec.lanes)
    syms = np.zeros((2, steps * spec.lanes), np.int64)
    for b, n in enumerate(counts):
        syms[b, :n] = rng.integers(0, spec.alphabets[0], n)
    ctx = np.zeros_like(syms)
    prior = [np.asarray(prior_value + rng.integers(0, 1000, (1, spec.alphabets[0])), np.int64)]
    streams, offsets = jwide._rans_encode_plane(spec, [syms], [ctx], counts, 2, prior)
    return syms, ctx, counts, steps, streams, offsets, prior


@pytest.mark.parametrize("value", [200_000, -500], ids=["200000", "negative"])
def test_plane_scan_refuses_priors_outside_u16(value):
    """A prior value past 65535 or below 0 raises ValueError, as
    plane_scan_fused does; JAX's int32 carries wrap past ~131,071, so its
    symbols for the 200,000 prior do not decode the input: there is no
    single answer to match."""
    syms, ctx, counts, steps, streams, offsets, prior = _dst_plane(value)
    seeds, wins = tdec.stage_plane(streams, list(offsets), 4, steps, device="cpu")
    with pytest.raises(ValueError, match="plane_scan: prior values must be in 0..65535"):
        tdec.plane_scan(seeds, wins, _t(counts), _t(ctx), 4, steps, (_t(prior[0]),))
    if value > 0:
        jseeds, jwins = jdec.stage_plane(streams, list(offsets), 4, steps)
        (want,) = jdec.plane_scan(jseeds, jwins, jnp.asarray(counts, jnp.int32),
                                  jnp.asarray(ctx, jnp.int32), 4, steps,
                                  (jnp.asarray(prior[0], jnp.int32),))
        live = np.arange(syms.shape[1])[None, :] < counts[:, None]
        assert not np.array_equal(np.where(live, np.asarray(want), 0), syms)


@pytest.mark.parametrize("fill", ["zero", "max", "mixed"])
def test_plane_scan_priors_at_u16_edges_match_jax(fill):
    """Priors of exactly 0 and 65535 (the check's edges) decode as JAX's."""
    rng = np.random.default_rng(5)
    spec = jwide.PLANES[4]
    a = spec.alphabets[0]
    prior = {"zero": np.zeros((1, a), np.int64), "max": np.full((1, a), 65535, np.int64),
             "mixed": rng.choice([0, 65535], (1, a))}[fill]
    syms, ctx, counts, steps, streams, offsets, _ = _dst_plane(0)
    streams, offsets = jwide._rans_encode_plane(spec, [syms], [ctx], counts, 2, [prior])
    got, want = _both(streams, offsets, counts, ctx, 4, steps, [prior])
    np.testing.assert_array_equal(got[0], want[0])
    _assert_decoded(got, [syms], counts)


# ------------------------------- csrc/plane_decode.cu's rules in numpy

KERNEL_SRC = tdec.__file__.replace("ops/wide_decode.py", "csrc/plane_decode.cu")


def test_plane_decode_constants_match_kernel_source():
    import re

    src = open(KERNEL_SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))

    assert const("RING") == tdec.PD_RING
    assert const("MAX_CLEN") == tdec.PD_MAX_CLEN == twide.CHUNK_STEPS
    assert const("MAX_R") == tdec.PLANE_MAX_READS
    assert const("PD_FIELDS") == tdec.PD_FIELDS == 9 * tdec.PLANE_MAX_READS + 4 + 16
    assert (const("KIND_REG"), const("KIND_BITMAP"), const("KIND_SEARCH")) == (
        tdec.PD_REG, tdec.PD_BITMAP, tdec.PD_SEARCH)
    assert tdec.PD_TB_BYTES == 8 * (512 + 512 // 8)  # NTB words of 8 bytes


# name -> (spec fields, window width, (warp path, lanes a thread, kinds, keyed))
LAYOUTS = {
    "tok": (("tok", 64, 1, (4,), (1,)), 72, (True, 2, ("reg",), False)),
    "lit": (("lit", 64, 1, (256,), (1,)), 352, (True, 2, ("bitmap",), False)),
    "len": (("len", 32, 1, (8,), (1,)), 64, (True, 1, ("reg",), False)),
    "lex": (("lex", 16, 1, (256,), (1,)), 48, (True, 1, ("bitmap",), False)),
    "dst": (("dst", 32, 1, (64,), (1,)), 88, (True, 1, ("bitmap",), False)),
    "four_row": (("dst", 8, 1, (16,), (4,)), 40, (True, 1, ("search",), True)),
    "two_read": (("dst", 24, 2, (8, 16), (4, 32)), 176, (True, 1, ("search", "search"), True)),
    "lit_two_read": (("lit", 16, 2, (16, 16), (1, 16)), 96, (True, 1, ("bitmap", "search"),
                                                                False)),
    "dst_one_row_later": (("dst", 16, 2, (8, 16), (1, 1)), 64, (True, 1, ("bitmap", "bitmap"),
                                                                   False)),
    "two_read_small": (("dst", 40, 2, (4, 4), (1, 1)), 8, (True, 2, ("bitmap", "bitmap"), False)),
    "wide_lanes": (("dst", 128, 1, (64,), (1,)), 424, (False, 1, (), False)),
    "odd_lanes": (("dst", 33, 1, (5,), (1,)), 13, (True, 2, ("reg",), False)),
    "past_2_14": (("lit", 16, 1, (16385,), (1,)), 8, (False, 1, (), False)),
    "warp_tables_too_big": (("dst", 64, 8, (250,) * 8, (8,) * 8), 4096, (False, 1, (), True)),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_plane_decode_layout_rule(case):
    """plane_decode_layout per spec: the path (64 lanes or fewer, tables
    within shared memory, alphabets up to 2^14), lanes a thread, each
    read's table (registers for one read of one row and at most 8
    symbols, a bitmap for other one-row reads, u16 fences searched for
    multi-row reads) and whether the context rows are staged; the warp
    path's regions 16-byte aligned, apart, and inside its shared bytes."""
    fields, WH, (warp, lpt, kinds, keyed) = LAYOUTS[case]
    spec = twide.PlaneSpec(*fields)
    lay = tdec.plane_decode_layout(spec, WH)
    names = {tdec.PD_REG: "reg", tdec.PD_BITMAP: "bitmap", tdec.PD_SEARCH: "search"}
    assert (lay.warp, lay.lpt, tuple(names[k] for k in lay.kinds), lay.ctx_at >= 0) == (
        warp, lpt, kinds, keyed)
    general = 4 * sum(n * (3 * a + 1) for a, n in zip(spec.alphabets, spec.rows))
    if not warp:
        assert lay.smem == general
        return
    regions = [(0, tdec.PD_RING * lay.slot * 4)]
    if keyed:
        regions.append((lay.ctx_at, lay.ctx_at + tdec.PD_RING * tdec.PD_MAX_CLEN * spec.lanes * 4))
    for (car, cnt, tab, stride), kind, a, n in zip(lay.tables, lay.kinds, spec.alphabets,
                                                  spec.rows):
        if kind == tdec.PD_REG:
            assert (car, cnt, tab, stride) == (0, 0, 0, 0) and n == 1 and a <= 8
            continue
        if kind == tdec.PD_BITMAP:  # one row; counts and spans a power of two a lane
            entries = tdec._row_entries(a)
            assert n == 1 and stride == tdec.PD_TB_BYTES + 4 * entries
            assert entries >= a and entries % 32 == 0 and (entries // 32) & (entries // 32 - 1) == 0
            assert a > 256 or entries // 32 == 1 << (-(-a // 32) - 1).bit_length()
        else:  # rows at an odd stride: a lane a row reads them without bank conflicts
            entries = n * (a | 1)
            assert n > 1 and stride == 2 * (a + 1)
        regions += [(car, car + 4 * entries), (cnt, cnt + 4 * entries), (tab, tab + n * stride)]
    regions.sort()
    assert all(lo % 16 == 0 for lo, _ in regions)
    assert all(hi <= lo2 for (_, hi), (lo2, _) in zip(regions, regions[1:]))
    assert regions[-1][1] <= lay.smem <= tdec.PLANE_MAX_SMEM


def test_plane_decode_layout_refuses_what_the_kernel_cannot_hold():
    for fields in (("dst", 8, 9, (4,) * 9, (1,) * 9), ("dst", 1025, 1, (4,), (1,)),
                   ("dst", 8, 1, (16384,), (8,))):
        with pytest.raises(ValueError):
            tdec.plane_decode_layout(twide.PlaneSpec(*fields), 8)


@pytest.mark.parametrize("L", [1, 8, 16, 24, 32, 33, 64, 128])
def test_ring_slot_holds_every_clamped_pair_index(L):
    """A chunk of at most 8 steps renormalises at most 8 R L times, so the
    clamped pair index min(rel + rank, WH - 1) of a renorming lane is below
    the ring's copy of the row, min(WH, 8 R L) pairs, for any pattern of
    renorms: all lanes, none, and random ones."""
    rng = np.random.default_rng(L)
    for R in (1, 2, 3, 8):
        for WH in sorted({1, 7, 8, 100, 8 * R * L - 1, 8 * R * L, 8 * R * L + 8, 4096} - {0}):
            lay = tdec.plane_decode_layout(twide.PlaneSpec("dst", L, R, (4,) * R, (1,) * R), WH)
            assert lay.ncopy == min(WH, 8 * R * L) and lay.ncopy <= WH
            assert lay.slot % 4 == 0 and lay.ncopy <= lay.slot < lay.ncopy + 4
            for ren in (np.ones((8, R, L), bool), np.zeros((8, R, L), bool),
                        rng.random((8, R, L)) < 0.7):
                rel, top = 0, -1
                for i in range(8):
                    for r in range(R):
                        m = ren[i, r]
                        rank = np.cumsum(m) - m
                        idx = np.minimum(rel + rank, WH - 1)
                        if m.any():
                            top = max(top, int(idx[m].max()))
                        rel += int(m.sum())
                assert top < lay.ncopy
                if ren.all():
                    assert top == min(8 * R * L - 1, WH - 1)


def _popc(v):
    return cs.ps_popc(v)


@pytest.mark.parametrize("A", [1, 2, 5, 8, 16, 64, 256, 1000])
def test_table_lookups_match_the_fence_search(A):
    """For every f in 0..2^14: the bitmap lookup (the fences before f's
    word plus the word's bits up to f), the branch-free search over u16
    fences (probes min(y + h, A) from the top power of two below A, fence
    A = 2^14 stopping every probe past A - 1) and, for A <= 8, the
    register table (7 compares, fences past A - 1 at 2^14) all give the
    symbol, start and freq that searchsorted finds, on uniform tables and
    on tables the kernel rebuilds from random carries (the multiply-high
    quotient), which equal _build_cdf's."""
    rng = np.random.default_rng(A)
    step = (1 << 14) // A
    uni = np.zeros((1, A + 1), np.int64)
    uni[0, :A] = np.arange(A) * step
    uni[0, A] = 1 << 14
    car = np.concatenate([np.zeros((1, A), np.int64), rng.integers(0, 1 << 16, (3, A)),
                          np.where(rng.random((2, A)) < 0.9, 0, 65535),
                          np.full((1, A), 65535)])
    fen = cs.ps_fences(car, A)
    np.testing.assert_array_equal(fen, tdec._build_cdf(torch.from_numpy(car), A).numpy())
    f = np.arange(1 << 14)
    mask = (np.uint64(2) << (f & 31).astype(np.uint64)) - np.uint64(1)
    for fe in np.concatenate([uni, fen]):
        want = np.searchsorted(fe[1:A], f, side="right")
        count, bits = cs.ps_bitmap(fe[None], A)
        y = count[0, f >> 5] + _popc(bits[0, f >> 5] & mask)
        np.testing.assert_array_equal(y, want)
        y = np.zeros_like(f)
        h = 1 << (A - 1).bit_length() - 1 if A > 1 else 0
        while h:
            n = np.minimum(y + h, A)
            y = np.where(fe[n] <= f, n, y)
            h >>= 1
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(fe[y + 1] - fe[y], fe[want + 1] - fe[want])
        if A <= 8:
            reg = np.full(8, 1 << 14)
            reg[1:A] = fe[1:A]
            ge = f[:, None] >= reg[None, 1:]
            y = ge.sum(1)
            lo = np.where(ge, reg[None, 1:], 0).max(1)
            hi = np.where(~ge, reg[None, 1:], 1 << 14).min(1)
            np.testing.assert_array_equal(y, want)
            np.testing.assert_array_equal(lo, fe[want])
            np.testing.assert_array_equal(hi - lo, fe[want + 1] - fe[want])


def test_multiply_high_quotient_is_exact_for_u16_carries():
    """The rebuild's quotient, carry (2^14 - alph) / (tot + 1) as the
    multiply-high by floor((2^32 - 1) / (tot + 1)) and one correction,
    equals floor division for carries 0..65535 (u16 priors; a chunk adds
    at most 8 L <= 512 to an entry, so (carry >> 1) + counts stays below
    2^16) at the edges of k (tot + 1), for totals up to 2^14 x 65535, the
    most a row of the warp path's alphabets (<= 2^14) can hold."""
    assert (65535 >> 1) + 8 * tdec.PD_WARP_LANES <= 65535
    rng = np.random.default_rng(9)
    top = (1 << 14) * 65535
    tot = np.concatenate([[0, 1, 2, 3, 63, 255, 65535, 65536, 4 * 65535, top],
                          rng.integers(0, top + 1, 3000)])
    for a in (1, 4, 8, 64, 256, 1 << 14):
        d = tot + 1
        nmax = 65535 * ((1 << 14) - a)
        for k in (0, 1, 2, 7):
            base = np.minimum(k * d, nmax)
            for n in (base, np.maximum(base - 1, 0), np.minimum(base + 1, nmax)):
                np.testing.assert_array_equal(cs.ps_quot(n, d), n // d)
        car = np.arange(65536)
        for dd in (1, 3, 65536, int(rng.integers(1, top + 2)), top + 1):
            n = car * ((1 << 14) - a)
            np.testing.assert_array_equal(cs.ps_quot(n, np.full_like(n, dd)), n // dd)


def test_launch_fields_follow_the_kernel_order():
    """_pd_fields writes each value where csrc/plane_decode.cu's
    parse_fields reads it: nine fields a read (unused reads zero), the
    four input pointers, then the sizes and the layout in the kernel's
    order."""
    import re

    spec = twide.PlaneSpec("dst", 24, 2, (8, 16), (4, 32))
    B, steps, WH = 3, 16, 40
    NC = len(twide.chunk_schedule(steps))
    z = lambda *shape: torch.zeros(*shape, dtype=torch.int32)
    seeds, wins, n_sym, ctx = z(B, 24), z(NC, B, WH), z(B), z(B, steps * 24)
    prior = (z(4, 8), None)
    outs = [z(B, steps * 24) for _ in range(2)]
    f = tdec._pd_fields(seeds, wins, n_sym, ctx, spec, steps, prior, outs)
    lay = tdec.plane_decode_layout(spec, WH)
    assert f.shape == (tdec.PD_FIELDS,) and f.dtype == np.int64
    for r in range(2):
        assert tuple(f[9 * r: 9 * r + 9]) == (
            (prior[r].data_ptr() if prior[r] is not None else 0), outs[r].data_ptr(),
            spec.alphabets[r], spec.rows[r], lay.kinds[r], *lay.tables[r])
    assert not f[18:72].any()
    assert tuple(f[72:76]) == tuple(t.data_ptr() for t in (seeds, wins, n_sym, ctx))
    src = open(KERNEL_SRC).read()
    names = [n for n, _ in sorted(re.findall(r"(?:P\.)?(\w+) = \(int\)v\[(\d+)\]", src),
                                  key=lambda m: int(m[1]))]
    assert names == ["B", "L", "R", "steps", "NC", "WH", "is_dst", "ncopy", "slot", "ctx_at",
                     "vec_win", "vec_ctx", "vec_out", "warp", "lpt", "smem"]
    assert tuple(f[76:]) == (B, 24, 2, steps, NC, WH, 1, lay.ncopy, lay.slot, lay.ctx_at,
                             int(wins.data_ptr() % 16 == 0), int(ctx.data_ptr() % 16 == 0),
                             int(all(o.data_ptr() % 16 == 0 for o in outs)), 1, 1, lay.smem)
