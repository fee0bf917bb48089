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
