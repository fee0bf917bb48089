"""Port device plane encode (nlzm_tpu_torch.ops.wide_encode_dev) against
the JAX one and the host encoders, exact: plane_encode on all five planes
with and without priors and on a synthetic 4-row plane; the block encode
against encode_wide_blocks_tpu, the numpy encode_wide_blocks and
native.wide_encode; the device-engine container against JAX's
engine="tpu" byte for byte, then round-tripped through the port's decode;
the timed pipeline; card-only kernel-vs-plain cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu import native as jnative
from nlzm_tpu.format import wide as jwide
from nlzm_tpu.ops import wide_encode_dev as jdev
from nlzm_tpu.parallel import blocks as jblocks
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.format import wide as twide
from nlzm_tpu_torch.ops import wide_encode_dev as tdev
from nlzm_tpu_torch.parallel import blocks as tblocks

torch.set_num_threads(1)

BLOCK = 16384


@pytest.fixture(scope="module")
def commands():
    """Native-parsed, lifted and rep-classified commands of 60 KB at 16 KiB
    blocks (the bench's device-encode input), and their batched planes."""
    data = build_nonperiodic(60_000)
    op_len, op_val = jnative.parse_blocks(data, BLOCK, 14)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    jnative.lift_deep(op_len, op_val, BLOCK)
    op_rep = jnative.classify_reps(op_len, op_val)
    _, batched, _ = jwide.batch_plane_arrays(op_len, op_val, op_rep)
    return op_len, op_val, op_rep, batched, jwide.build_priors_from_batched(batched)


def _jax_plane(syms, rows, counts, idx, steps, prior):
    return jdev.plane_encode(
        tuple(jnp.asarray(s, jnp.int32) for s in syms),
        tuple(None if r is None else jnp.asarray(r, jnp.int32) for r in rows),
        jnp.asarray(counts, jnp.int32), idx, steps,
        None if prior is None else tuple(jnp.asarray(p, jnp.int32) for p in prior))


def _port_plane(syms, rows, counts, idx, steps, prior, dtype=np.int32, device="cpu"):
    t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(device)
    return tdev.plane_encode(
        tuple(t(s, dtype) for s in syms),
        tuple(None if r is None else t(r, np.int32) for r in rows),
        t(counts, np.int32), idx, steps,
        None if prior is None else tuple(t(p, np.int32) for p in prior))


def _assert_same(got, want):
    seeds, pairs, mask = got
    js, jp, jm = (np.asarray(a) for a in want)
    assert seeds.dtype == pairs.dtype == torch.int32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(seeds.cpu().numpy().view(np.uint32), js)
    np.testing.assert_array_equal(pairs.cpu().numpy(), jp)
    np.testing.assert_array_equal(mask.cpu().numpy(), jm)


@pytest.mark.parametrize("with_priors", [False, True], ids=["no_priors", "priors"])
@pytest.mark.parametrize("plane", range(5), ids=[p.name for p in jwide.PLANES])
def test_plane_encode_matches_jax(commands, plane, with_priors):
    *_, batched, priors = commands
    spec = jwide.PLANES[plane]
    syms, rows, counts, _ = batched[spec.name]
    steps = syms[0].shape[1] // spec.lanes
    prior = priors[spec.name] if with_priors else None
    want = _jax_plane(syms, rows, counts, plane, steps, prior)
    # uint8 symbols, as the staging path uploads them
    _assert_same(_port_plane(syms, rows, counts, plane, steps, prior, np.uint8), want)


@pytest.fixture
def four_row_plane(monkeypatch):
    """The synthetic 4-row, 16-symbol spec of tests/test_wide.py, swapped
    into the plane table of both packages; random symbols and rows."""
    spec = jwide.PlaneSpec("dst", 8, 1, (16,), (4,))
    monkeypatch.setattr(jdev, "PLANES", jwide.PLANES[:4] + (spec,))
    monkeypatch.setattr(twide, "PLANES", twide.PLANES[:4] + (
        twide.PlaneSpec(spec.name, spec.lanes, spec.reads, spec.alphabets, spec.rows),))
    rng = np.random.default_rng(11)
    counts = np.array([300, 41])
    steps = jwide.padded_steps(int(counts.max()), spec.lanes)
    syms = np.zeros((2, steps * spec.lanes), np.int32)
    rows = np.zeros((2, steps * spec.lanes), np.int32)
    for b, n in enumerate(counts):
        syms[b, :n] = rng.integers(0, 16, n)
        rows[b, :n] = rng.integers(0, 4, n)
    prior = rng.integers(0, 200, (4, 16)).astype(np.int32)
    return syms, rows, counts, steps, prior


@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
def test_plane_encode_multirow_matches_jax(four_row_plane, with_prior):
    syms, rows, counts, steps, prior = four_row_plane
    pr = (prior,) if with_prior else None
    want = _jax_plane((syms,), (rows,), counts, 4, steps, pr)
    _assert_same(_port_plane((syms,), (rows,), counts, 4, steps, pr), want)


@pytest.mark.parametrize("with_priors", [False, True], ids=["no_priors", "priors"])
def test_encode_wide_blocks_device_matches(commands, with_priors):
    op_len, op_val, op_rep, *_ = commands
    got = tdev.encode_wide_blocks_device(op_len, op_val, op_rep, with_priors, device="cpu")
    assert got == jdev.encode_wide_blocks_tpu(op_len, op_val, op_rep, with_priors)
    assert got == jwide.encode_wide_blocks(op_len, op_val, op_rep, with_priors)
    assert got == jnative.wide_encode(op_len, op_val, op_rep, with_priors)


@pytest.mark.parametrize("name", ["text", "repetitive", "random", "zeros"])
def test_device_engine_container_matches_jax(corpus_samples, name):
    data = corpus_samples[name]
    kw = dict(block_size=4096, profile="wide", parser="greedy")
    got = tblocks.encode_container(data, engine="device", device="cpu", **kw)
    assert got == jblocks.encode_container(data, engine="tpu", **kw)
    assert tblocks.decode_container(got, device="cpu") == data


def test_device_engine_container_32k_blocks(corpus_text):
    """The bench block size: a 32 KiB block and a ragged one."""
    data = corpus_text(50_000)
    kw = dict(block_size=32768, profile="wide", parser="greedy")
    got = tblocks.encode_container(data, engine="device", device="cpu", **kw)
    assert got == jblocks.encode_container(data, engine="tpu", **kw)
    assert tblocks.decode_container(got, device="cpu") == data


def test_device_engine_empty():
    kw = dict(block_size=4096, profile="wide", parser="greedy")
    got = tblocks.encode_container(b"", engine="device", device="cpu", **kw)
    assert got == jblocks.encode_container(b"", engine="tpu", **kw)
    assert tblocks.decode_container(got, device="cpu") == b""


def test_encode_pipeline_device_runs():
    """The timed pipeline: native parse, staging, the five plane encodes;
    its staged arguments encode to native.wide_encode's payloads."""
    data = build_nonperiodic(40_000)
    run, parse_s, stage, first_s = tdev.encode_pipeline_device(data, BLOCK, 14, device="cpu")
    assert parse_s > 0 and first_s > 0
    assert run() == run() > 0
    stage()
    assert run() > 0


def test_staged_planes_match_native(commands):
    """stage_plane + plane_encode + plane_streams, the pieces the pipeline
    and the block encode share, give native.wide_encode's plane streams."""
    op_len, op_val, op_rep, *_ = commands
    per_block, batched, counts = twide.batch_plane_arrays(op_len, op_val, op_rep)
    priors = twide.build_priors_from_batched(batched)
    streams, offsets = [], []
    for i, spec in enumerate(twide.PLANES):
        args = tdev.stage_plane(batched, priors, i, "cpu")
        s, o = tdev.plane_streams(spec, args[4], *tdev.plane_encode(*args))
        streams.append(s)
        offsets.append(o)
    want, _ = jnative.wide_encode(op_len, op_val, op_rep)
    assert twide.assemble_payloads(per_block, counts, streams, offsets) == want


@pytest.mark.parametrize("with_priors", [False, True], ids=["no_priors", "priors"])
def test_plane_encode_planes_matches_jax(commands, with_priors):
    """The five-plane entry (its plain path on the CPU) against JAX's
    plane_encode plane by plane; block 0 with no symbol, block 1 with
    steps x L (every slot live, the padding's zeros included)."""
    *_, batched, priors = commands
    staged, want = [], []
    for plane, spec in enumerate(jwide.PLANES):
        syms, rows, counts, _ = batched[spec.name]
        steps = syms[0].shape[1] // spec.lanes
        counts = np.array(counts, np.int32)
        counts[0], counts[1] = 0, steps * spec.lanes
        prior = priors[spec.name] if with_priors else None
        want.append(_jax_plane(syms, rows, counts, plane, steps, prior))
        t = lambda a, dt: torch.from_numpy(np.array(a, dt))
        staged.append((tuple(t(y, np.uint8) for y in syms),
                       tuple(None if r is None else t(r, np.int32) for r in rows),
                       t(counts, np.int32), plane, steps,
                       None if prior is None else tuple(t(p, np.int32) for p in prior)))
    got = tdev.plane_encode_planes(staged)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert tdev.plane_encode.launches == 0


def test_plane_encode_planes_refuses_bad_arguments(commands):
    """Argument checks raise ValueError; no launch is counted."""
    *_, batched, priors = commands
    staged = [tdev.stage_plane(batched, priors, i, "cpu") for i in range(5)]
    meta = lambda a: tuple(None if x is None else torch.empty_like(x, device="meta") for x in a)
    on_meta = lambda a: (meta(a[0]), meta(a[1]), torch.empty_like(a[2], device="meta"), a[3],
                         a[4], None if a[5] is None else meta(a[5]))
    bad = {
        "no planes": [],
        "six planes": staged + staged[:1],
        "short tuple": [staged[0][:5]],
        "mixed devices": staged[:4] + [on_meta(staged[4])],
        "not cuda": [on_meta(a) for a in staged],
        "int64 counts": [on_meta(staged[0])[:2] + (torch.empty(7, dtype=torch.int64,
                                                               device="meta"),)
                         + staged[0][3:]],
    }
    for name, planes in bad.items():
        with pytest.raises(ValueError):
            tdev.plane_encode_planes(planes)
    assert tdev.plane_encode.launches == 0


def test_plane_encode_launches_stay_zero_on_cpu(commands):
    *_, batched, priors = commands
    staged = [tdev.stage_plane(batched, priors, i, "cpu") for i in range(5)]
    tdev.plane_encode(*staged[2])
    tdev.plane_encode_planes(staged[2:4])
    assert tdev.plane_encode.launches == 0


def _shipping_steps():
    """The plane steps of the 8 MB bench input at 32 KiB blocks
    (chip_smoke.py's kernels_enc: tok 264, lit 224, len and dst 112, lex
    24)."""
    return dict(tok=264, lit=224, len=112, dst=112, lex=24)


@pytest.mark.parametrize("case", ["shipping", "all_literal_128k", "four_row", "two_read",
                                  "two_read_large", "empty", "past_smem"])
def test_plane_layout_rule(case):
    """plane_layout keeps every shipping plane in shared memory, sends a 128
    KiB all-literal block's lit plane (2048 steps, 258 chunks) to the
    large path (device scratch) and keeps its tok plane; a plane whose
    one chunk of fences passes shared memory raises."""
    specs = {p.name: p for p in twide.PLANES}
    spec4 = twide.PlaneSpec("dst", 8, 1, (16,), (4,))
    spec2 = twide.PlaneSpec("dst", 24, 2, (8, 16), (4, 32))
    if case == "shipping":
        for name, steps in _shipping_steps().items():
            smem, large, scratch = tdev.plane_layout(specs[name], steps)
            assert not large and scratch == 0 and 0 < smem <= 64 << 10
        return
    if case == "all_literal_128k":
        steps = twide.padded_steps(131072, 64)
        assert steps == 2048 and len(twide.chunk_schedule(steps)) == 258
        smem, large, scratch = tdev.plane_layout(specs["lit"], steps)
        assert large and smem == tdev._align16(258 * 257 * 2) <= tdev.PE_SMEM_MAX
        assert scratch == 258 * 256 * 4 + tdev._align16(258 * 257 * 2)
        smem, large, scratch = tdev.plane_layout(specs["tok"], steps)
        assert not large and scratch == 0 and smem == 131072 + 258 * 4 * 4 + tdev._align16(
            258 * 5 * 2) <= tdev.PE_SMEM_MAX
        return
    if case == "four_row":
        smem, large, _ = tdev.plane_layout(spec4, 504)
        nc = len(twide.chunk_schedule(504))
        assert nc == 65 and not large
        assert smem == 504 * 8 + nc * 64 * 4 + tdev._align16(nc * 68 * 2)
        return
    if case == "two_read":  # read 1 keys 32 x 16 = 512 entries: u16 keys
        smem, large, _ = tdev.plane_layout(spec2, 176)
        nc = len(twide.chunk_schedule(176))
        assert not large and smem == 176 * 24 * 2 * 2 + nc * 544 * 4 + tdev._align16(
            nc * 580 * 2)
        return
    if case == "two_read_large":  # chip_smoke.check_pe_large: 1672 steps, fences in 2 windows
        smem, large, scratch = tdev.plane_layout(spec2, 1672)
        nc = len(twide.chunk_schedule(1672))
        assert nc == 211 and large and smem == tdev.PE_SMEM_MAX
        assert scratch == nc * 544 * 4 + tdev._align16(nc * 580 * 2)
        assert -(-nc // (smem // (2 * 580))) == 2
        return
    if case == "empty":
        assert tdev.plane_layout(specs["lit"], 0) == (tdev._align16(256 * 4) + tdev._align16(
            257 * 2), False, 0)
        return
    with pytest.raises(ValueError):
        tdev.plane_layout(twide.PlaneSpec("dst", 8, 1, (16384,), (8,)), 8)


def test_plane_encode_chunk_formulas_match_schedule():
    """csrc/plane_encode.cu's chunk_of(s) (a step's chunk), chunk_start(k)
    (a chunk's first step) and its chunk count, chunk_of(steps - 1) + 1,
    copied here, agree with format/wide.py's chunk_schedule for steps 0 to
    4096."""

    def chunk_of(s):
        return (s.bit_length() - 1 if s else 0) if s < 16 else (s >> 3) + 2

    def chunk_start(k):
        return (1 << k if k else 0) if k < 4 else 8 * k - 16

    for steps in range(4097):
        sched = twide.chunk_schedule(steps)
        starts = np.concatenate([[0], np.cumsum(sched)]).astype(int)
        assert (chunk_of(steps - 1) + 1 if steps else 1) == max(len(sched), 1)
        assert [chunk_start(k) for k in range(len(sched) + 1)] == list(starts)
    sched = twide.chunk_schedule(4096)
    owner = np.repeat(np.arange(len(sched)), sched)
    assert [chunk_of(s) for s in range(len(owner))] == list(owner)


@pytest.mark.parametrize("case", ["shipping", "all_literal_128k", "two_specs"])
def test_plane_launch_plan_covers_every_block_once(case):
    """launch_plan gives every (plane, block) one CTA, the longest chains
    first, disjoint scratch to the large planes, and shared bytes for the
    largest in-memory plane."""
    specs = list(twide.PLANES)
    if case == "shipping":
        shapes = [(s, _shipping_steps()[s.name], 245) for s in specs]
    elif case == "all_literal_128k":
        shapes = [(s, st, 8) for s, st in zip(specs, (2048, 2048, 24, 8, 16))]
    else:
        shapes = [(twide.PlaneSpec("dst", 24, 2, (8, 16), (4, 32)), 176, 3),
                  (specs[1], 2048, 5), (specs[0], 8, 0), (specs[1], 2048, 2)]
    plan, smem, scratch = tdev.launch_plan(shapes)
    assert sorted(i for i, *_ in plan) == list(range(len(shapes)))
    chains = [shapes[i][1] * shapes[i][0].reads for i, *_ in plan]
    assert chains == sorted(chains, reverse=True)
    owner, used = {}, []
    for i, cta0, large, offset in plan:
        spec, steps, B = shapes[i]
        need, want_large, per_block = tdev.plane_layout(spec, steps)
        assert large == want_large and need <= smem
        for b in range(B):
            assert cta0 + b not in owner
            owner[cta0 + b] = (i, b)
        if large:
            used.append((offset, offset + B * per_block))
    assert sorted(owner) == list(range(sum(B for *_, B in shapes)))
    used.sort()
    assert all(a[1] <= b[0] for a, b in zip(used, used[1:]))
    assert scratch == sum(e - s for s, e in used)
    assert (case != "shipping") == bool(used)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("with_priors", [False, True], ids=["no_priors", "priors"])
def test_plane_encode_kernel_matches_ref(commands, cuda, with_priors):
    *_, batched, priors = commands
    for i in range(5):
        args = tdev.stage_plane(batched, priors if with_priors else None, i, cuda)
        for g, w in zip(tdev.plane_encode(*args), tdev.plane_encode_ref(*args)):
            assert torch.equal(g, w)


def test_plane_encode_kernel_multirow(four_row_plane, cuda):
    syms, rows, counts, steps, prior = four_row_plane
    t = lambda a: torch.from_numpy(np.array(a, np.int32)).to(cuda)
    args = ((t(syms),), (t(rows),), t(counts), 4, steps, (t(prior),))
    for g, w in zip(tdev.plane_encode(*args), tdev.plane_encode_ref(*args)):
        assert torch.equal(g, w)


# ------------------------------------------------ priors outside u16

def _bad_priors(priors, value):
    """The priors with one dst entry set to `value` (numpy, host)."""
    bad = {k: [np.array(a) for a in v] for k, v in priors.items()}
    bad["dst"][0][0, 5] = value
    return bad


@pytest.mark.parametrize("value", [200_000, -1], ids=["200000", "negative"])
def test_plane_encode_refuses_priors_outside_u16(commands, value):
    """plane_encode, plane_encode_planes and stage_plane (on the host
    array, before the upload) raise ValueError for a prior value outside
    0..65535, as plane_scan and plane_scan_fused do; no launch is
    counted."""
    *_, batched, priors = commands
    bad = _bad_priors(priors, value)
    with pytest.raises(ValueError, match="stage_plane: prior values must be in 0..65535"):
        tdev.stage_plane(batched, bad, 4, "cpu")
    staged = [tdev.stage_plane(batched, priors, i, "cpu") for i in range(5)]
    args = staged[4][:5] + ((torch.from_numpy(bad["dst"][0].astype(np.int32)),),)
    with pytest.raises(ValueError, match="plane_encode: prior values must be in 0..65535"):
        tdev.plane_encode(*args)
    with pytest.raises(ValueError, match="plane_encode_planes: prior values must be in 0..65535"):
        tdev.plane_encode_planes(staged[:4] + [args])
    assert tdev.plane_encode.launches == 0


@pytest.mark.parametrize("fill", ["zero", "max"])
def test_plane_encode_priors_at_u16_edges_match_jax(commands, fill):
    """Priors of exactly 0 and 65535 (the check's edges) encode as JAX's,
    through plane_encode and plane_encode_planes."""
    *_, batched, priors = commands
    staged, want = [], []
    for plane, spec in enumerate(jwide.PLANES):
        syms, rows, counts, _ = batched[spec.name]
        steps = syms[0].shape[1] // spec.lanes
        prior = [np.full(p.shape, 0 if fill == "zero" else 65535, np.int64)
                 for p in priors[spec.name]]
        want.append(_jax_plane(syms, rows, counts, plane, steps, prior))
        _assert_same(_port_plane(syms, rows, counts, plane, steps, prior, np.uint8), want[-1])
        staged.append(tdev.stage_plane(batched, {spec.name: prior}, plane, "cpu"))
    for g, w in zip(tdev.plane_encode_planes(staged), want, strict=True):
        _assert_same(g, w)


def test_wide_encode_checks_priors_on_the_host_only(commands, monkeypatch):
    """The wide device encode checks its priors once, on the host arrays
    before their upload (stage_plane), and never on a tensor (a CUDA
    tensor would cost a copy back)."""
    op_len, op_val, op_rep, *_ = commands
    seen = []
    check = tdev._check_priors
    monkeypatch.setattr(tdev, "_check_priors",
                        lambda pri, name: (seen.append((name, [type(a) for a in pri])),
                                           check(pri, name)))
    got = tdev.encode_wide_blocks_device(op_len, op_val, op_rep, True, device="cpu")
    assert got == jwide.encode_wide_blocks(op_len, op_val, op_rep, True)
    assert [name for name, _ in seen] == ["stage_plane"] * 5
    assert all(t is np.ndarray for _, types in seen for t in types)
