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
