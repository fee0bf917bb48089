"""Port optimal device parse (nlzm_tpu_torch.ops.encode_ops: dp_parse,
dp_cover, measure_costs, the calibrated parse) against the JAX functions,
exact: each function in every calibration round of the JAX parse of the
corpus samples at 4 KiB blocks; dp_parse on hand-made cost rows (ties
between lengths and between candidates, sums that wrap i32) and on
chip_smoke.py's fuzz sets (fuzz_opt; fuzz_dp_runs, the runs, short and
long reaches that csrc/dp_parse.cu takes apart); dp_cover on hostile choices; measure_costs on
the fuzz set, where JAX's own float32 rounding may sit on the other side
of a .5 edge; device checks of the wrappers; card-only kernel-vs-plain
cases. The entry points of the optimal parse are in
tests/test_torch_optimal_encode.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DP_RUNS_MAX_LENS, dp_steps, fuzz_dp_runs, fuzz_opt
from nlzm_tpu.ops import encode_ops as jenc
from nlzm_tpu_torch.ops import encode_ops as tenc

torch.set_num_threads(1)

SAMPLES = ("text", "repetitive", "random", "zeros", "tiny")
N4K = 4096


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


@pytest.fixture(scope="module")
def rounds(corpus_samples):
    """The JAX calibrated parse of all samples' 4 KiB blocks in one batch,
    round by round: {"blocks": {sample: slice}, "arr", "nv", "delta",
    "mlen", "rounds": [dict(costs, choice_len, choice_cand, op_len,
    op_val[, op_rep, spans, costs_out])]}, numpy."""
    parts, where, b0 = [], {}, 0
    for name in SAMPLES:
        arr, nv = jenc._blocks_arrays(corpus_samples[name], N4K)
        parts.append((arr, nv))
        where[name] = slice(b0, b0 + len(nv))
        b0 += len(nv)
    arr = np.concatenate([a for a, _ in parts])
    nv = np.concatenate([v for _, v in parts])
    dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
    delta, mlen = jenc.find_matches(dj, nvj, N4K - 1, num_cands=3)
    costs, out = None, []
    for i in range(3):
        cl, cc = jenc.dp_parse(delta, mlen, nvj, costs)
        ol, ov = jenc.dp_cover(dj, delta, cl, cc, nvj, N4K)
        r = dict(costs=None if costs is None else np.asarray(costs), choice_len=np.asarray(cl),
                 choice_cand=np.asarray(cc), op_len=np.asarray(ol), op_val=np.asarray(ov))
        if i < 2:
            rep = jenc.repify(ol, ov)
            spans, _, _ = jenc.emit_model(ol, ov, rep)
            costs = jenc.measure_costs(spans, ol, ov, rep)
            r.update(op_rep=np.asarray(rep), spans=np.asarray(spans).view(np.int32),
                     costs_out=np.asarray(costs))
        out.append(r)
    return dict(blocks=where, arr=arr, nv=nv, delta=np.asarray(delta), mlen=np.asarray(mlen),
                rounds=out)


@pytest.mark.parametrize("rnd", [0, 1, 2])
@pytest.mark.parametrize("name", SAMPLES)
def test_dp_parse_matches_jax(rounds, name, rnd):
    s = rounds["blocks"][name]
    r = rounds["rounds"][rnd]
    costs = None if r["costs"] is None else _t(r["costs"][s])
    cl, cc = tenc.dp_parse(_t(rounds["delta"][s]), _t(rounds["mlen"][s]), _t(rounds["nv"][s]),
                           costs)
    assert cl.dtype == cc.dtype == torch.int32
    np.testing.assert_array_equal(cl.numpy(), r["choice_len"][s])
    np.testing.assert_array_equal(cc.numpy(), r["choice_cand"][s])


@pytest.mark.parametrize("rnd", [0, 1, 2])
@pytest.mark.parametrize("name", SAMPLES)
def test_dp_cover_matches_jax(rounds, name, rnd):
    s = rounds["blocks"][name]
    r = rounds["rounds"][rnd]
    ol, ov = tenc.dp_cover(_t(rounds["arr"][s]), _t(rounds["delta"][s]), _t(r["choice_len"][s]),
                           _t(r["choice_cand"][s]), _t(rounds["nv"][s]), N4K)
    assert ol.dtype == ov.dtype == torch.int32
    np.testing.assert_array_equal(ol.numpy(), r["op_len"][:, s])
    np.testing.assert_array_equal(ov.numpy(), r["op_val"][:, s])


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("name", SAMPLES)
def test_measure_costs_matches_jax(rounds, name, rnd):
    s = rounds["blocks"][name]
    r = rounds["rounds"][rnd]
    got = tenc.measure_costs(_t(r["spans"][:, s]), _t(r["op_len"][:, s]), _t(r["op_val"][:, s]),
                             _t(r["op_rep"][:, s]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), r["costs_out"][s])


def test_calibration_moves_the_costs(rounds):
    """The measured rows differ from the defaults and between rounds, so
    the rounds above test the [B, 6] path of dp_parse."""
    c0, c1 = (rounds["rounds"][i]["costs_out"] for i in (0, 1))
    assert (c0 != np.asarray(jenc.default_dp_costs())).any() and (c0 != c1).any()


def _hand_made_dp():
    """[B, N, C] candidates and [B, 6] cost rows: ties between lengths
    (slope 0, LEN_BASE == LEN_ESC, and a zero window past N), ties
    between candidates (equal distances, and distances of one slot), and
    rows near the i32 limits whose sums wrap."""
    B, N, C = 6, 300, 3
    rng = np.random.default_rng(3)
    delta = np.zeros((B, N, C), np.int32)
    mlen = np.zeros((B, N, C), np.int32)
    for b in range(B):
        for p in range(N):
            d = int(rng.choice([1, 5, 8, 300, 5000, 70000]))
            delta[b, p] = [d, d, d + (b % 3)]  # equal, or one-slot distances
            mlen[b, p] = [rng.integers(0, 280), rng.integers(0, 280), rng.integers(0, 10)]
    big, low = 2**31 - 1, -(2**31)
    costs = np.array([
        [96, 32, 32, 0, 32, 88],  # every direct length costs the same as an escape
        [96, 32, 32, 4, 176, 88],
        [big, 0, 0, 0, 0, 0],  # literal sums wrap negative
        [0, big - 40, 30, 5, big, 10],  # match sums wrap
        [low, low, low, 1, low, low],
        [5, -20, 3, -7, 9, -100],  # negative costs
    ], np.int32)
    n_valid = np.array([N, N, 250, 1, 0, 299], np.int32)
    return delta, mlen, n_valid, costs


def test_dp_parse_hand_made_costs_match_jax():
    delta, mlen, n_valid, costs = _hand_made_dp()
    jl, jc = jenc.dp_parse(jnp.asarray(delta), jnp.asarray(mlen), jnp.asarray(n_valid),
                           jnp.asarray(costs))
    tl, tc = tenc.dp_parse(_t(delta), _t(mlen), _t(n_valid), _t(costs))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the rows take matches, literals and ties broken towards later candidates
    assert (np.asarray(jl)[:2] > 0).any() and (np.asarray(jc) > 0).any()


@pytest.mark.parametrize("max_len", [1, 20, 64, 100, 264, 400])
def test_dp_parse_max_len_matches_jax(rounds, max_len):
    s = rounds["blocks"]["text"]
    delta, mlen, nv = rounds["delta"][s], rounds["mlen"][s], rounds["nv"][s]
    jl, jc = jenc.dp_parse(jnp.asarray(delta), jnp.asarray(mlen), jnp.asarray(nv),
                           max_len=max_len)
    tl, tc = tenc.dp_parse(_t(delta), _t(mlen), _t(nv), max_len=max_len)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.fixture(scope="module")
def fuzz():
    return {seed: fuzz_opt(seed) for seed in (7, 8)}  # chip_smoke.py holds the kernels on 7


@pytest.mark.parametrize("with_costs", [False, True])
@pytest.mark.parametrize("seed", [7, 8])
def test_dp_parse_fuzz_matches_jax(fuzz, seed, with_costs):
    f = fuzz[seed]
    costs = f["costs"] if with_costs else None
    jl, jc = jenc.dp_parse(jnp.asarray(f["delta"]), jnp.asarray(f["mlen"]),
                           jnp.asarray(f["n_valid"]), None if costs is None else jnp.asarray(costs))
    tl, tc = tenc.dp_parse(_t(f["delta"]), _t(f["mlen"]), _t(f["n_valid"]),
                           None if costs is None else _t(costs))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", [7, 8])
def test_dp_cover_hostile_choices_match_jax(fuzz, seed):
    """choice_cand outside [0, C) selects distance 0; choice_len jumps
    past n_valid and N; rows past the end carry the byte at the end."""
    f = fuzz[seed]
    args = (f["data"], f["delta"], f["choice_len"], f["choice_cand"], f["n_valid"])
    T = f["data"].shape[1] + 64
    jl, jv = jenc.dp_cover(*(jnp.asarray(a) for a in args), T)
    tl, tv = tenc.dp_cover(*(_t(a) for a in args), T)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    cand_used = (f["choice_cand"] < 0) | (f["choice_cand"] >= 3)
    assert cand_used.any() and (np.asarray(jl) == -1).any()


@jax.jit
def _jax_unrounded_costs(spans, op_len, op_val, op_rep):
    """nlzm_tpu/ops/encode_ops.py:321 measure_costs, the same operations,
    stopped before the rounding."""
    freq = (spans >> 16).astype(jnp.float32)
    bits16 = jnp.where(spans != 0, (14.0 - jnp.log2(jnp.maximum(freq, 1.0))) * 16.0, 0.0)
    is_lit = op_len == 0
    is_match = op_len > 0
    is_dict = is_match & (op_rep < 0)
    delta = jnp.maximum(op_val, 1)
    mmin = 2 + (delta > 0xFF).astype(jnp.int32) + (delta > 0xFFF).astype(jnp.int32) + (
        delta > 0xFFFFF).astype(jnp.int32)
    esc = is_match & ((op_len - mmin) >= 7)

    def avg(total, mask):
        cnt = jnp.sum(mask.astype(jnp.float32), axis=0)
        return jnp.sum(total * mask.astype(jnp.float32), axis=0) / jnp.maximum(cnt, 1.0)

    return jnp.stack([
        avg(jnp.sum(bits16[:, :, 0:3], axis=2), is_lit), avg(bits16[:, :, 0], is_match),
        avg(bits16[:, :, 1], is_match & ~esc), jnp.full(op_len.shape[1:], 4.0),
        avg(jnp.sum(bits16[:, :, 1:4], axis=2), esc),
        avg(jnp.sum(bits16[:, :, 4:6], axis=2), is_dict)], axis=1)


@pytest.mark.parametrize("seed", [7, 8, 9, 10])
def test_measure_costs_fuzz_matches_jax(seed):
    """Spans with freq 0, above 2^14 and up to 65535. Where the port's
    exact average and JAX's float32 one round apart, JAX's unrounded value
    must lie within 1e-3 of a .5 edge (ROADMAP.md queue C logs the
    cases)."""
    spans, op_len, op_val, op_rep = fuzz_opt(seed)["commands"]
    jargs = (jnp.asarray(spans.view(np.uint32)), jnp.asarray(op_len), jnp.asarray(op_val),
             jnp.asarray(op_rep))
    want = np.asarray(jenc.measure_costs(*jargs))
    got = tenc.measure_costs(_t(spans), _t(op_len), _t(op_val), _t(op_rep)).numpy()
    differ = got != want
    if differ.any():
        raw = np.asarray(_jax_unrounded_costs(*jargs))[differ]
        assert np.abs(np.abs(raw - np.floor(raw)) - 0.5).max() < 1e-3, (raw, got[differ])
        assert np.abs(got[differ] - want[differ]).max() == 1
    assert (spans != 0).any() and ((spans.view(np.uint32) >> 16) > 1 << 14).any()


def test_measure_costs_rounds_half_to_even():
    """Averages exactly on a .5 edge: 32 literals whose spans cost 16
    (1/16 bit, freq 2^13) once or three times, else nothing, average 0.5
    and 1.5 and round to the even neighbours 0 and 2. JAX's float32 log2
    of 2^13 is not exactly 13 on the CPU, so its own average lands just
    off the edge (block 0 rounds to 1 there): the case ROADMAP.md queue C
    logs."""
    T, B = 32, 2
    spans = np.zeros((T, B, 6), np.uint32)
    spans[0, 0, 0] = 1 << 29
    spans[:3, 1, 1] = 1 << 29
    op_len = np.zeros((T, B), np.int32)
    op_val = np.full((T, B), 65, np.int32)
    op_rep = np.full((T, B), -1, np.int32)
    got = tenc.measure_costs(_t(spans.view(np.int32)), _t(op_len), _t(op_val), _t(op_rep))
    assert got[:, 0].tolist() == [0, 2]
    jargs = tuple(jnp.asarray(a) for a in (spans, op_len, op_val, op_rep))
    raw = np.asarray(_jax_unrounded_costs(*jargs))[:, 0]
    np.testing.assert_allclose(raw, [0.5, 1.5], atol=1e-3)
    assert np.abs(np.asarray(jenc.measure_costs(*jargs))[:, 0] - [0, 2]).max() <= 1


@pytest.mark.parametrize("T,B,sms", [(8192, 1024, 132), (32768, 245, 132), (8192, 256, 132),
                                     (8192, 8, 132), (77, 3, 132), (4096, 16, 1), (0, 5, 132),
                                     (1, 1, 132), (131072, 7, 132), (300, 1030, 16)])
def test_cost_split_covers_every_step_once(T, B, sms):
    """measure_costs' grid rule: every (block, step) in exactly one CTA's
    range, ranges a whole number of 32-step passes, no more CTAs than one
    wave of MC_CTAS_PER_SM an SM unless a group takes all T steps."""
    groups, splits, rows = tenc.cost_split(T, B, sms)
    assert groups == -(-B // tenc.MC_G) and rows % tenc.MC_ROWS == 0 and 1 <= splits <= 65535
    assert splits == 1 or groups * splits <= sms * tenc.MC_CTAS_PER_SM
    hits = np.zeros((B, T), np.int32)
    for g in range(groups):
        for s in range(splits):
            b0, t0 = g * tenc.MC_G, s * rows
            hits[b0 : min(B, b0 + tenc.MC_G), t0 : min(T, t0 + rows)] += 1
    assert (hits == 1).all()
    assert T == 0 or splits * rows - T < rows  # no empty range


def test_opt_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; meta tensors raise, and no
    launch is counted."""
    i32 = dict(dtype=torch.int32, device=torch.device("meta"))
    cand = torch.empty(2, 64, 3, **i32)
    bn = torch.empty(2, 64, **i32)
    with pytest.raises(ValueError):
        tenc.dp_parse(cand, cand, torch.empty(2, **i32))
    with pytest.raises(ValueError):
        tenc.dp_cover(torch.empty(2, 64, dtype=torch.uint8, device="meta"), cand, bn, bn,
                      torch.empty(2, **i32), 256)
    cmd = torch.empty(256, 2, **i32)
    with pytest.raises(ValueError):
        tenc.measure_costs(torch.empty(256, 2, 6, **i32), cmd, cmd, cmd)
    assert tenc.dp_parse.launches == tenc.dp_cover.launches == tenc.measure_costs.launches == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_dp_parse_and_cover_kernels_match_ref(rounds, cuda, rnd):
    r = rounds["rounds"][rnd]
    delta, mlen, nv = (_t(rounds[k]).to(cuda) for k in ("delta", "mlen", "nv"))
    costs = None if r["costs"] is None else _t(r["costs"]).to(cuda)
    got = tenc.dp_parse(delta, mlen, nv, costs)
    want = tenc.dp_parse_ref(delta, mlen, nv, costs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = (_t(rounds["arr"]).to(cuda), delta, *want, nv, N4K)
    assert all(torch.equal(g, w) for g, w in zip(tenc.dp_cover(*args), tenc.dp_cover_ref(*args)))


@pytest.mark.parametrize("rnd", [0, 1])
def test_measure_costs_kernel_matches_ref(rounds, cuda, rnd):
    r = rounds["rounds"][rnd]
    args = tuple(_t(r[k]).to(cuda) for k in ("spans", "op_len", "op_val", "op_rep"))
    assert torch.equal(tenc.measure_costs(*args), tenc.measure_costs_ref(*args))


@pytest.mark.parametrize("seed", [7, 8])
def test_opt_kernels_match_ref_on_fuzz(fuzz, cuda, seed):
    f = {k: v if k == "commands" else _t(v).to(cuda) for k, v in fuzz[seed].items()}
    for costs in (None, f["costs"]):
        got = tenc.dp_parse(f["delta"], f["mlen"], f["n_valid"], costs)
        want = tenc.dp_parse_ref(f["delta"], f["mlen"], f["n_valid"], costs)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = (f["data"], f["delta"], f["choice_len"], f["choice_cand"], f["n_valid"],
            f["data"].shape[1] + 64)
    assert all(torch.equal(g, w) for g, w in zip(tenc.dp_cover(*args), tenc.dp_cover_ref(*args)))
    cmds = tuple(_t(a).to(cuda) for a in f["commands"])
    assert torch.equal(tenc.measure_costs(*cmds), tenc.measure_costs_ref(*cmds))


@pytest.mark.parametrize("max_len", DP_RUNS_MAX_LENS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dp_parse_runs_match_jax(seed, max_len):
    """chip_smoke.fuzz_dp_runs, with its cost rows and the defaults: literal
    runs whose sums wrap and pass DP_BIG, short and long reaches, n_valid
    at a run's ends, max_len on both sides of the short reach."""
    f = fuzz_dp_runs(seed)
    for costs in (None, f["costs"]):
        jl, jc = jenc.dp_parse(jnp.asarray(f["delta"]), jnp.asarray(f["mlen"]),
                               jnp.asarray(f["n_valid"]),
                               None if costs is None else jnp.asarray(costs), max_len=max_len)
        tl, tc = tenc.dp_parse(_t(f["delta"]), _t(f["mlen"]), _t(f["n_valid"]),
                               None if costs is None else _t(costs), max_len)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_fuzz_dp_runs_covers_every_reach():
    """Block 0 and block 5 have no valid edge, block 1 reaches above 16 at
    every position and blocks 2-4 at most 16; the set holds positions of
    every reach class (none, <= 16, above), n_valid 0 and N, c_lit near
    both i32 limits, and blocks 2-5 hold the tame cost rows at and just
    past their limits (every entry 0..2^20, N * c_lit <= 2^27)."""
    f = fuzz_dp_runs(0)
    d, m = _t(f["delta"]), _t(f["mlen"])
    N = d.shape[1]
    for b in (0, 5):
        assert dp_steps(d[b:b + 1], m[b:b + 1]) == {"run": 1.0, "short": 0.0, "long": 0.0}
    assert dp_steps(d[1:2], m[1:2])["long"] == 1.0
    assert dp_steps(d[2:5], m[2:5])["short"] == 1.0
    assert all(v > 0.05 for v in dp_steps(d, m).values())
    nv, costs = f["n_valid"], f["costs"].astype(np.int64)
    assert (nv == 0).any() and (nv == N).any() and (nv[2:6] == N).all()
    c_lit = costs[:, 0]
    assert (c_lit > 2**31 - 301).any() and (c_lit < -(2**31) + 301).any()
    tame = (costs >= 0).all(1) & (costs <= 1 << 20).all(1) & (c_lit * N <= 1 << 27)
    assert tame[2] and not tame[3] and not tame[4] and not tame[5]
    assert c_lit[2] * N == 1 << 27 and (costs[2, 1:] == 1 << 20).all()
    assert c_lit[3] * N == (1 << 27) + N and (costs[4] == (1 << 20) + 1).sum() == 1
    assert (1 << 28) < c_lit[5] * N <= (1 << 28) + N


@pytest.mark.parametrize("seed", [0, 1])
def test_dp_parse_kernel_matches_ref_on_runs(cuda, seed):
    f = {k: _t(v).to(cuda) for k, v in fuzz_dp_runs(seed).items()}
    for max_len in DP_RUNS_MAX_LENS:
        for costs in (None, f["costs"]):
            args = (f["delta"], f["mlen"], f["n_valid"], costs, max_len)
            got, want = tenc.dp_parse(*args), tenc.dp_parse_ref(*args)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
