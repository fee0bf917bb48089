"""Port wide decoder (nlzm_tpu_torch.ops.wide_decode) against the JAX
decoder, stage by stage, exact: host staging array by array, then window
staging, the fused plane scan and command assembly, each fed the JAX
decoder's own staged state (through staged_from_jax) and the JAX output
of the stage before. Cases: 4 KiB and 32 KiB blocks, with container
priors and without, with a shared dictionary and without."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.format import wide
from nlzm_tpu.ops import wide_decode as jwd
from nlzm_tpu.parallel.blocks import block_payloads, encode_container, parse_container
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.ops import wide_decode as twd

torch.set_num_threads(1)

# case -> (input bytes, container config, keep container priors)
CASES = {
    "4k_priors": (20_000, dict(block_size=4096), True),
    "4k_no_priors": (20_000, dict(block_size=4096), False),
    "32k_dict_priors": (96_000, dict(block_size=32768, dict_size=32768), True),
    "32k_no_priors": (70_000, dict(block_size=32768), False),
}


def _payloads(n, cfg, keep_priors):
    """Block payloads and priors blob. Without priors, the container's
    commands are re-encoded by the host numpy encoder with none."""
    c = encode_container(build_nonperiodic(n), parser="optimal", profile="wide", **cfg)
    info = parse_container(c)
    payloads = block_payloads(c, info)
    if keep_priors:
        return payloads, info.wide_priors, info.dictionary
    ops = [wide.decode_wide_block(p, info.wide_priors) for p in payloads]
    T = max(len(ol) for ol, _ in ops) + 1
    op_len = np.full((T, len(ops)), -1, np.int64)
    op_val = np.zeros((T, len(ops)), np.int64)
    op_rep = np.full((T, len(ops)), -1, np.int64)
    for b, (ol, ov) in enumerate(ops):
        op_len[: len(ol), b], op_val[: len(ov), b] = ol, ov
        op_rep[: len(ol), b] = wide.classify_reps_wide(ol, ov)
    payloads, blob = wide.encode_wide_blocks(op_len, op_val, op_rep, with_priors=False)
    assert blob == b""
    return payloads, None, info.dictionary


def _np(tree):
    """A JAX staged dict (or any nesting of it) with arrays as numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return np.asarray(tree) if hasattr(tree, "shape") else tree


@functools.cache
def jax_stages(case):
    """The JAX decoder's staged dict and stage outputs for a case, as numpy
    (computed once per case and process)."""
    n, cfg, keep = CASES[case]
    payloads, blob, dictionary = _payloads(n, cfg, keep)
    st = jwd.prepare_wide(payloads, blob)
    wins = jwd.stage_windows_of(st)
    priors_f = None
    if st["priors"]:
        priors_f = tuple(st["priors"][wide.PLANES[p].name][0] for p in range(wide.N_PLANES))
    ys = jwd.plane_scan_fused(
        st["seeds_cat"], wins, jnp.stack(st["n_sym"], axis=1), st["steps"][0], priors_f)
    ys = tuple(a[:, : min(a.shape[1], 1 << 15)] for a in ys)
    tok_y, lit_y, len_y, lex_y, slot_y = ys
    ops = jwd.assemble_ops(tok_y, len_y, lex_y, lit_y, slot_y, st["bit_half"],
                           st["n_sym"][0], False, wide_delta=dictionary is not None)
    return dict(payloads=payloads, blob=blob, staged=_np(st), wins=_np(wins), ys=_np(ys),
                ops=_np(ops))


def _t(a):
    return torch.from_numpy(np.array(a))  # an owned, writable copy


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_wide_matches_jax(case):
    j = jax_stages(case)
    js = j["staged"]
    ps = twd.prepare_wide(j["payloads"], j["blob"], device="cpu")
    np.testing.assert_array_equal(ps["seeds_cat"].numpy().view(np.uint32), js["seeds_cat"])
    np.testing.assert_array_equal(ps["hw_cat"].numpy().view(np.uint16), js["hw_cat"])
    np.testing.assert_array_equal(ps["bit_half"].numpy().view(np.uint16), js["bit_half"])
    np.testing.assert_array_equal(ps["offs"].numpy(), js["offs"])
    np.testing.assert_array_equal(ps["ends"].numpy(), js["ends"])
    np.testing.assert_array_equal(ps["n_sym"].numpy(), np.stack(js["n_sym"], axis=1))
    assert ps["WHs"] == js["WHs"] and ps["steps"] == js["steps"][0]
    if js["priors"] is None:
        assert ps["priors"] is None
    else:
        for p, spec in enumerate(wide.PLANES):
            np.testing.assert_array_equal(
                ps["priors"][p].numpy(), js["priors"][spec.name][0].reshape(-1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_windows_matches_jax(case):
    j = jax_stages(case)
    st = twd.staged_from_jax(j["staged"], "cpu")
    got = twd.stage_windows_of(st)
    assert len(got) == len(j["wins"])
    for g, w in zip(got, j["wins"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plane_scan_matches_jax(case):
    j = jax_stages(case)
    st = twd.staged_from_jax(j["staged"], "cpu")
    wins = tuple(_t(w) for w in j["wins"])
    ys = twd.plane_scan_fused(st["seeds_cat"], wins, st["n_sym"], st["steps"], st["priors"])
    for p, (g, w) in enumerate(zip(ys, j["ys"])):
        np.testing.assert_array_equal(g.numpy()[:, : w.shape[1]], w, err_msg=f"plane {p}")
        assert g.shape[1] == st["steps"] * wide.PLANES[p].lanes


@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_ops_matches_jax(case):
    j = jax_stages(case)
    st = twd.staged_from_jax(j["staged"], "cpu")
    tok_y, lit_y, len_y, lex_y, slot_y = (_t(a) for a in j["ys"])
    op_len, op_val = twd.assemble_ops(
        tok_y, len_y, lex_y, lit_y, slot_y, st["bit_half"], st["n_sym"][:, 0].contiguous(),
        wide_delta=CASES[case][1].get("dict_size", 0) > 0)
    np.testing.assert_array_equal(op_len.numpy(), j["ops"][0])
    np.testing.assert_array_equal(op_val.numpy(), j["ops"][1])


def test_build_cdf_matches_jax():
    rng = np.random.default_rng(5)
    for nsym in (4, 8, 64, 256):
        carry = rng.integers(0, 1500, (3, 1, nsym)).astype(np.int32)
        carry[0, 0] = 0  # an all-zero row: uniform-ish fences
        want = np.asarray(jwd._build_cdf_jnp(jnp.asarray(carry), nsym))
        got = twd._build_cdf(torch.from_numpy(carry).long(), nsym).numpy()
        np.testing.assert_array_equal(got, want)


def test_decode_wide_staged_matches_jax():
    """The whole staged pipeline on identical state: bytes and counts."""
    j = jax_stages("32k_dict_priors")
    n, cfg, _ = CASES["32k_dict_priors"]
    c = encode_container(build_nonperiodic(n), parser="optimal", profile="wide", **cfg)
    dictionary = parse_container(c).dictionary
    js = dict(j["staged"], rounds_hint=3, dict_arr=np.frombuffer(dictionary, np.uint8))
    jst = dict(jwd.prepare_wide(j["payloads"], j["blob"]), rounds_hint=3,
               dict_arr=jnp.asarray(js["dict_arr"]))
    j_out, j_prod = jwd.decode_wide_staged(jst, cfg["block_size"])
    t_out, t_prod = twd.decode_wide_staged(twd.staged_from_jax(js, "cpu"), cfg["block_size"])
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_prod.numpy(), np.asarray(j_prod))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_kernels_match_ref(case, cuda):
    """stage_windows, plane_scan and assemble kernels against their plain
    versions on the same device tensors."""
    j = jax_stages(case)
    st = twd.staged_from_jax(j["staged"], cuda)
    sw = (st["hw_cat"], st["offs"], st["ends"], st["WHs"])
    wins = twd.stage_windows_fused(*sw)
    for g, w in zip(wins, twd.stage_windows_fused_ref(*sw)):
        assert torch.equal(g, w)
    ps = (st["seeds_cat"], wins, st["n_sym"], st["steps"], st["priors"])
    ys = twd.plane_scan_fused(*ps)
    for g, w in zip(ys, twd.plane_scan_fused_ref(*ps)):
        assert torch.equal(g, w)
    ys = tuple(a[:, : min(a.shape[1], twd.CAP15)] for a in ys)
    tok_y, lit_y, len_y, lex_y, slot_y = ys
    asm = (tok_y, len_y, lex_y, lit_y, slot_y, st["bit_half"], st["n_sym"][:, 0].contiguous(),
           False, CASES[case][1].get("dict_size", 0) > 0)
    for g, w in zip(twd.assemble_ops(*asm), twd.assemble_ops_ref(*asm)):
        assert torch.equal(g, w)
