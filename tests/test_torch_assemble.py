"""assemble_ops (nlzm_tpu_torch.ops.wide_decode) against the JAX assemble_ops,
exact, on the worst cases of csrc/assemble.cu and of JAX's packed
compaction (chip_smoke.fuzz_assemble: a dict distance past 2^15 and 2^16,
many of them followed by reps; reps before the first dict, in runs, alone;
a block of literals; tok 3; n_cmds at 0, -5, Tc and Tc + 100; lex ranks
past the lex width; raw-bit offsets past the row; column-slice planes; Tc
of 1, 31, 1025 and 4096, B = 1), on JAX's packed path with wide_delta false
and true, for two seeds: the plain version, and chip_smoke.assemble_model,
the numpy model of the kernel's scheme (thread runs, the two scans, the
window of four dict distances and its carry, the flagged block's sort) at
the kernel's run length and at runs, warps and chunks small enough that a
rep's window crosses each edge. Also the 2-operand path (big) on three
patterns, the private entries of the main path (_assemble_rows,
expand_ops._lz_expand_rows) against the public ones, decode_wide_staged
against JAX's on three containers, the ValueErrors of both entries, the
scheme's constants against the kernel source, and a card-only
kernel-vs-plain case."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from nlzm_tpu.ops import wide_decode as jwd
from nlzm_tpu.parallel.blocks import block_payloads, encode_container, parse_container
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.ops import expand_ops as xo
from nlzm_tpu_torch.ops import wide_decode as twd

torch.set_num_threads(1)

SEEDS = (0, 1)
PATTERNS = tuple(cs.fuzz_assemble(0))
SPILLS = ("spill_30", "spill_32", "spill_33", "spill_many")
# the model's (threads, slots a thread): the kernel's, then runs of 4 (a
# warp 128 slots, a chunk 256: Tc 256 crosses all three edges), then a
# one-warp CTA of runs of 2 (a chunk of 64 slots)
SCHEMES = {"kernel": (None, None), "runs4": (64, 4), "chunks64": (32, 2)}
BIG_PATTERNS = ("valid", "spill_32", "spill_many")
KERNEL_SRC = Path(twd.__file__).resolve().parent.parent / "csrc" / "assemble.cu"


@functools.cache
def _set(seed):
    return cs.fuzz_assemble(seed)


def _torch(a):
    """The port's arguments: planes as tensors with the arrays' strides
    (a column slice stays one), bit_half as int16."""
    planes = tuple(torch.from_numpy(x) for x in a[:5])
    return (*planes, torch.from_numpy(a[5].view(np.int16)), torch.from_numpy(a[6]))


@functools.cache
def _jax(seed, pattern, big, wide_delta):
    a = _set(seed)[pattern]
    ol, ov = jwd.assemble_ops(*(jnp.asarray(np.ascontiguousarray(x)) for x in a[:5]),
                              jnp.asarray(a[5]), jnp.asarray(a[6]), big, wide_delta=wide_delta)
    return np.asarray(ol), np.asarray(ov)


def _pairs(ol, ov):
    """[Tc, B] op_len / op_val -> [B, TP, 2] pairs as _assemble_rows gives them."""
    return twd._rows_of(torch.from_numpy(np.array(ol)), torch.from_numpy(np.array(ov))).numpy()


@pytest.mark.parametrize("wide_delta", (False, True))
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_ref_matches_jax(seed, pattern, wide_delta):
    j_len, j_val = _jax(seed, pattern, False, wide_delta)
    t_len, t_val = twd.assemble_ops(*_torch(_set(seed)[pattern]), False, wide_delta)
    assert t_len.dtype == torch.int32 and t_len.is_contiguous()
    np.testing.assert_array_equal(t_len.numpy(), j_len)
    np.testing.assert_array_equal(t_val.numpy(), j_val)


@pytest.mark.parametrize("scheme", tuple(SCHEMES))
@pytest.mark.parametrize("wide_delta", (False, True))
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_model_matches_jax(seed, pattern, wide_delta, scheme):
    nt, spt = SCHEMES[scheme]
    got = cs.assemble_model(*_set(seed)[pattern], big=False, wide_delta=wide_delta, NT=nt,
                            SPT=spt)
    np.testing.assert_array_equal(got, _pairs(*_jax(seed, pattern, False, wide_delta)))


@pytest.mark.parametrize("pattern", BIG_PATTERNS)
def test_assemble_big_matches_jax(pattern):
    """The 2-operand path (big): no packing, so a spill changes nothing."""
    a = _set(0)[pattern]
    j_len, j_val = _jax(0, pattern, True, False)
    t_len, t_val = twd.assemble_ops(*_torch(a), True, False)
    np.testing.assert_array_equal(t_len.numpy(), j_len)
    np.testing.assert_array_equal(t_val.numpy(), j_val)
    np.testing.assert_array_equal(cs.assemble_model(*a, big=True, NT=64, SPT=4),
                                  _pairs(j_len, j_val))


@pytest.mark.parametrize("pattern", SPILLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_default_matches_jax_default(seed, pattern):
    """Both entries called with their defaults (big and wide_delta false in
    JAX's assemble_ops and in the port's) give JAX's commands on the spill
    classes, where a dict distance in [2^15, 2^16) sorts apart under the
    two payloads."""
    a = _set(seed)[pattern]
    ol, ov = jwd.assemble_ops(*(jnp.asarray(np.ascontiguousarray(x)) for x in a[:5]),
                              jnp.asarray(a[5]), jnp.asarray(a[6]))
    t_len, t_val = twd.assemble_ops_ref(*_torch(a))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(ol))
    np.testing.assert_array_equal(t_val.numpy(), np.asarray(ov))
    np.testing.assert_array_equal(twd._assemble_rows(*_torch(a)).numpy(), _pairs(ol, ov))


@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_flags_spills_only(seed):
    """The kernel's trigger for JAX's compaction: every block of a spill
    class on the 15-bit payload, slots 32 and 33 (past 2^16) also on the
    16-bit one; no block of any other pattern, and none off the packed
    path."""
    for pat, a in _set(seed).items():
        for wide_delta in (False, True):
            st = {}
            cs.assemble_model(*a, big=False, wide_delta=wide_delta, stats=st)
            want = pat in SPILLS and not (wide_delta and pat == "spill_30")
            assert st["flagged"] == [want] * a[0].shape[0], (pat, wide_delta)
        st = {}
        cs.assemble_model(*a, big=True, stats=st)
        assert not any(st["flagged"]), pat


@pytest.mark.parametrize("pattern", ("valid", "spill_many", "col_slice", "tc1025"))
def test_private_entries_match_public(pattern):
    """_assemble_rows: assemble_ops as [B, TP, 2] pairs (the padding slot
    -1, 0); _lz_expand_rows on them: lz_expand_parallel on [T, B]."""
    a = _torch(_set(1)[pattern])
    for wide_delta in (False, True):
        ol, ov = twd.assemble_ops(*a, False, wide_delta)
        cmds = twd._assemble_rows(*a, False, wide_delta)
        Tc, B = ol.shape
        assert cmds.shape == (B, (Tc + 1) & ~1, 2) and cmds.dtype == torch.int32
        assert torch.equal(cmds[:, :Tc, 0].t(), ol) and torch.equal(cmds[:, :Tc, 1].t(), ov)
        assert (cmds[:, Tc:, 0] == -1).all() and (cmds[:, Tc:, 1] == 0).all()
    ex = (ol.clamp(-1, 40), ov.clamp(0, 200), 4096)
    for hint in (None, 1):
        want = xo.lz_expand_parallel(*ex, hint)
        got = xo._lz_expand_rows(twd._rows_of(ex[0], ex[1]), Tc, 4096, hint)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("pattern", ("delta_big_4k", "past_end_4k", "valid_ship"))
def test_lz_expand_rows_matches_columns_on_fuzz(pattern):
    """_lz_expand_rows on fuzz_expand's commands given as rows, against
    lz_expand_parallel on them as [T, B]."""
    ol, ov, N, d = cs.fuzz_expand(0, [pattern])[pattern]
    dd = None if d is None else torch.from_numpy(d)
    cmds = twd._rows_of(torch.from_numpy(ol), torch.from_numpy(ov))
    for hint in (None, 0):
        want = xo.lz_expand_parallel(torch.from_numpy(ol), torch.from_numpy(ov), N, hint, dd)
        got = xo._lz_expand_rows(cmds, ol.shape[0], N, hint, dd)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# container -> (input bytes, config), each decoded with its priors and reads
CONTAINERS = {
    "4k": (20_000, dict(block_size=4096)),
    "32k_dict": (96_000, dict(block_size=32768, dict_size=32768)),
    "32k": (70_000, dict(block_size=32768)),
}


@pytest.mark.parametrize("case", tuple(CONTAINERS))
def test_decode_wide_staged_matches_jax(case):
    """The whole staged pipeline through the private entries, against
    JAX's decode_wide_staged (big and wide_delta as it passes them)."""
    n, cfg = CONTAINERS[case]
    c = encode_container(build_nonperiodic(n), parser="optimal", profile="wide", **cfg)
    info = parse_container(c)
    payloads = block_payloads(c, info)
    hint = jwd.rounds_hint_of(max(info.total_reads))
    d = None if not info.dictionary else np.frombuffer(info.dictionary, np.uint8)
    jst = dict(jwd.prepare_wide(payloads, info.wide_priors), rounds_hint=hint,
               dict_arr=None if d is None else jnp.asarray(d))
    j_out, j_prod = jwd.decode_wide_staged(jst, cfg["block_size"])
    tst = twd.prepare_wide(payloads, info.wide_priors, device="cpu")
    tst.update(rounds_hint=hint, dict_arr=twd.dict_tensor(info.dictionary, "cpu"))
    t_out, t_prod = twd.decode_wide_staged(tst, cfg["block_size"])
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_prod.numpy(), np.asarray(j_prod))


@pytest.mark.parametrize("case", ("32k", "32k_dict"))
def test_asm_work_reads_live_symbols(case):
    """chip_smoke.asm_work's bytes on a staged bucket: each plane's live
    symbols as the stream counts them (n_sym: tok, lit, len, lex, slot),
    the counts, the halfwords that hold the raw-bit fields and the pairs
    out; none of the planes' padding."""
    n, cfg = CONTAINERS[case]
    c = encode_container(build_nonperiodic(n), parser="optimal", profile="wide", **cfg)
    info = parse_container(c)
    st = twd.prepare_wide(block_payloads(c, info), info.wide_priors, device="cpu")
    st.update(rounds_hint=0, dict_arr=twd.dict_tensor(info.dictionary, "cpu"))
    asm = cs.asm_args(st, cfg["block_size"])
    n_sym = st["n_sym"].numpy().astype(np.int64)
    B, Tc = asm[0].shape
    slot = asm[4].numpy()
    halves = 0
    for b in range(B):
        s_b = slot[b, : n_sym[b, 4]]
        n_bits = int(np.where(s_b >= 4, np.clip((s_b >> 1) - 1, 0, 16), 0).sum())
        n_bits += 2 * int(n_sym[b, 2] - n_sym[b, 4])
        halves += min(-(-n_bits // 16), asm[5].shape[1])
    want = 4 * (int(n_sym.sum()) + B) + 2 * halves + 8 * ((Tc + 1) & ~1) * B
    assert cs.asm_work(asm) == (want, 40 * Tc * B)
    assert want < cs.nbytes(*asm[:7]) + 8 * ((Tc + 1) & ~1) * B


def test_assemble_value_errors():
    """A plane (or the raw-bit row) wider than 2^15 on the packed path,
    where JAX asserts: ValueError from both entries; the 2-operand path
    takes it."""
    B, W = 1, twd.CAP15 + 1
    planes = [torch.zeros(B, W, dtype=torch.int32) for _ in range(5)]
    bits = torch.zeros(B, 4, dtype=torch.int16)
    n = torch.full((B,), 3, dtype=torch.int32)
    for fn in (twd.assemble_ops, twd.assemble_ops_ref, twd._assemble_rows):
        with pytest.raises(ValueError, match="wider than"):
            fn(*planes, bits, n, False)
    narrow = [p[:, :8] for p in planes]
    with pytest.raises(ValueError, match="wider than"):
        twd.assemble_ops(*narrow, torch.zeros(B, W, dtype=torch.int16), n, False)
    ol, _ = twd.assemble_ops(*planes, bits, n, True)
    assert ol.shape == (W, B) and (ol[:3] == 0).all() and (ol[3:] == -1).all()


def test_lz_expand_rows_value_errors():
    """The rows entry checks its pairs before any address is taken: dtype,
    [B, TP, 2], contiguity, TP even, 0 <= T <= TP."""
    good = torch.full((2, 8, 2), -1, dtype=torch.int32)
    assert xo._lz_expand_rows(good, 8, 64)[1].tolist() == [0, 0]
    bad = [(good.long(), 8), (good[:, :, :1], 8), (good.transpose(0, 1), 2),
           (good[:, :7], 7), (good, 9), (good, -1), (good.reshape(2, 16), 8),
           (torch.full((2, 8, 3), -1, dtype=torch.int32), 8)]
    for cmds, T in bad:
        with pytest.raises(ValueError, match="_lz_expand_rows"):
            xo._lz_expand_rows(cmds, T, 64)


def test_assemble_constants_match_kernel_source():
    """assemble_model's scheme reads the kernel's constants: threads a CTA
    (and for small blocks), the largest chunk, the raw-bit row's
    shared-memory limit, and config_of's threads and slots a thread."""
    src = KERNEL_SRC.read_text()
    vals = {}
    for name in ("NT", "NT_SMALL", "SMALL", "CHMAX", "SMEM_MAX"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        vals[name] = eval(expr, {"__builtins__": {}})
    assert (vals["NT"], vals["NT_SMALL"], vals["SMALL"], vals["CHMAX"], vals["SMEM_MAX"]) == (
        cs.ASM_NT, cs.ASM_NT_SMALL, cs.ASM_SMALL, cs.ASM_CHMAX, cs.ASM_SMEM_MAX)
    assert "Config c = {Tc <= SMALL ? NT_SMALL : NT, 1, 0, 0};" in src
    assert "while (c.spt * c.nth < Tc && 2 * c.spt * c.nth <= CHMAX) c.spt <<= 1;" in src
    assert [cs.asm_config(t) for t in (1, 512, 513, 1024, 1025, 12800, 16385, 32768)] == [
        (512, 1), (512, 1), (512, 2), (512, 2), (896, 2), (896, 16), (896, 16), (896, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def test_assemble_kernel_matches_ref_on_fuzz(cuda):
    for seed in SEEDS:
        for pat, a in _set(seed).items():
            args = tuple(t.to(cuda) for t in _torch(a))
            for wide_delta in (False, True):
                got = twd._assemble_rows(*args, False, wide_delta)
                want = twd._rows_of(*twd.assemble_ops_ref(*args, False, wide_delta))
                assert torch.equal(got, want), (seed, pat, wide_delta)
