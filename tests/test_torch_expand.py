"""Port LZ expansion (nlzm_tpu_torch.ops.expand_ops) against the JAX
lz_expand_parallel, exact, on command arrays from real containers:
RLE deep chains, a shared-dictionary container, and a 64 KiB block (the
JAX 2-operand, non-packed branch); with and without a round hint, and
with a hint too small to resolve every parent."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nlzm_tpu.format.wide import decode_wide_block
from nlzm_tpu.ops.expand_ops import lz_expand_parallel as jax_expand
from nlzm_tpu.parallel.blocks import block_payloads, encode_container, parse_container
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.ops import expand_ops
from nlzm_tpu_torch.ops.wide_decode import rounds_hint_of

torch.set_num_threads(1)

RLE = (b"\x00" * 5000) + (b"ab" * 4000) + (b"xyz" * 3000) + b"tail" * 500
CASES = {
    "rle_deep_chains": (RLE, dict(block_size=8192)),
    "dict_32k": (build_nonperiodic(96_000), dict(block_size=32768, dict_size=32768)),
    "block_64k": (build_nonperiodic(65_536), dict(block_size=65536)),
}


@pytest.fixture(scope="module")
def commands():
    """case -> (op_len [T, B], op_val [T, B] int32, block_size, dict or
    None, container depth hint): every block's commands from the host
    reference decoder, padded with op_len -1."""
    out = {}
    for name, (data, kw) in CASES.items():
        c = encode_container(data, parser="optimal", profile="wide", **kw)
        info = parse_container(c)
        ops = [decode_wide_block(p, info.wide_priors) for p in block_payloads(c, info)]
        T = max(len(ol) for ol, _ in ops) + 37
        op_len = np.full((T, len(ops)), -1, np.int32)
        op_val = np.zeros((T, len(ops)), np.int32)
        for b, (ol, ov) in enumerate(ops):
            op_len[: len(ol), b] = ol
            op_val[: len(ov), b] = ov
        out[name] = (op_len, op_val, info.block_size, info.dictionary,
                     rounds_hint_of(max(info.total_reads)), data)
    return out


@pytest.mark.parametrize("hinted", [False, True], ids=["until_no_change", "rounds_hint"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lz_expand_matches_jax(commands, case, hinted):
    op_len, op_val, N, dictionary, hint, data = commands[case]
    hint = hint if hinted else None
    j_dict = None if dictionary is None else jnp.asarray(np.frombuffer(dictionary, np.uint8))
    t_dict = None if dictionary is None else torch.from_numpy(
        np.frombuffer(dictionary, np.uint8).copy())
    j_out, j_prod = jax_expand(jnp.asarray(op_len), jnp.asarray(op_val), N, hint, j_dict)
    t_out, t_prod = expand_ops.lz_expand_parallel(
        torch.from_numpy(op_len), torch.from_numpy(op_val), N, hint, t_dict)
    assert t_out.dtype == torch.uint8 and t_prod.dtype == torch.int32
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_prod.numpy(), np.asarray(j_prod))
    # and the bytes are the input's
    assert t_out.numpy().tobytes()[: len(data)] == data


@pytest.mark.parametrize("hint", [0, 1], ids=["hint0", "hint1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lz_expand_unresolved_parents_match_jax(commands, case, hint):
    """A round hint below the chain depth (8 here) leaves parents
    unresolved: they are filled from the latest literal (or dictionary
    byte) at or before them, as the JAX fills do, on the packed-sort path
    with and without a dictionary and on the 2-operand path (64 KiB)."""
    op_len, op_val, N, dictionary, _, data = commands[case]
    j_dict = None if dictionary is None else jnp.asarray(np.frombuffer(dictionary, np.uint8))
    t_dict = None if dictionary is None else torch.from_numpy(
        np.frombuffer(dictionary, np.uint8).copy())
    j_out, j_prod = jax_expand(jnp.asarray(op_len), jnp.asarray(op_val), N, hint, j_dict)
    t_out, t_prod = expand_ops.lz_expand_parallel(
        torch.from_numpy(op_len), torch.from_numpy(op_val), N, hint, t_dict)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_prod.numpy(), np.asarray(j_prod))
    # the hint is too small: both are wrong against the input, alike
    assert t_out.numpy().tobytes()[: len(data)] != data


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(CASES))
def test_lz_expand_kernel_matches_ref(commands, case, cuda):
    op_len, op_val, N, dictionary, hint, _ = commands[case]
    d = None if dictionary is None else torch.from_numpy(
        np.frombuffer(dictionary, np.uint8).copy()).to(cuda)
    args = (torch.from_numpy(op_len).to(cuda), torch.from_numpy(op_val).to(cuda), N)
    # a hint of 1 leaves chains unresolved: the kernel still composes
    # exactly as the plain version does, round for round
    for h in (None, hint, 1):
        k_out, k_prod = expand_ops.lz_expand_parallel(*args, h, d)
        r_out, r_prod = expand_ops.lz_expand_parallel_ref(*args, h, d)
        assert torch.equal(k_out, r_out) and torch.equal(k_prod, r_prod)
