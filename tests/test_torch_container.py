"""Port container decode (nlzm_tpu_torch.parallel.blocks.decode_container)
on the CPU: wide round trips at the shipping config and at 4 KiB blocks,
v1 round trips, the empty containers, corrupt containers, the default
device, device checks of the kernel wrappers, and a jax-free
subprocess."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nlzm_tpu.format.wide import HDR_BYTES, N_PLANES, PLANES, chunk_schedule, padded_steps
from nlzm_tpu.parallel.blocks import block_payloads, encode_container, parse_container
from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.ops import decode_v2, expand_ops, wide_decode
from nlzm_tpu_torch.parallel.blocks import IntegrityError, decode_container

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHIP = dict(block_size=32768, dict_size=32768, depth_cap=8)  # bench.py primary config


@pytest.fixture(scope="module")
def ship():
    data = build_nonperiodic(64_000)
    return data, encode_container(data, parser="optimal", profile="wide", **SHIP)


def test_decode_shipping_config(ship):
    data, c = ship
    assert parse_container(c).dictionary is not None
    assert decode_container(c, device="cpu") == data


def test_decode_4k_blocks_no_dict():
    data = build_nonperiodic(30_000, seed=7)
    c = encode_container(data, block_size=4096, parser="optimal", profile="wide")
    assert parse_container(c).dictionary is None
    assert decode_container(c, device=torch.device("cpu")) == data


def test_decode_empty():
    c = encode_container(b"", profile="wide", block_size=4096)
    assert decode_container(c, device="cpu") == b""


def test_corrupt_payload_byte_is_integrity_error(corpus_text):
    """The flip of tests/test_wide.py::test_wide_corruption_detected."""
    data = corpus_text(20000)
    c = bytearray(encode_container(data, block_size=4096, parser="optimal", profile="wide"))
    c[parse_container(bytes(c)).payload_off + 200] ^= 0xFF
    with pytest.raises(IntegrityError):
        decode_container(bytes(c), device="cpu")


def test_corrupt_live_tok_pair_is_integrity_error(ship):
    """The flip of tests/test_dict.py::test_dict_corruption_detected: the
    first renorm pair of block 0's tok plane, in a dictionary container."""
    data, c = ship
    info = parse_container(c)
    payload = block_payloads(c, info)[0]
    tables = 0
    for i in range(N_PLANES):
        sym_count = int.from_bytes(payload[8 * i : 8 * i + 4], "big")
        tables += 2 * (len(chunk_schedule(padded_steps(sym_count, PLANES[i].lanes))) - 1)
    blob = bytearray(c)
    blob[info.payload_off + HDR_BYTES + tables + 4 * PLANES[0].lanes] ^= 0xFF
    with pytest.raises(IntegrityError):
        decode_container(bytes(blob), device="cpu")
    assert decode_container(c, device="cpu") == data


@pytest.mark.parametrize("cfg", [
    dict(block_size=4096, parser="greedy"),
    dict(block_size=8192, parser="optimal"),
], ids=["4k_greedy", "8k_optimal"])
def test_v1_round_trip(corpus_text, cfg):
    data = corpus_text(20000) + b"ragged tail"
    c = encode_container(data, **cfg)
    assert not parse_container(c).wide
    assert decode_container(c, device="cpu") == data


def test_v1_decode_empty():
    c = encode_container(b"")
    assert not parse_container(c).wide
    assert decode_container(c, device="cpu") == b""


def test_v1_corrupt_payload_is_integrity_error(corpus_text):
    """The mid-payload flip of tests/test_stream_container.py."""
    data = corpus_text(8000)
    c = bytearray(encode_container(data, block_size=4096, parser="greedy"))
    info = parse_container(bytes(c))
    c[info.payload_off + info.comp_sizes[0] // 2] ^= 0x40
    with pytest.raises(IntegrityError):
        decode_container(bytes(c), device="cpu")


def test_default_device_is_cuda(ship):
    """No CPU fallback: without a device argument the decode goes to the
    card, and fails where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((AssertionError, RuntimeError)):
        decode_container(ship[1])


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise (here: meta tensors raise)."""
    m = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=m)
    with pytest.raises(ValueError):
        wide_decode.stage_windows_fused(
            torch.empty(2, 64, dtype=torch.int16, device=m), torch.empty(2, 5, 4, **i32),
            torch.empty(2, 5, **i32), (8,) * 5)
    with pytest.raises(ValueError):
        expand_ops.lz_expand_parallel(
            torch.empty(16, 2, **i32), torch.empty(16, 2, **i32), 4096)
    with pytest.raises(ValueError):
        decode_v2.fsm_decode_v2(torch.empty(2, 64, dtype=torch.uint8, device=m), 256)
    assert wide_decode.stage_windows_fused.launches == 0
    assert expand_ops.lz_expand_parallel.launches == 0
    assert decode_v2.fsm_decode_v2.launches == 0


def test_port_runs_without_jax():
    """Importing and running the port (wide and v1 decode, the sharded
    wide decode, the multi-process module) loads nothing
    of jax, nlzm_tpu or bench.py (the GPU machine has no jax); a
    subprocess, since this test process has them loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import nlzm_tpu_torch\n"
        "from nlzm_tpu_torch.parallel import mesh, mp_dryrun\n"
        "data = bytes(range(256)) * 40 + b'wide profile ' * 300\n"
        "for kw in (dict(profile='wide', parser='optimal'), dict(parser='greedy')):\n"
        "    c = nlzm_tpu_torch.encode_container(data, block_size=4096, **kw)\n"
        "    assert nlzm_tpu_torch.decode_container(c, device='cpu') == data\n"
        "    sharded = mesh.decode_wide_sharded if kw.get('profile') else \\\n"
        "        mesh.decode_container_sharded\n"
        "    assert sharded(c, mesh.make_mesh(['cpu'] * 2)) == data\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'nlzm_tpu')\n"
        "             or m.startswith(('jax.', 'nlzm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
