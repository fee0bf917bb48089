"""Port NLZC codec (nlzm_tpu_torch.research.ppm_tpu) against the JAX one,
exact: compress byte for byte on the cases of tests/test_ppm_tpu.py and on
a 65,536-byte text (which ships the huff0-coded prior), the staged
container fields, the plain block decode against JAX's _decode_blocks,
decompress on the CPU, truncated blobs against JAX; card-only
kernel-vs-plain cases."""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nlzm_tpu.research import ppm_tpu as jp
from nlzm_tpu_torch.research import ppm_tpu as tp

torch.set_num_threads(1)


def _noise(n: int) -> bytes:
    rng = random.Random(1)
    return bytes(rng.randrange(256) for _ in range(n))


# case -> (input, block_size); the inputs of tests/test_ppm_tpu.py
CASES = {
    "tiny": (lambda s, t: s["tiny"], 4096),
    "repetitive": (lambda s, t: s["repetitive"], 4096),
    "zeros": (lambda s, t: s["zeros"], 4096),
    "empty": (lambda s, t: s["empty"], 4096),
    "noise": (lambda s, t: _noise(3000), 16384),
    "text": (lambda s, t: t(20000), 8192),
    "random": (lambda s, t: s["random"][:3000], 4096),
    "prior": (lambda s, t: t(tp.PRIOR_MIN), tp.DEFAULT_BLOCK),
}


@pytest.fixture(scope="module")
def blobs(corpus_samples, corpus_text):
    """case -> (input, JAX container, port container)."""
    out = {}
    for name, (make, block) in CASES.items():
        data = make(corpus_samples, corpus_text)
        out[name] = (data, jp.compress(data, block), tp.compress(data, block))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_byte_identical(blobs, case):
    _, j, t = blobs[case]
    assert t == j


@pytest.mark.parametrize("case", sorted(CASES))
def test_decompress_cpu(blobs, case):
    data, j, _ = blobs[case]
    assert tp.decompress(j, device="cpu") == data


def _same_stage(blob: bytes):
    """stage_container of both packages: equal fields; the port's."""
    got, layout = tp.stage_container(blob, device="cpu")
    want = jp.stage_container(blob)
    words, seg_dev, prior_dev, steps = got
    assert (steps, layout.total_len, words.shape[0]) == want[3:4] + want[5:]
    np.testing.assert_array_equal(layout.seg, want[4])
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(want[0]))
    np.testing.assert_array_equal(seg_dev.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(prior_dev.numpy(), np.asarray(want[2]))
    assert words.dtype == seg_dev.dtype == prior_dev.dtype == torch.int32
    return got, want


@pytest.mark.parametrize("case", ["prior", "text", "tiny"])
def test_stage_container_fields(blobs, case):
    _same_stage(blobs[case][1])


def test_stage_container_empty(blobs):
    want = jp.stage_container(blobs["empty"][1])
    assert want[:5] == (None, None, None, 0, None) and want[6] == 0
    assert tp.stage_container(blobs["empty"][1], device="cpu") == (
        None, tp.Layout(None, want[5]))


@pytest.mark.parametrize("case", ["prior", "noise"])
def test_decode_blocks_ref_matches_jax(blobs, case):
    (words, seg_dev, prior_dev, steps), want = _same_stage(blobs[case][1])
    got = tp._decode_blocks_ref(words, seg_dev, prior_dev, steps)
    assert got.dtype == torch.uint8 and got.shape == (words.shape[0], steps, tp.LANES)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp._decode_blocks(want[0], want[1], want[2], steps)))


@pytest.mark.parametrize("width", [40, 300])
def test_decode_blocks_ref_clamps_like_jax(blobs, width):
    """Every stream cut to `width` words (the 32 seeds, then a few pairs):
    the window's word index runs past the last word and is clamped to it,
    which holds data, not padding."""
    (words, seg_dev, prior_dev, steps), want = _same_stage(blobs["text"][1])
    got = tp._decode_blocks_ref(words[:, :width].contiguous(), seg_dev, prior_dev, steps)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jp._decode_blocks(want[0][:, :width], want[1], want[2], steps)))


@pytest.mark.parametrize("cut", [1, 3001])
def test_truncated_blob_matches_jax(blobs, cut):
    """The last block's stream cut short: pairs past its end read the
    zero padding and the clamped window, as JAX reads them."""
    data, blob, _ = blobs["prior"]
    bad = blob[:-cut]
    got = tp.decompress(bad, device="cpu")
    assert got == jp.decompress(bad)
    assert len(got) == len(data)


def test_bad_header():
    with pytest.raises(ValueError):
        tp.decompress(b"NLZC\x03\x20" + bytes(16), device="cpu")


def test_research_codecs_run_without_jax():
    """Both research decodes (the NLZC one with its huff0-coded prior) run
    here on the CPU without loading anything of jax or nlzm_tpu; a
    subprocess, since this test process has them loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from nlzm_tpu_torch.research import huff0, ppm_tpu\n"
        "data = (bytes(range(256)) * 40 + b'research codecs ' * 4000)[:ppm_tpu.PRIOR_MIN]\n"
        "assert ppm_tpu.decompress(ppm_tpu.compress(data), device='cpu') == data\n"
        "assert huff0.decode(huff0.encode(data, 8192), device='cpu') == data\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'nlzm_tpu')\n"
        "             or m.startswith(('jax.', 'nlzm_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", ["prior", "noise", "text"])
def test_ppm_decode_kernel_matches_ref(blobs, case, cuda):
    data, blob, _ = blobs[case]
    args, _ = tp.stage_container(blob, device=cuda)
    assert torch.equal(tp._decode_blocks(*args), tp._decode_blocks_ref(*args))
    assert tp.decompress(blob, device=cuda) == data
