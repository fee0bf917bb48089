"""Port file decode (nlzm_tpu_torch.parallel.stream) against the JAX
decode_container_stream: the same container files, several buckets each,
give byte-identical output files and equal results, for wide containers
with and without a shared dictionary and for v1; test mode (no output
file); a CRC mismatch raises the port's IntegrityError."""

import pytest
import torch

from nlzm_tpu.parallel.blocks import encode_container
from nlzm_tpu.parallel.stream import decode_container_stream as jax_stream
from nlzm_tpu.parallel.stream import read_container_head as jax_head
from nlzm_tpu_torch.parallel import stream
from nlzm_tpu_torch.parallel.blocks import IntegrityError

torch.set_num_threads(1)

# case -> (input bytes, container config, bucket_bytes): each file takes
# two or more buckets
CASES = {
    "wide_dict": (60_000, dict(block_size=16384, parser="optimal", profile="wide",
                               dict_size=8192), 33_000),
    "wide_no_dict": (50_000, dict(block_size=8192, parser="optimal", profile="wide"), 20_000),
    "v1": (24_000, dict(block_size=4096, parser="greedy"), 9_000),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory, corpus_text):
    out = {}
    d = tmp_path_factory.mktemp("streams")
    for name, (n, cfg, bucket) in CASES.items():
        data = corpus_text(n)
        src = d / f"{name}.nlzp"
        src.write_bytes(encode_container(data, **cfg))
        out[name] = (data, src, bucket)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_decode_matches_jax(files, case, tmp_path):
    data, src, bucket = files[case]
    with open(src, "rb") as f:
        info = stream.read_container_head(f)
    assert -(-len(info.comp_sizes) // stream._bucket_blocks(info.block_size, bucket)) >= 2
    j_out, t_out = tmp_path / "jax.out", tmp_path / "port.out"
    j = jax_stream(str(src), str(j_out), bucket_bytes=bucket)
    t = stream.decode_container_stream(str(src), str(t_out), device="cpu", bucket_bytes=bucket)
    assert t == j
    assert t_out.read_bytes() == j_out.read_bytes() == data


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_container_head_matches_jax(files, case):
    _, src, _ = files[case]
    with open(src, "rb") as f:
        t = stream.read_container_head(f)
        t_pos = f.tell()
    with open(src, "rb") as f:
        j = jax_head(f)
        j_pos = f.tell()
    assert vars(t) == vars(j) and t_pos == j_pos


def test_stream_test_mode(files):
    data, src, bucket = files["wide_dict"]
    t = stream.decode_container_stream(str(src), None, device="cpu", bucket_bytes=bucket)
    assert t == jax_stream(str(src), None, bucket_bytes=bucket)
    assert t["out"] == len(data)


def test_stream_crc_mismatch(files, tmp_path):
    _, src, bucket = files["wide_no_dict"]
    blob = bytearray(src.read_bytes())
    blob[24] ^= 0xFF  # the stored CRC
    bad = tmp_path / "bad.nlzp"
    bad.write_bytes(bytes(blob))
    with pytest.raises(IntegrityError, match="CRC mismatch"):
        stream.decode_container_stream(str(bad), None, device="cpu", bucket_bytes=bucket)
