"""The port's multi-process mode (nlzm_tpu_torch/parallel/mp_dryrun.py) on
the CPU: two processes on gloo, a file:// rendezvous under the test's
directory, each decoding only its rows; process 0's ok line and the
bytes it assembled, against the input. Every wait has a timeout, so a
hang fails the test and kills the children."""

import torch

from nlzm_tpu.utils.corpus import build_nonperiodic
from nlzm_tpu_torch.parallel import mp_dryrun
from nlzm_tpu_torch.parallel.blocks import parse_container

torch.set_num_threads(1)


def test_two_processes_gloo_cpu(tmp_path):
    line = mp_dryrun.spawn(2, "gloo", "cpu", tmp_path, timeout=180)
    assert line.startswith("mp_dryrun ok: 2 processes x 1 device (cpu, gloo)")
    data = mp_dryrun.corpus(2)
    assert len(data) == 5 * mp_dryrun.BLOCK_SIZE + 17
    assert (tmp_path / "assembled.bin").read_bytes() == data
    assert {p.name for p in tmp_path.glob("part*.npz")} == {"part0.npz", "part1.npz"}


def test_two_processes_dictionary_input(tmp_path):
    """The dictionary config, cut down: a 40,000-byte file at 8 KiB blocks
    with an 8 KiB shared dictionary (--input, --block-size, --dict-size),
    5 blocks over two processes (padded to 6); every process decodes its
    rows with the dictionary, and process 0's bytes equal the file."""
    data = build_nonperiodic(40_000, seed=5)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    out = tmp_path / "run"
    line = mp_dryrun.spawn(2, "gloo", "cpu", out, timeout=180, input_path=src, block_size=8192,
                           dict_size=8192)
    assert line.startswith("mp_dryrun ok: 2 processes x 1 device (cpu, gloo), 40000 bytes in 5 "
                           "blocks of 8192 (6 rows), dictionary 8192 bytes")
    assert (out / "assembled.bin").read_bytes() == data


def test_corpus_matches_jax():
    """The dry run's corpus is the JAX module's, byte for byte."""
    import random

    for world in (1, 2, 4):
        rng = random.Random(4321)
        words = [bytes(rng.randrange(97, 123) for _ in range(rng.randrange(3, 9)))
                 for _ in range(50)]
        n = 3 * world * 2048 // 5
        data = b" ".join(words[rng.randrange(50)] for _ in range(n))
        assert mp_dryrun.corpus(world) == data[: (2 * world + 1) * 2048 + 17]
