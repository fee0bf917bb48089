"""The port's command line (nlzm_tpu_torch.cli) on the CPU: the six cases
of tests/test_cli.py (the native engine where they use the serial one),
output files and printed CRCs byte-equal to nlzm_tpu.cli's for the same
input and flags, the engine names the port refuses, the single-stream
format's missing device path, -device:cuda without a CUDA device, the -v
report, the in-memory decode of either format, and `python -m
nlzm_tpu_torch.cli` in a process that loads nothing of jax."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nlzm_tpu.cli import main as jax_main
from nlzm_tpu.utils.crc32 import crc32
from nlzm_tpu.utils.metrics import memory_report as jax_memory_report
from nlzm_tpu_torch.cli import main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = "-device:cpu"


@pytest.fixture
def sample(tmp_path, corpus_text):
    data = corpus_text(50000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return data, src, tmp_path


def _roundtrip(src, dst, out, flags):
    assert main(flags + ["c", str(src), str(dst)]) == 0
    assert main(["-engine:native", "d", str(dst), str(out)]) == 0
    return out.read_bytes()


def test_cli_single_stream(sample):
    data, src, d = sample
    assert _roundtrip(src, d / "a.nlzm", d / "a.out", ["-window:18"]) == data


def test_cli_flags_after_command(sample):
    """Flags are position-independent."""
    data, src, d = sample
    dst, out = d / "b.nlzp", d / "b.out"
    assert main(["c", str(src), str(dst), "-profile:wide", "-blocks"]) == 0
    assert dst.read_bytes()[:4] == b"NLZP"
    assert main(["d", str(dst), str(out), "-engine:native"]) == 0
    assert out.read_bytes() == data


def test_cli_blocks_v1_profile(sample):
    data, src, d = sample
    got = _roundtrip(src, d / "c.nlzp", d / "c.out", ["-blocks:32768"])
    assert got == data


def test_cli_refuse_overwrite(sample):
    _, src, d = sample
    dst = d / "d.nlzm"
    dst.write_bytes(b"existing")
    assert main(["c", str(src), str(dst)]) == 1
    assert dst.read_bytes() == b"existing"
    assert main(["d", str(src), str(dst)]) == 1
    assert dst.read_bytes() == b"existing"


def test_cli_crc_and_test_mode(sample, capsys):
    data, src, d = sample
    assert main(["h", str(src)]) == 0
    assert f"{crc32(data):X}" in capsys.readouterr().out
    dst = d / "e.nlzm"
    assert main(["c", str(src), str(dst)]) == 0
    capsys.readouterr()
    assert main(["-engine:native", "t", str(dst)]) == 0
    assert f"{crc32(data):X}" in capsys.readouterr().out


def test_cli_bad_flag_and_usage(sample):
    _, src, _ = sample
    assert main(["-bogus:1", "c", str(src), "x"]) == 1
    assert main([]) == 1
    assert main(["c", str(src)]) == 1  # missing output operand
    assert main(["d", str(src)]) == 1
    assert main(["-device:tpu", "h", str(src)]) == 1


# name -> (nlzm_tpu.cli flags, the port's flags, the port's decode flags)
FLAG_SETS = {
    "single_stream": (["-window:18"], ["-window:18"], []),
    "v1_32k": (["-blocks:32768"], ["-blocks:32768"], ["-engine:native"]),
    "wide_optimal": (["-profile:wide", "-blocks"], ["-profile:wide", "-blocks"], [CPU]),
    "wide_dict": (["-profile:wide", "-blocks", "-dict:32768"],
                  ["-profile:wide", "-blocks", "-dict:32768"], [CPU]),
    "wide_greedy": (["-profile:wide", "-blocks", "-parser:greedy"],
                    ["-profile:wide", "-blocks", "-parser:greedy", CPU], [CPU]),
    "v1_device": (["-blocks:8192", "-engine:tpu"], ["-blocks:8192", "-engine:device", CPU],
                  ["-engine:native"]),
}


def _crc_of(out: str) -> str:
    return re.search(r"CRC32 ([0-9A-F]+)", out).group(1)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_cli_output_matches_jax(sample, capsys, name):
    """Byte-equal output files and equal printed CRCs; the port's file
    decodes back (on the CPU device for wide, on the native engine for v1)."""
    data, src, d = sample
    jflags, tflags, dflags = FLAG_SETS[name]
    jdst, tdst, out = d / "j.z", d / "t.z", d / "t.out"
    assert jax_main(jflags + ["c", str(src), str(jdst)]) == 0
    jcrc = _crc_of(capsys.readouterr().out)
    assert main(tflags + ["c", str(src), str(tdst)]) == 0
    tcrc = _crc_of(capsys.readouterr().out)
    assert tdst.read_bytes() == jdst.read_bytes()
    assert tcrc == jcrc == f"{crc32(data):X}"
    assert main(dflags + ["d", str(tdst), str(out)]) == 0
    assert _crc_of(capsys.readouterr().out) == jcrc
    assert out.read_bytes() == data


def test_cli_v1_device_decode(tmp_path, corpus_text, capsys):
    """A v1 container through the device decode on the CPU (fsm_decode's
    plain version, a step loop: a small file) and in test mode."""
    data = corpus_text(6000)
    src, dst, out = tmp_path / "in", tmp_path / "in.nlzp", tmp_path / "out"
    src.write_bytes(data)
    assert main(["-blocks:4096", "-parser:greedy", "c", str(src), str(dst)]) == 0
    assert main([CPU, "d", str(dst), str(out)]) == 0
    assert out.read_bytes() == data
    capsys.readouterr()
    assert main(["-engine:device", CPU, "t", str(dst)]) == 0
    assert _crc_of(capsys.readouterr().out) == f"{crc32(data):X}"


@pytest.mark.parametrize("engine", ["tpu", "serial", "cuda"])
def test_cli_refuses_engines_it_lacks(sample, capsys, engine):
    _, src, d = sample
    for cmd in (["c", str(src), str(d / "x")], ["t", str(src)]):
        assert main([f"-engine:{engine}", "-blocks"] + cmd) == 1
        msg = capsys.readouterr().out
        assert "auto | native | device" in msg
    assert not (d / "x").exists()


def test_cli_single_stream_has_no_device_path(sample, capsys):
    """JAX's CLI runs its Python codec there; the port has none."""
    _, src, d = sample
    assert main(["-engine:device", CPU, "c", str(src), str(d / "x")]) == 1
    assert "no device path" in capsys.readouterr().out
    assert not (d / "x").exists()
    assert main(["c", str(src), str(d / "s.nlzm")]) == 0
    capsys.readouterr()
    for cmd in (["d", str(d / "s.nlzm"), str(d / "y")], ["t", str(d / "s.nlzm")]):
        assert main(["-engine:device"] + cmd) == 1
        assert "no device path" in capsys.readouterr().out
    assert not (d / "y").exists()


def test_cli_cuda_without_a_device_fails(sample, capsys):
    """No CPU fallback: the default device is cuda, and where there is none
    every device path fails before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, src, d = sample
    for flags in (["-blocks:8192", "-engine:device"], ["-profile:wide", "-parser:greedy"]):
        assert main(flags + ["c", str(src), str(d / "x")]) == 1
        assert "no CUDA device" in capsys.readouterr().out
        assert not (d / "x").exists()
    assert main(["-profile:wide", "c", str(src), str(d / "w.nlzp")]) == 0  # native encode
    capsys.readouterr()
    assert main(["d", str(d / "w.nlzp"), str(d / "y")]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert not (d / "y").exists()
    assert main(["-engine:native", "d", str(d / "w.nlzp"), str(d / "y")]) == 0


@pytest.mark.parametrize("flags,hist_bits,block_size", [
    (["-window:18"], 18, 0),
    (["-blocks:8192", "-parser:greedy"], 13, 8192),
    (["-profile:wide", "-blocks:32768", "-parser:greedy", CPU], 15, 32768),
])
def test_cli_verbose_report(sample, capsys, flags, hist_bits, block_size):
    """-v prints the memory budget (nlzm_tpu's, its "TPU" lines named
    "device") and the stage report; no measured peak on the CPU."""
    data, src, d = sample
    assert main(["-v"] + flags + ["c", str(src), str(d / "v.z")]) == 0
    out = capsys.readouterr().out
    nb = -(-len(data) // block_size) if block_size else 0
    want = jax_memory_report(hist_bits, block_size, nb).replace("TPU", "device")
    for line in want.splitlines():
        assert line.split() == next(
            ln for ln in out.splitlines() if ln.split()[:2] == line.split()[:2]).split()
    assert re.search(r"^  encode +[0-9.]+ s  x1 +[0-9.]+ MB/s$", out, re.M)
    assert "device peak" not in out


def test_cli_module_runs_without_jax(sample):
    """`python -m nlzm_tpu_torch.cli` exits 0 on c, t and h, and the CLI
    loads nothing of jax, nlzm_tpu or bench.py."""
    data, src, d = sample
    dst = d / "m.nlzp"
    r = subprocess.run([sys.executable, "-m", "nlzm_tpu_torch.cli", "-profile:wide", "-blocks",
                        "c", str(src), str(dst)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from nlzm_tpu_torch.cli import main\n"
        f"assert main(['-device:cpu', 't', {str(dst)!r}]) == 0\n"
        f"assert main(['h', {str(src)!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'nlzm_tpu')\n"
        "             or m.startswith(('jax.', 'nlzm_tpu.')))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count(f"{crc32(data):X}") == 2
