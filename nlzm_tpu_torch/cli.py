"""Command-line interface of the port.

The commands, flag grammar, outputs and exit codes of nlzm_tpu/cli.py
(itself the reference CLI, NLZM.cpp:2165-2171, with the block-parallel
profile), on the port's engines:

    python -m nlzm_tpu_torch.cli [flags] c <input> <output>   compress
    python -m nlzm_tpu_torch.cli d <input> <output>           decompress
    python -m nlzm_tpu_torch.cli t <input>                    decompress in memory
    python -m nlzm_tpu_torch.cli h <input>                    CRC32

Flags (anywhere in the command line):
    -window:bits    window size in bits (15..28, default 22)
    -parser:name    greedy | optimal (default optimal)
    -blocks[:size]  use the NLZP block-parallel container (device decode
                    path); optional uncompressed block size in bytes
    -profile:name   block profile: v1 (NLZM-compatible frames, default)
                    | wide (lane-parallel planes)
    -engine:name    auto | native | device (default auto: a container
                    decodes on the device, everything else on the native
                    host engine)
    -device:name    cuda | cpu (default cuda): where the device engine
                    runs; cpu runs the kernels' plain versions
    -dict:size      wide profile: shared-dictionary bytes sampled from the
                    input (0 = off)
    -v              verbose: memory budget + per-stage timing report (and
                    the measured device peak of a CUDA run)

nlzm_tpu's engine "tpu" is "device" here; its "serial" (the pure-Python
codec) is not ported. The single-stream format (no -blocks) has no device
path: it runs on the native engine, and -engine:device refuses it.
-device:cuda without a CUDA device fails; nothing falls back to the CPU.
Both formats stream through bounded buffers: container files encode and
decode bucket by bucket (parallel/stream.py), single streams through the
native streaming codec (codec.py).
"""

import os
import sys
import time

from .constants import DEFAULT_HIST_BITS
from .utils.crc32 import crc32

ENGINES = ("auto", "native", "device")


def _fail(msg: str) -> int:
    print(f"Error: {msg}")
    return 1


def _usage() -> int:
    print(__doc__)
    return 1


def _cuda_missing(device: str) -> bool:
    import torch

    return torch.device(device).type == "cuda" and not torch.cuda.is_available()


def main(argv=None) -> int:
    from . import __version__

    argv = list(sys.argv[1:] if argv is None else argv)
    print(f"nlzm-tpu-torch {__version__} - NLZM-class codec on PyTorch/CUDA")

    window_bits = DEFAULT_HIST_BITS
    parser = "optimal"
    block_size = 0  # 0 => single-stream NLZM format
    profile = "v1"
    engine = "auto"
    device = "cuda"
    dict_size = 0
    verbose = False

    # flags are accepted anywhere in argv (before or after the command)
    flags = [a for a in argv if a.startswith("-")]
    argv = [a for a in argv if not a.startswith("-")]
    for raw in flags:
        arg = raw.lstrip("-").lower()
        if arg == "v":
            verbose = True
        elif arg.startswith("window:"):
            window_bits = max(15, min(28, int(arg[7:])))
            print(f"Window bits: {window_bits}")
        elif arg.startswith("parser:"):
            parser = arg[7:]
        elif arg == "blocks":
            from .parallel.blocks import DEFAULT_BLOCK_SIZE

            block_size = DEFAULT_BLOCK_SIZE
        elif arg.startswith("blocks:"):
            block_size = int(arg[7:])
        elif arg.startswith("profile:"):
            profile = arg[8:]
        elif arg.startswith("engine:"):
            engine = arg[7:]
            if engine not in ENGINES:
                return _fail(f"engine {engine!r}: the port's engines are auto | native | device "
                             f"(nlzm_tpu's 'tpu' is 'device'; 'serial' is not ported)")
        elif arg.startswith("device:"):
            device = arg[7:]
            if device.split(":")[0] not in ("cuda", "cpu"):
                return _fail(f"device {device!r}: cuda | cpu")
        elif arg.startswith("dict:"):
            dict_size = int(arg[5:])
        else:
            return _fail(f"unrecognized flag {arg}")

    # flag-order-independent profile/block validation
    if profile == "wide":
        from .parallel.blocks import DEFAULT_BLOCK_SIZE, WIDE_MAX_BLOCK

        if not block_size:
            # default to the fast 32 KiB profile; bigger blocks (to
            # WIDE_MAX_BLOCK) trade decode speed for ratio
            block_size = min(DEFAULT_BLOCK_SIZE, 32768)
        elif block_size > WIDE_MAX_BLOCK:
            return _fail(
                f"-profile:wide caps blocks at {WIDE_MAX_BLOCK} (got {block_size})"
            )

    if not argv:
        return _usage()
    cmd = argv.pop(0).lower()

    from .native import NativeUnavailable

    try:
        if cmd == "h" and len(argv) == 1:
            with open(argv[0], "rb") as f:
                print(f"{crc32(f.read()):X}")
            return 0
        if cmd == "c" and len(argv) == 2:
            return _compress(*argv, window_bits, parser, block_size, profile, engine, device,
                             dict_size, verbose)
        if cmd in ("d", "t") and len(argv) in (1, 2):
            if cmd == "d" and len(argv) == 1:
                return _usage()
            return _decompress(argv[0], argv[1] if len(argv) == 2 else None, engine, device)
    except NativeUnavailable as e:
        return _fail(f"native host engine unavailable: {e}")
    return _usage()


def _compress(src, dst, window_bits, parser, block_size, profile, engine, device, dict_size,
              verbose) -> int:
    from .utils.metrics import (
        Metrics, ProgressLine, device_peak_report, device_peak_reset, memory_report,
    )

    if os.path.exists(dst):
        return _fail(f"{dst} already exists")
    if not block_size and engine == "device":
        return _fail("the single-stream format has no device path; use -blocks, or "
                     "-engine:auto | native")
    # the device engine runs for -engine:device and for the wide greedy encode
    uses_device = block_size and (engine == "device" or (profile == "wide"
                                                          and parser != "optimal"))
    if uses_device and _cuda_missing(device):
        return _fail(f"-device:{device}: no CUDA device (-device:cpu runs on the CPU)")
    flen = os.stat(src).st_size
    if verbose:
        if block_size:
            from .parallel.blocks import hist_bits_for_block

            nb = (flen + block_size - 1) // block_size
            print(memory_report(hist_bits_for_block(block_size), block_size, nb))
        else:
            print(memory_report(window_bits))
        device_peak_reset(device)

    m = Metrics()
    prog = ProgressLine(flen)
    with m.stage("encode", flen):
        if not block_size:
            # bounded-memory streaming encode: RSS stays O(window)
            # however large the file (reference NLZM.cpp:1870-1885)
            from .codec import encode_file

            r = encode_file(src, dst, window_bits, parser=parser, progress=prog)
        elif profile != "wide" or (parser == "optimal" and engine != "device"):
            # bucket-at-a-time container streaming: O(window + bucket)
            # RSS at any file size (parallel/stream.py)
            from .parallel.stream import encode_container_stream

            r = encode_container_stream(
                src, dst, block_size, parser=parser, engine=engine, profile=profile,
                dict_size=dict_size, progress=prog, device=device,
            )
        else:
            from .parallel.blocks import encode_container

            with open(src, "rb") as f:
                data = f.read()
            out = encode_container(data, block_size=block_size, parser=parser, engine=engine,
                                   profile=profile, dict_size=dict_size, device=device)
            with open(dst, "wb") as f:
                f.write(out)
            r = {"in": len(data), "out": len(out), "crc32": crc32(data)}
    prog.finish()
    print(
        f"{r['in']} -> {r['out']} bytes "
        f"(input CRC32 {r['crc32']:X}, {m.stages['encode'].seconds:.2f} sec)"
    )
    if verbose:
        print(m.report())
        peak = device_peak_report(device)
        if peak:
            print(peak)
    return 0


def _decompress(src, dst, engine, device) -> int:
    from .parallel.blocks import MAGIC
    from .utils.metrics import ProgressLine

    if dst and os.path.exists(dst):
        return _fail(f"{dst} already exists")
    with open(src, "rb") as f:
        magic = f.read(4)
    flen = os.stat(src).st_size
    t0 = time.time()
    prog = ProgressLine(flen)
    if magic[:4] != MAGIC:
        if engine == "device":
            return _fail("the single-stream format has no device path; use -engine:auto | "
                         "native")
        # single-stream format: bounded-memory streaming decode
        from .codec import decode_file

        r = decode_file(src, dst, progress=prog)
    else:
        # NLZP container: bucket-at-a-time streaming decode
        from .parallel.stream import decode_container_stream

        eng = "device" if engine == "auto" else engine
        if eng == "device" and _cuda_missing(device):
            return _fail(f"-device:{device}: no CUDA device (-device:cpu runs on the CPU)")
        r = decode_container_stream(src, dst, device=device, engine=eng, progress=prog)
    prog.finish()
    print(f"{r['in']} -> {r['out']} bytes (output CRC32 {r['crc32']:X}, "
          f"{time.time() - t0:.2f} sec)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
