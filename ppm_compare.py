#!/usr/bin/env python3
"""ppm_decode's kernel against another build of it, on one GPU.

    python3 ppm_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding another ppm_decode.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags and launched through its
nlzm_ppm_decode with the scratch of the one-launch design before this one
(int32 carries [B, 8192, 16] and fences [B, 8192, 17]), which is at least
what this checkout's takes. This checkout's ppm_decode.cu is built too, as
the port builds it and with each variant of VARIANTS: 8 slots in shared
memory (NLZM_PPM_CACHE=8: the rows past them built into device memory);
these launch through the port's wrapper. On the NLZC bench (4 MiB at 16
KiB blocks, 256 x 512), random words at 256 x 512 and at 128 x 1024, every
chip_smoke.fuzz_ppm pattern and steps2's first block alone
(chip_smoke.ppm_inputs) every build is held exactly against
_decode_blocks_ref, then timed in turns (forward, then back; CUDA events,
mean of chip_smoke.KERNEL_REPS back-to-back calls each) and alone on the
device (chip_smoke.kernel_device_ms, torch.profiler). Prints one JSON line
an input, then the card's name and power limit. Imports nothing of JAX or
of nlzm_tpu.
"""

import json
import sys
from contextlib import nullcontext
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_ppm_decode", 7, 4),)
VARIANTS = {"cache8": ("NLZM_PPM_CACHE=8",)}


def other_call(fn, args):
    """A call of another build's nlzm_ppm_decode on args, with its own
    scratch; returns the output."""
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.research import ppm_tpu

    words, seg_lens, prior, steps = args
    B, W = words.shape
    dev = words.device
    sched = torch.tensor(ppm_tpu.chunk_schedule(steps), dtype=torch.int32, device=dev)
    carry = torch.empty(B, 2 * ppm_tpu.ROWS, 16, dtype=torch.int32, device=dev)
    tables = torch.empty(B, 2 * ppm_tpu.ROWS, 17, dtype=torch.int32, device=dev)
    out = torch.empty(B, steps, ppm_tpu.LANES, dtype=torch.uint8, device=dev)
    _build.launch(fn, [words.data_ptr(), seg_lens.data_ptr(), prior.data_ptr(), sched.data_ptr(),
                       carry.data_ptr(), tables.data_ptr(), out.data_ptr()],
                  [B, W, steps, sched.numel()], dev)
    return out


def compare(label: str, args, builds: dict) -> dict:
    """Hold every build of `builds` ({name: (entries, through the port's
    wrapper)}; entries None for the port's own) against _decode_blocks_ref,
    then time them in turns, forward and back, and alone on the device."""
    import torch

    from nlzm_tpu_torch.research import ppm_tpu

    def runner(name):
        fns, wrapped = builds[name]
        if wrapped:
            return lambda: ppm_tpu._decode_blocks(*args), lambda: using(fns, "ppm_decode")
        fn = fns["nlzm_ppm_decode"]
        return lambda: other_call(fn, args), nullcontext

    want = ppm_tpu._decode_blocks_ref(*args)
    for name in builds:
        call, ctx = runner(name)
        with ctx():
            got = call()
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            raise AssertionError(f"{label}: the {name} kernel differs from the plain version")
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        call, ctx = runner(name)
        with ctx():
            times[name].append(cs.timed_mean(call, cs.KERNEL_REPS))
    device = {}
    for name in builds:
        call, ctx = runner(name)
        with ctx():
            device[name] = cs.kernel_device_ms(call, "ppm")
    B, W = args[0].shape
    steps = args[3]
    return {"input": label, "blocks": B, "W": W, "steps": steps,
            "bound_ms": cs.bound(*cs.ppm_decode_work(args, want))[0],
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_device_ms": t for n, t in device.items()}}


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ppm_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.research import ppm_tpu

    reports = _build.build(("ppm_decode",))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("ppm_decode", "").splitlines()
                                  if "registers" in ln]}
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        fns, ptxas[name] = build_other(Path(src), "ppm_decode", ENTRIES, (), name)
        builds[name] = (fns, False)
    builds["this"] = (None, True)
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        fns, ptxas[name] = build_other(here, "ppm_decode", ENTRIES, defines, name)
        builds[name] = (fns, True)
    corpus = cs.build_corpus(cs.NLZC["bytes"])
    blob = ppm_tpu.compress(corpus, cs.NLZC["block_size"])
    pd, _ = ppm_tpu.stage_container(blob, "cuda")
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas,
                      "shape": cs.ppm_shape(*pd[0].shape)}), flush=True)
    for label, args in (("nlzc_256x512", pd), *cs.ppm_inputs(pd, "cuda")):
        print(json.dumps(compare(label, args, builds)), flush=True)
        del args
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
