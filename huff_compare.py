#!/usr/bin/env python3
"""huff_scan's kernel against another build of it, on one GPU.

    python3 huff_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding another huff_scan.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags, and so is this
checkout's huff_scan.cu with each variant of VARIANTS: K (bits a span)
fixed at 128, 256 and 512 in place of the kernel's rule, and 512 threads a
CTA where the kernel takes 1024. Every build's nlzm_huff_scan takes the same arguments, so the
port's wrapper launches it unchanged. On each input of
chip_smoke.huff_inputs (the huff0 bench at 245 x 32768, the NLZC prior at 4
x 32768, random bytes, 64-symbol and 128-symbol bytes at 245 x 32768,
2 MiB at 128 KiB blocks, every
chip_smoke.fuzz_huff pattern at 16 x 4096) every build is held exactly
against _huff_scan_ref, then timed in turns (forward, then back; CUDA
events, mean of chip_smoke.KERNEL_REPS back-to-back calls each) and alone
on the device (chip_smoke.kernel_device_ms, torch.profiler). Prints one
JSON line an input, then the card's name and power limit. Imports nothing
of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_huff_scan", 6, 3),)
VARIANTS = {
    "k128": ("NLZM_HUFF_KW=4",),
    "k256": ("NLZM_HUFF_KW=8",),
    "k512": ("NLZM_HUFF_KW=16",),
    "t512": ("NLZM_HUFF_THREADS=512",),
}


def compare(label: str, args, builds: dict) -> dict:
    """Hold every build of `builds` ({name: build_other's entries, None
    for the port's}) against _huff_scan_ref, then time them in turns,
    forward and back, and alone on the device."""
    import torch

    from nlzm_tpu_torch.research import huff0

    call = lambda: huff0._huff_scan(*args)
    want = huff0._huff_scan_ref(*args)
    for name, fns in builds.items():
        with using(fns, "huff_scan"):
            got = call()
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            raise AssertionError(f"{label}: the {name} kernel differs from the plain version")
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name], "huff_scan"):
            times[name].append(cs.timed_mean(call, cs.KERNEL_REPS))
    device = {}
    for name, fns in builds.items():
        with using(fns, "huff_scan"):
            device[name] = cs.kernel_device_ms(call, "huff")
    B, S = args[0].shape
    T = args[5]
    return {"input": label, "blocks": B, "S": S, "T": T,
            "bound_ms": cs.bound(*cs.huff_work(args))[0],
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_device_ms": t for n, t in device.items()},
            **{f"{n}_ns_per_symbol": min(t) * 1e6 / max(B * T, 1) for n, t in times.items()}}


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("huff_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build

    reports = _build.build(("huff_scan",))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("huff_scan", "").splitlines()
                                  if "registers" in ln]}
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        builds[name], ptxas[name] = build_other(Path(src), "huff_scan", ENTRIES, (), name)
    builds["this"] = None
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        builds[name], ptxas[name] = build_other(here, "huff_scan", ENTRIES, defines, name)
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas, "shape": cs.huff_shape(245)}),
          flush=True)
    corpus = cs.build_corpus(cs.HUFF0["bytes"])
    prior = cs.nlzc_prior_container(corpus[: cs.NLZC["bytes"]], cs.NLZC["block_size"])
    for label, args in cs.huff_inputs(corpus, prior, "cuda"):
        print(json.dumps(compare(label, args, builds)), flush=True)
        del args
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
