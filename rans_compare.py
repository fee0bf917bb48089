#!/usr/bin/env python3
"""rans_backward's kernel against another build of it, on one GPU.

    python3 rans_compare.py OTHER_CSRC

OTHER_CSRC is a directory holding another rans_backward.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive. It is built with the port's nvcc flags, and so is this
checkout's rans_backward.cu with G, the blocks a CTA, fixed at 1, 2, 4 and
8 (VARIANTS). Every build's nlzm_rans_backward takes the same arguments, so
the port's wrapper launches it unchanged. On each input every build is
held exactly against rans_backward_ref, then timed in turns (forward, then
back; CUDA events, mean of chip_smoke.KERNEL_REPS back-to-back calls each):
the v1 encodes' greedy spans at 1024 x 8192, a 2 MiB file bucket of them
(256 x 8192), the optimal parse's final spans at 1024 x 8192, dense spans
at 1024 x 8192 and every chip_smoke.fuzz_spans pattern at 16 x 4096, each
at its frame cap. Prints one JSON line an input (with ns a step of the
longest chain, the most spans a block / 4), then the card's name and power
limit. Each build's kernel is also timed alone on the device
(chip_smoke.kernel_device_ms, torch.profiler): the short inputs' CUDA-event
means are the wrapper's host time. Imports nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_rans_backward", 4, 3),)
VARIANTS = {f"g{G}": (f"NLZM_RANS_BLOCKS={G}",) for G in (1, 2, 4, 8)}


def compare(label: str, spans, builds: dict) -> dict:
    """Hold every build of `builds` ({name: build_other's entries, None
    for the port's}) against rans_backward_ref at the frame cap, then time
    them in turns, forward and back."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    cap = cs.rans_frame_cap(spans.shape[0])
    want = eo.rans_backward_ref(spans, cap)
    for name, fns in builds.items():
        with using(fns, "rans_backward"):
            got = eo.rans_backward(spans, cap)
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            raise AssertionError(f"{label}: the {name} kernel differs from the plain version")
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name], "rans_backward"):
            times[name].append(cs.timed_mean(lambda: eo.rans_backward(spans, cap), cs.KERNEL_REPS))
    device = {}
    for name, fns in builds.items():
        with using(fns, "rans_backward"):
            device[name] = cs.kernel_device_ms(lambda: eo.rans_backward(spans, cap), "rans")
    T, B, _ = spans.shape
    per_block = (spans != 0).sum(dim=(0, 2))
    steps = max(int(per_block.max()) / 4, 1)
    return {"input": label, "blocks": B, "rows": T, "cap": cap, "spans": int(per_block.sum()),
            "max_spans": int(per_block.max()), "bound_ms": cs.bound(*cs.rans_work(spans, cap))[0],
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_device_ms": t for n, t in device.items()},
            **{f"{n}_ns_per_step": min(t) * 1e6 / steps for n, t in times.items()}}


def inputs(device):
    """(label, spans) of every input above, on `device`."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    put = lambda a: torch.as_tensor(a, device=device)
    N = cs.V1_ENC["block_size"]
    arr, nv = eo._blocks_arrays(cs.build_corpus(cs.V1_ENC_BYTES), N)
    dt, nvt = put(arr), put(nv)
    reach = (1 << cs.V1_ENC_HIST_BITS) - 1
    for parser in ("greedy", "optimal"):
        ol, ov = eo._device_parse(dt, nvt, reach, N, parser)
        spans = eo.emit_model(ol, ov, eo.repify(ol, ov))[0]
        del ol, ov
        yield f"v1_{parser}_1024x8192", spans
        if parser == "greedy":
            nb = cs.STREAM_BUCKET // N
            yield "file_bucket_256x8192", spans[:, :nb].contiguous()
        del spans
    yield "dense_1024x8192", put(cs.fuzz_spans(7, N, 1024, ("dense",))["dense"])
    for pat, arr in cs.fuzz_spans(7, 4096, 16).items():
        yield pat, put(arr)


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rans_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build

    reports = _build.build(("rans_backward", "find_matches", "greedy_cover", "repify",
                            "emit_model", "dp_parse", "measure_costs"))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("rans_backward", "").splitlines()
                                  if "registers" in ln]}
    builds["other"], ptxas["other"] = build_other(Path(sys.argv[1]), "rans_backward", ENTRIES)
    builds["this"] = None
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        builds[name], ptxas[name] = build_other(here, "rans_backward", ENTRIES, defines, name)
    print(json.dumps({"other": sys.argv[1], "ptxas": ptxas,
                      "shapes": {B: cs.rans_shape(B) for B in (16, 256, 1024)}}), flush=True)
    for label, spans in inputs("cuda"):
        print(json.dumps(compare(label, spans, builds)), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
