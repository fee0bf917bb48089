#!/usr/bin/env python3
"""repify's kernel against another build of it, on one GPU.

    python3 repify_compare.py OTHER_CSRC

OTHER_CSRC is a directory holding another repify.cu (with its common.cuh),
for example nlzm_tpu_torch/csrc of an earlier commit unpacked with git
archive. It is built with the port's nvcc flags, and so are three variants
of this checkout's repify.cu (VARIANTS): "matches_only" (no segments: each
block's warp replays it from row 0, matches only), "g4" and "g8" (4 or 8
blocks a CTA whatever B). Every build's nlzm_repify takes the same
arguments, so the port's wrapper launches it unchanged. On each input every
build is held exactly against repify_ref, then timed in turns (forward,
then back; CUDA events, mean of chip_smoke.KERNEL_REPS back-to-back calls
each): the wide encodes' 245 x 32768 and the v1 encodes' 1024 x 8192
greedy commands, a 2 MiB file bucket of the latter (256 x 8192), the
optimal parse's first-round commands at 1024 x 8192, and every
chip_smoke.fuzz_rep pattern at 1024 x 8192. Prints one JSON line an input
(with ns a match of the block with the most matches, ns a row and
chip_smoke.rep_model's runs), then the card's name and power limit.
Imports nothing of JAX or of nlzm_tpu.
"""

import json
import sys
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_repify", 3, 2),)
VARIANTS = {"matches_only": ("NLZM_REPIFY_RUNS=0",), "g4": ("NLZM_REPIFY_BLOCKS=4",),
            "g8": ("NLZM_REPIFY_BLOCKS=8",)}


def compare(label: str, op_len, op_val, builds: dict) -> dict:
    """Hold every build of `builds` ({name: build_other's entries, None
    for the port's}) against repify_ref, then time them in turns, forward
    and back."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    want = eo.repify_ref(op_len, op_val)
    for name, fns in builds.items():
        with using(fns, "repify"):
            got = eo.repify(op_len, op_val)
        torch.cuda.synchronize()
        if cs.max_abs_err(got, want) != 0:
            raise AssertionError(f"{label}: the {name} kernel differs from the plain version")
    times = {name: [] for name in builds}
    for name in [*builds, *reversed(builds)]:
        with using(builds[name], "repify"):
            times[name].append(cs.timed_mean(lambda: eo.repify(op_len, op_val), cs.KERNEL_REPS))
    T, B = op_len.shape
    matches = (op_len > 0).sum(0)
    longest = max(int(matches.max()), 1)
    return {"input": label, "blocks": B, "rows": T, "matches": int(matches.sum()),
            "max_matches": longest, "runs": cs.rep_runs(op_len, op_val),
            "bound_ms": cs.bound(*cs.rep_work(op_len))[0],
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_ns_per_match": min(t) * 1e6 / longest for n, t in times.items()},
            **{f"{n}_ns_per_row": min(t) * 1e6 / T for n, t in times.items()}}


def inputs(device):
    """(label, op_len, op_val) of every input above, on `device`."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    put = lambda a: torch.as_tensor(a, device=device)
    corpus = cs.build_corpus(max(cs.SHIP_BYTES, cs.V1_ENC_BYTES))

    def blocks(data, N):
        arr, nv = eo._blocks_arrays(data, N)
        return put(arr), put(nv), (N + 255) // 256 * 256

    dt, nvt, T = blocks(corpus[:cs.SHIP_BYTES], cs.ENC_GREEDY["block_size"])
    reach = (1 << cs.ENC_HIST_BITS) - 1
    yield ("wide_245x32768", *eo.greedy_cover(dt, *eo.find_matches(dt, nvt, reach), nvt, T))
    dt, nvt, T = blocks(corpus[:cs.V1_ENC_BYTES], cs.V1_ENC["block_size"])
    reach = (1 << cs.V1_ENC_HIST_BITS) - 1
    ol, ov = eo.greedy_cover(dt, *eo.find_matches(dt, nvt, reach), nvt, T)
    yield "v1_1024x8192", ol, ov
    nb = cs.STREAM_BUCKET // cs.V1_ENC["block_size"]
    yield "file_bucket_256x8192", ol[:, :nb].contiguous(), ov[:, :nb].contiguous()
    d3, m3 = eo.find_matches(dt, nvt, reach, 3)
    yield ("opt_round1_1024x8192", *eo.dp_cover(dt, d3, *eo.dp_parse(d3, m3, nvt), nvt, T))
    for pat, cmds in cs.fuzz_rep(7, 1024, T).items():
        yield (pat, *(put(a) for a in cmds))


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("repify_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build

    reports = _build.build(("repify", "find_matches", "greedy_cover", "dp_parse"))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("repify", "").splitlines()
                                  if "registers" in ln]}
    builds["other"], ptxas["other"] = build_other(Path(sys.argv[1]), "repify", ENTRIES)
    builds["this"] = None
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        builds[name], ptxas[name] = build_other(here, "repify", ENTRIES, defines, name)
    print(json.dumps({"other": sys.argv[1], "ptxas": ptxas}), flush=True)
    for label, ol, ov in inputs("cuda"):
        print(json.dumps(compare(label, ol, ov, builds)), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
