#!/usr/bin/env python3
"""find_matches' kernel against another build of it, on one GPU.

    python3 match_compare.py OTHER_CSRC [MORE_CSRC ...]

OTHER_CSRC is a directory holding another find_matches.cu (with its
common.cuh), for example nlzm_tpu_torch/csrc of an earlier commit unpacked
with git archive; each MORE_CSRC another (built as "other2", "other3",
...). Each is built with the port's nvcc flags and launched through its
nlzm_find_matches with the scratch of the design before this one (u64 keys
[B, M] above N = 32768, M the next power of two), which is at least what
this checkout's takes, and the reach as its wrapper passed it. This
checkout's find_matches.cu is built too, as the port builds it and with
each variant of VARIANTS, which end the kernel early to split its time
(NLZM_FM_STOP: after the counts and offsets, pass 1, pass 2's last
items, the whole sort) or compare no byte (NLZM_FM_NO_COMPARE); these
launch through the port's wrapper and are timed, never held. On the
wide encodes' 245 x 32768 (one and three candidates), the same blocks all
zeros (every length 264) and chip_smoke.fm_inputs (the v1 encodes' 1024 x
8192, a 2 MiB file bucket, 8 x 131072, every fuzz_matches pattern, six
candidates) this build and the others are held against find_matches_ref
(the others' mismatches are reported, not raised: the design before this
one capped lengths at N where n_valid passes it), then all are timed in
turns (forward, then back; CUDA events, mean of
chip_smoke.KERNEL_REPS back-to-back calls each) and alone on the device
(chip_smoke.kernel_device_ms, torch.profiler). Prints one JSON line an
input, then the card's name and power limit. Imports nothing of JAX or of
nlzm_tpu.
"""

import json
import sys
from contextlib import nullcontext
from pathlib import Path

import chip_smoke as cs
from cover_compare import build_other, using

ENTRIES = (("nlzm_find_matches", 5, 5),)
# this checkout's source ended early (timed, never held): after the counts
# and offsets, pass 1, pass 2's last items, the whole sort; and with no
# byte compared
VARIANTS = {"offsets": ("NLZM_FM_STOP=1",), "pass1": ("NLZM_FM_STOP=2",),
            "pass2_last": ("NLZM_FM_STOP=3",), "sort_only": ("NLZM_FM_STOP=4",),
            "no_compare": ("NLZM_FM_NO_COMPARE",)}


def other_call(fn, dt, nvt, reach: int, C: int):
    """A call of another build's nlzm_find_matches, with its own scratch;
    returns (delta, mlen) as find_matches does."""
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    B, N = dt.shape
    M = eo._next_pow2(N)
    shape = (B, N) if C == 1 else (B, N, C)
    delta = torch.empty(shape, dtype=torch.int32, device=dt.device)
    mlen = torch.empty(shape, dtype=torch.int32, device=dt.device)
    keys = torch.empty(B, M, dtype=torch.int64, device=dt.device) if N > 32768 else None
    _build.launch(fn, [dt.data_ptr(), nvt.data_ptr(), delta.data_ptr(), mlen.data_ptr(),
                       None if keys is None else keys.data_ptr()], [B, N, M, reach, C], dt.device)
    return delta, mlen


def compare(label: str, args, builds: dict) -> dict:
    """Hold every build of `builds` ({name: (entries, through the port's
    wrapper, held)}; entries None for the port's own) against
    find_matches_ref, then time them in turns, forward and back, and alone
    on the device."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    dt, nvt, reach, C = args

    def runner(name):
        fns, wrapped, _ = builds[name]
        if wrapped:
            return lambda: eo.find_matches(dt, nvt, reach, C), lambda: using(fns, "find_matches")
        fn = fns["nlzm_find_matches"]
        return lambda: other_call(fn, dt, nvt, reach, C), nullcontext

    want = eo.find_matches_ref(dt, nvt, reach, C)
    exact = {}
    for name, (_, wrapped, held) in builds.items():
        if not held:
            continue
        call, ctx = runner(name)
        with ctx():
            got = call()
        torch.cuda.synchronize()
        exact[name] = cs.max_abs_err(got, want) == 0
        if wrapped and not exact[name]:  # this checkout's builds are exact
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
            device[name] = cs.kernel_device_ms(call, "find_matches")
    B, N = dt.shape
    return {"input": label, "blocks": B, "N": N, "C": C, "reach": reach,
            "bound_ms": cs.bound(*cs.fm_work(dt, nvt, *want))[0], "exact": exact,
            **{f"{n}_ms": t for n, t in times.items()},
            **{f"{n}_device_ms": t for n, t in device.items()},
            "shape": cs.fm_shape(B, N, C)}


def main() -> int:
    import torch

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("match_compare: no CUDA device", file=sys.stderr)
        return 2
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    reports = _build.build(("find_matches",))
    builds, ptxas = {}, {"this": [ln for ln in reports.get("find_matches", "").splitlines()
                                  if "registers" in ln]}
    for i, src in enumerate(sys.argv[1:]):
        name = f"other{i + 1}" if i else "other"
        fns, ptxas[name] = build_other(Path(src), "find_matches", ENTRIES, (), name)
        builds[name] = (fns, False, True)
    builds["this"] = (None, True, True)
    here = Path(_build.__file__).resolve().parent / "csrc"
    for name, defines in VARIANTS.items():
        fns, ptxas[name] = build_other(here, "find_matches", ENTRIES, defines, name)
        builds[name] = (fns, True, False)
    print(json.dumps({"other": sys.argv[1:], "ptxas": ptxas}), flush=True)

    corpus = cs.build_corpus(max(cs.SHIP_BYTES, cs.V1_ENC_BYTES))
    arr, nv = eo._blocks_arrays(corpus[: cs.SHIP_BYTES], cs.ENC_GREEDY["block_size"])
    wt, wnvt = torch.as_tensor(arr, device="cuda"), torch.as_tensor(nv, device="cuda")
    reach = (1 << cs.ENC_HIST_BITS) - 1
    wide = [(f"wide_245x32768_c{C}", (wt, wnvt, reach, C)) for C in (1, 3)]
    zeros = torch.zeros_like(wt)
    wide += [(f"zeros_245x32768_c{C}", (zeros, wnvt, reach, C)) for C in (1, 3)]
    for label, args in (*wide, *cs.fm_inputs(corpus, "cuda")):
        print(json.dumps(compare(label, args, builds)), flush=True)
        del args
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
