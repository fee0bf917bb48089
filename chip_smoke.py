#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nlzm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths - wide-profile and v1 NLZP container decode,
in memory and from files, and the wide-profile and v1 device encodes with
the greedy and the optimal parse, in memory and (v1) to a file, and the
block-sharded forms of the decodes and the v1 encode - on the card and
fails (nonzero exit, no result line) on anything wrong:

1. device: a CUDA device is required; prints the card's name and power limit;
2. build: compiles the eighteen kernels (seventeen sources) from
   nlzm_tpu_torch/csrc with nvcc, one process per source, all at once;
3. kernels: encodes the bench corpus (8 MB) at the wide shipping config
   with the native host encoder, stages it on the card, and holds each
   wide-path kernel against its plain PyTorch version on the same device
   tensors at these main-path shapes (exact: the codec is integer and
   lossless), lz_expand also at round hints 0 and 1; times both with
   CUDA events (plane_scan, assemble and lz_expand through the main
   path's entries: the container's u16 priors unchecked, the commands
   handed over as [B, TP] pairs);
4. e2e_ship: decode_container(device="cuda") must return the input
   (CRC-verified) with every kernel of the path launched; decode MB/s;
5. e2e_frontier: the same at 128 KiB blocks, 128 KiB dictionary, depth
   cap 12, on 4 MB; then plane_scan (untimed in the tally, timed apart:
   ps_timing) and lz_expand at round hints 0 and 1 against their plain
   versions on these buckets;
6. corrupt: a flipped stream byte must raise IntegrityError, and a valid
   decode right after must still succeed;
7. kernels_v1: the bench's v1 config (8 MB, 32 KiB blocks, optimal
   parse): fsm_decode against fsm_decode_v2_ref and lz_expand on the v1
   command arrays against its plain version, exact; CUDA-event times
   (the plain fsm on the card replays one step's CUDA graph);
   fsm_decode also on hostile_streams of that bucket (two seeds, 1024
   steps) against its plain version, exact; then fsm_decode timed, with
   its steps and ns a step of the longest block's chain, on the bench
   bucket, on one 2 MiB bucket of the file decode and on the CLI
   default's buckets (9's container);
8. e2e_v1_bench: the v1 decode of that container, as in 4;
9. e2e_v1_cli: the CLI's block default (128 KiB blocks, v1, optimal) on
   8 MB, end to end only;
10. e2e_v1_512k: 2 MB at 512 KiB blocks (greedy), end to end, then
    lz_expand at round hints 0 and 1 on its commands: the kernel's
    literal mask in global memory;
11. corrupt_v1: a flipped v1 payload bit must raise IntegrityError, and a
    valid decode right after must still succeed;
12. stream: the shipping wide and the bench v1 containers as files,
    decode_container_stream(bucket_bytes=2 MiB) to a file and in test
    mode: output and CRC must equal the input's, with the four wide
    kernels, or fsm_decode and lz_expand, launched;
13. kernels_enc: the device encode's kernels at the 8 MB, 32 KiB-block
    shapes (245 blocks), each against its plain version, exact, with
    CUDA-event times: find_matches with 1 and 3 candidates (reach 32767),
    greedy_cover and repify on its output (repify also with ns a match,
    ns a row and rep_model's runs: rep_timing), plane_encode_planes (the
    five planes in one launch) on the bench's native-parsed commands with
    and without priors (each plane also through plane_encode) and on 1 MiB
    of random bytes at 128 KiB blocks (its lit plane through the large
    path), each timed with device ms, bound and launch shape
    (pe_timing; the plain version timed on its comparison call), and
    plane_encode on a synthetic 4-row plane;
14. e2e_enc_greedy: encode_container(profile="wide", parser="greedy",
    engine="device") of the 8 MB on the card; the device plane encode's
    payloads and priors on the device-parsed commands must equal
    native.wide_encode's, the container must hold them, and the card's
    decode must return the input; one plane_encode launch; encode MB/s
    and the ratio;
15. e2e_enc_pipeline: encode_pipeline_device at 32 KiB blocks, timed as
    bench.py:313-334 (parse, staging, run: one plane_encode launch); its
    payloads on all 8 MB must equal native.wide_encode's;
16. kernels_v1enc: the v1 device encode's kernels at the 8 MiB, 8 KiB-block
    shapes (1024 blocks, 8192 steps, reach 8191): emit_model on the
    kernels' greedy commands, rans_backward on its spans and bits_forward
    on its fields, each against its plain version, exact, with CUDA-event
    times; rans_backward and bits_forward also at a 101-byte cap, where
    writes are dropped; all three on fuzz_commands (the clamps);
    emit_model also timed on one 2 MiB bucket of the file encode (256
    blocks), with ns a step; repify held on the greedy commands and on
    that bucket, each timed (rep_timing); rans_backward held and timed
    on that bucket too, and timed on the greedy spans with ns a step of
    the longest chain, its registers, CTAs an SM and waves (rans_timing);
17. e2e_enc_v1: encode_container(profile="v1", parser="greedy",
    engine="device") of the 8 MiB at 8 KiB blocks; every payload must
    decode through the host decoder native.decode_block and the
    container through the card's decode (fsm_decode); encode MB/s and
    the ratio;
18. stream_enc_v1: encode_container_stream of the 8 MiB file to a file on
    the card, 2 MiB buckets; its bytes must equal 17's container;
19. kernels_opt: the optimal parse's kernels at the 8 MiB, 8 KiB-block
    shapes (3 candidates): dp_parse with the default costs and with the
    [B, 6] rows measure_costs gives after round 1, dp_cover on its
    choices, measure_costs on emit_model's spans, each against its plain
    version, exact, with CUDA-event times; measure_costs also held at the
    wide optimal shape (245 x 32768) and on a 2 MiB bucket's 256 blocks,
    and each of its three shapes timed with device ms, bound and launch
    shape (mc_timing); untimed, dp_parse and
    dp_cover's global-scratch walk at 128 KiB blocks on 1 MiB, all three
    on fuzz_opt (wraps and clamps) and dp_parse on fuzz_dp_runs (runs,
    short and long reaches, five max_len, both cost rows); dp_parse also
    held and timed at the wide optimal shape (8 MB at 32 KiB blocks, 245
    blocks) and on 1 MiB of long matches at 8 KiB blocks, with ns a
    position and the modelled shares of its three steps (dp_steps);
    emit_model at the wide optimal encode's shape (T = 32768) against its
    plain version, exact, and timed; repify held and timed on the first
    round's commands; rans_backward held and timed (rans_timing) on the
    spans of the optimal parse's last round; then phase kernels_cover:
    the cover walk (greedy_cover and dp_cover, csrc/greedy_cover.cu)
    against its plain versions, exact, at every shape it runs (1024 x 8192, 245 x
    32768 with dp at C = 3, the global-scratch path at 128 KiB blocks),
    on 1 MiB of long matches, fuzz_opt and every fuzz_cover pattern (16 x
    4096, 1024 x 8192, 4 x 131072); each but the small fuzz sets timed,
    with ns a command and resident CTAs an SM (cover_timing); then phase
    kernels_rep: repify (csrc/repify.cu) against its plain version, exact,
    on every fuzz_rep pattern at 16 x 4096 and at 1024 x 8192 (timed,
    with rep_model's runs), and on hostile and random6 segments longer
    than the kernel's match masks reach (16 x 70000, 528 x 33000); then
    phase kernels_rans: rans_backward's span records (a and the magic)
    for every f in 1..65535 against rans_magic's, exact, and the kernel
    against its plain version, exact, on every fuzz_spans pattern at 16 x
    4096 (at its frame cap and at caps 1024, 101 and 37) and on dense spans
    at 1024 x 8192, each timed (rans_timing, with the kernel's device time
    from torch.profiler); then phase kernels_fm: find_matches against its
    plain version, exact, at 1024 x 8192 (one and three candidates), one
    2 MiB file bucket (256 x 8192, both), 8 x 131072 (three: positions in
    device memory) and every fuzz_matches pattern (zeros, runs, random
    bytes, one-hash collisions, ragged blocks and n_valid outside 0..N,
    reaches 1 to past N, N from 700 to 131072, one to four candidates;
    runs_short also at six) and 1 x 700, each timed beside the wide
    encodes' 245 x 32768 (fm_timing: ms, device ms, ns a position,
    registers, CTAs an SM, waves); then phase kernels_scan: plane_scan
    (csrc/plane_scan.cu) against its plain version, exact, on the two
    quantile buckets of one 2 MiB file bucket (32 x 32 KiB each) and every
    fuzz_scan pattern (n_sym at 0, 1, L - 1, L, steps * L and past it,
    below 0 and 2^31 - 1, empty planes, zero seeds, priors none, 0, 65535
    and random u16, windows too narrow for a chunk's renorms, rows not 16
    bytes wide, B = 1, steps 2 to 40), each timed beside the shipping
    buckets (held in 3) and the frontier ones (held in 5) (ps_timing: ms,
    device ms, ns a step, the checked wrapper's ms, registers, CTAs an SM,
    waves), the four wide decode kernels' device ms a launch on the
    shipping buckets and that file bucket's, and the phase's seconds;
    then phase kernels_expand: lz_expand (csrc/lz_expand.cu) against its
    plain version, exact, on the two quantile buckets of one 2 MiB file
    bucket, the 512 KiB buckets of 10, rle_deep_chains (8 KiB blocks) at
    its hint and at 0 and 1, 2 x 1 MiB blocks (the masks in device
    memory) and every fuzz_expand pattern at its depth's hint, none, 0
    and 1 (the four fault classes of JAX's packed words among them); each
    input timed once beside the shipping and frontier buckets at their
    hint and at 0 and 1 and the v1 bench bucket (ex_timing: ms, device ms
    of both kernels, ns a position, the host's us a call, registers, CTAs
    an SM, waves, the scratch bytes), and the phase's seconds; then
    phase kernels_assemble: the main path's _assemble_rows ([B, TP]
    pairs, csrc/assemble.cu) and assemble_ops against their plain
    versions, exact, on the shipping, file (a 2 MiB bucket's two) and
    frontier (big) buckets and every fuzz_assemble pattern (spills past
    2^15 and 2^16, reps before any dict, in runs and alone, literals
    alone, tok 3, n_cmds outside 0..Tc, lex and raw-bit ranks past their
    rows, column slices, Tc 1 to 40000, B = 1) at wide_delta false and
    true; _lz_expand_rows on the buckets' pairs against
    lz_expand_parallel_ref (ship and file at their hint and at 0 and 1)
    and on fuzz_expand's four fault classes given as rows; the buckets
    and five fuzz inputs timed (asm_timing: ms, device ms, ns a slot,
    registers, shared bytes, CTAs an SM, waves), lz_expand's device ms
    on the pairs against the same commands as [T, B] (rows_vs_cols),
    and the main path's kernels on the shipping and file buckets under
    torch.profiler: stage_windows_kernel, assemble_kernel and
    lz_expand_kernel once a bucket, no lz_expand_transpose_kernel; then
    phase kernels_pack: stage_windows (csrc/stage_windows.cu) against its
    plain version, exact, on the shipping, file (a 2 MiB bucket's two) and
    frontier buckets and every fuzz_windows pattern (offsets below 0,
    past H, decreasing and wrapping past 2^31, ends below the last
    offset, pair counts past the window, B = NC = H = 1, widths and bases
    off 16 bytes, chunk counts that leave warps idle, H past 2^15), the
    buckets timed (sw_timing: ms, device ms, bound, threads, CTAs,
    registers, CTAs an SM, waves); bits_forward (csrc/bits_forward.cu)
    against its plain version, exact, on the v1 bench's fields (1024 x
    8192), one 2 MiB file bucket's (256 x 8192) and every fuzz_bits
    pattern (nb outside 0..24, fields crossing words and runs, zero
    blocks, caps 1, 3, 37, around the section and the wrapper's largest,
    B = 1, 7, 9, 255, 501, 1023, tiles of each blocks-a-CTA), the two
    field sets timed (bits_timing: ms, device ms, bound, blocks a CTA,
    shared bytes, registers, CTAs an SM, waves); the v1 encode's kernels
    under torch.profiler: one bits_forward_kernel;
20. e2e_enc_v1_opt: encode_container(parser="optimal", engine="device")
    of the 8 MiB at 8 KiB blocks, checked as 17; MB/s, the ratio and 17's
    greedy ratio;
21. e2e_enc_wide_opt: encode_container(profile="wide", parser="optimal",
    engine="device") of the 8 MB at 32 KiB blocks, checked as 14;
22. stream_enc_v1_opt: encode_container_stream of the 8 MiB at its
    default parser ("optimal"), 2 MiB buckets; its bytes must equal 20's
    container, and a block above one frame must raise and leave no file;
23. kernels_plane_decode: the unfused plane decode (stage_plane,
    plane_scan) on the five wire planes of 4's buckets, with the
    container's priors, against its plain version, exact, with CUDA-event
    times and the ten planes' device ms (torch.profiler); its symbols must
    equal plane_scan_fused's over each block's symbol count; a synthetic
    4-row, 16-symbol spec, a 2-read dst spec and a 128-lane spec (the
    kernel's general path) round-trip through plane_encode, plane_streams,
    stage_plane and plane_scan, and hold the kernel to its plain version
    also under hostile context rows; the launch shapes (path, registers,
    shared bytes, CTAs an SM, tables);
24. kernels_research: huff_scan on the 8 MB at 32 KiB blocks, on a
    container with a truncated payload, on the NLZC container's prior (4 x
    32768), on 8 MB of random bytes at 32 KiB blocks, on 2 MiB at 128 KiB
    blocks and on every fuzz_huff pattern (16 x 4096), ppm_decode on 4 MiB
    of NLZC at 16 KiB blocks (bench.py:371-394), on random words at 256 x
    512 and at 128 x 1024 (ppm_inputs), on every fuzz_ppm pattern, on its
    streams cut short (the window clamp) and on the container cut by 3001
    bytes, each against its plain version, exact; huff_scan timed at each
    of those shapes but the truncated one (huff_timing: ms, device ms, ns
    a symbol, registers, CTAs an SM, waves), ppm_decode at each but the
    cut and truncated ones (ppm_timing: ms, device ms, ns a read, rows and
    groups built beside the bound's, registers, CTAs an SM, waves), and
    the phase's seconds (ppm_decode's apart);
25. e2e_nlzc: ppm_tpu.decompress of that container must return the input
    and launch exactly huff_scan (its prior) and ppm_decode once; MB/s
    end to end and with the streams staged, the ratio, the host encode;
26. e2e_huff0: huff0.decode of the 8 MB container must return the input
    with one huff_scan launch; MB/s and the ratio;
27. cli: the command line (nlzm_tpu_torch.cli.main, in this process) on
    the 8 MB: h; c at the wide shipping config (-profile:wide
    -blocks:32768 -dict:32768, the native encode), then d and t on the
    card (the four wide kernels); c -blocks:8192 -engine:device with the
    optimal and the greedy parse (the v1 encode's kernels, the optimal
    parse's three), each then d (fsm_decode, lz_expand); c -profile:wide
    -blocks -parser:greedy on the default engine and the same with
    -engine:device and -v, which must print the measured device peak
    (both the device parse and one plane_encode launch), each then d; the single-stream c and d (no launch); d -engine:native
    of a 1 MiB wide shipping container (no launch); and one subprocess
    `python3 -m nlzm_tpu_torch.cli t` of the shipping container, which
    must exit 0. Every output file must equal the input byte for byte and
    every printed CRC zlib.crc32's; each call's launch counts go into the
    kernels line as a path cli_*;
28. mesh: block sharding (parallel/mesh.py) with every shard on cuda:0:
    the shipping wide container (3's) through decode_wide_sharded over
    1, 2 and 4 shards (245 blocks padded to 245, 246, 248), the v1 bench
    container (8's) through decode_container_sharded over 2 and 4, the
    8 MiB v1 device encode (greedy, 8 KiB blocks) over 3 shards (1024
    blocks padded to 1026; payloads, reads and cmds equal to the
    unsharded encode's, which the device encode's container holds and
    which decodes back over 3 shards) and its optimal parse on the first
    1 MiB, the NLZC container (25's) through decompress(mesh=) over 3, a
    2k + 1-block shipping container over k = 4; every output equal to
    the input (or the unsharded encode's), every call's launches exact;
    host-clock best of 3 of each decode (one card, and one process stages
    its shards in turn: no scaling); a bit flip in the shipping container
    must raise IntegrityError; the current CUDA device unchanged by the
    phase's launches; then parallel/mp_dryrun.py, three runs side by
    side, each printing its ok line: JAX's dry-run corpus as two
    processes on gloo sharing the card and as one on nccl, and the 8 MB
    corpus at the shipping config (32 KiB blocks, a 32 KiB dictionary,
    245 blocks padded to 246) as two processes on gloo. Each call's
    launch counts go into the kernels line as a path mesh_*.

Launch counts are set to 0 just before each main-path run (4, 5, 8, 9,
10, both calls of each file in 12, 14, 15, 17, 18, 20, 21, 22, the wire
plane decodes and the round trips of 23, 25, 26 and each call of 27 and
28) and read just after;
a path that did not launch each of its kernels fails, 20-22 must launch
exactly the kernels of one optimal-parse encode (V1_OPT_LAUNCHES,
WIDE_OPT_LAUNCHES; 22 once per bucket), 25 NLZC_LAUNCHES. The kernels
line reports the counts of 4, 8, the to-file calls of 12, 14, 15, 17, 18,
20-22, 23, 25, 26, 27 and 28. Each phase prints one JSON line, and a "done" line
the whole run's seconds. The last three lines are the kernels summary,
the card line of nvidia-smi, and {"ok": true, "device": ...}. Imports
nothing of JAX, of nlzm_tpu or of bench.py: the port, and its own copy of
bench.py's corpus generator.
"""

import json
import re
import subprocess
import sys
import tempfile
import time
import zlib
from contextlib import contextmanager
from pathlib import Path

SHIP = dict(block_size=32768, dict_size=32768, depth_cap=8)  # bench.py primary config
FRONTIER = dict(block_size=131072, dict_size=131072, depth_cap=12)
V1_BENCH = dict(block_size=32768, parser="optimal")  # bench.py:346 v1 section
V1_CLI = dict(block_size=131072, parser="optimal")  # the CLI's -blocks default
V1_BIG = dict(block_size=524288, parser="greedy")  # lz_expand's global-memory literal mask
SHIP_BYTES = 8_000_000
FRONTIER_BYTES = 4_000_000
V1_CLI_BYTES = 8_000_000
V1_BIG_BYTES = 2_000_000
STREAM_BUCKET = 2 << 20
REPS = 5  # end-to-end timings: best of REPS
KERNEL_REPS = 20  # kernel timings: mean of KERNEL_REPS back-to-back launches
FSM_REPS = 5  # fsm_decode: mean of FSM_REPS launches (each runs ~10^4 steps)
HOSTILE_SEEDS = (0, 1)  # hostile_streams of the v1 bench bucket
HOSTILE_STEPS = 1024  # steps of their plain decode
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM peak of int32 operations, the type of every kernel here: 132 SMs
# x 64 INT32 lanes x 2 operations (IADD3, LOP3 and IMAD fuse two) x 1.98
# GHz boost; half the data sheet's 67 TFLOP/s of fp32 (128 lanes an SM)
INT32_OPS_PER_S = 132 * 64 * 2 * 1.98e9
WIDE_KERNELS = ("stage_windows", "plane_scan", "assemble", "lz_expand")
V1_KERNELS = ("fsm_decode", "lz_expand")
ENC_KERNELS = ("find_matches", "greedy_cover", "repify", "plane_encode")
ENC_GREEDY = dict(block_size=32768, profile="wide", parser="greedy")  # bench.py:299-340 blocks
ENC_HIST_BITS = 15  # hist_bits_for_block(32768): reach 32767
V1_ENC = dict(block_size=8192, parser="greedy")  # one NLZM frame per block
V1_ENC_BYTES = 8 << 20  # 1024 blocks; the 8 MB of the other phases is its prefix
V1_ENC_HIST_BITS = 13  # hist_bits_for_block(8192): reach 8191
V1_ENC_SMALL_CAP = 101  # rANS and bit sections past it: the dropped writes
V1ENC_KERNELS = ENC_KERNELS[:3] + ("emit_model", "rans_backward", "bits_forward")
OPT_KERNELS = ("dp_parse", "dp_cover", "measure_costs")
V1_OPT = dict(block_size=8192, parser="optimal")  # the v1 device encode, optimal parse
WIDE_OPT = dict(block_size=32768, profile="wide", parser="optimal")
WIDE_OPT_REPS = 3  # host-bound (plane batching), ~2 s a call
BIG_COVER = dict(block_size=131072, bytes=1 << 20)  # dp_cover's global-scratch walk
DP_RUNS_MAX_LENS = (2, 16, 17, 64, 264)  # fuzz_dp_runs: both sides of the short reach
COVER_W = 32  # csrc/greedy_cover.cu: positions a segment, one mask word
# csrc/repify.cu's S (segments a block), R (runs before the fallback) and
# guess (run 0's entry table but in segment 0); check_rep holds them to the
# kernel's nlzm_repify_scheme
REP_S, REP_R = 64, 3
REP_GUESS = (0, -1, -2, -3)
DP_SHORT = 16  # dp_steps' model of csrc/dp_parse.cu's SHORT: the longest reach priced from slots
RANS_R = 96  # csrc/rans_backward.cu's R: rows a tile (rans_model)
RANS_NO_PAIR = 0x10000  # a span's code when it emits no pair
# csrc/huff_scan.cu's scheme (huff_model): 14 entries a span (codeword
# starts 0..13 bits past it), threads // 14 chunks of spans in the
# composition, and bits a page at 512 and 1024 threads a CTA: the words
# that fit its dynamic shared bytes (108 and 216 KiB) after the decode table
# (2^14 u16), HUFF_SPAN_BYTES a span (a span a thread) and 16, at 8 bytes a
# word (row, marks), less 2
HUFF_LIMIT = 14  # huff0.CODE_LEN_LIMIT
HUFF_NE = 14
HUFF_KW_MIN = 9  # words a span at least, under the kernel's rule
HUFF_SPAN_BYTES = 20
HUFF_PAGE = {nt: 32 * ((smem - (2 << 14) - HUFF_SPAN_BYTES * nt - 16) // 8 - 2)
             for nt, smem in ((512, 108 << 10), (1024, 216 << 10))}
# launches of one optimal-parse encode (nlzm_tpu/ops/encode_ops.py:708
# _calibrated_parse, then the profile's encode); a file encode runs it per bucket
V1_OPT_LAUNCHES = dict(find_matches=1, dp_parse=3, dp_cover=3, repify=3, emit_model=3,
                       measure_costs=2, rans_backward=1, bits_forward=1)
WIDE_OPT_LAUNCHES = dict(find_matches=1, dp_parse=3, dp_cover=3, repify=3, emit_model=2,
                         measure_costs=2, plane_encode=1)
V1OPT_KERNELS = tuple(V1_OPT_LAUNCHES)
WIDEOPT_KERNELS = tuple(WIDE_OPT_LAUNCHES)
NLZC = dict(bytes=4 << 20, block_size=16384)  # bench.py:371-394, NLZM_BENCH_NLZC=1
HUFF0 = dict(bytes=SHIP_BYTES, block_size=32768)  # the huff0 container default
HUFF0_TRUNC = dict(bytes=256 << 10, block_size=4096)  # a short chain for the plain scan
HUFF_BIG = dict(bytes=2 << 20, block_size=131072)  # huff_scan across pages
NLZC_LAUNCHES = dict(huff_scan=1, ppm_decode=1)  # the prior, then the blocks
# phase mesh (parallel/mesh.py): shards on [cuda:0] * k of one card
MESH_WIDE_KS = (1, 2, 4)  # the shipping wide container, 245 blocks padded to 245, 246, 248
MESH_V1_KS = (2, 4)  # the v1 bench container
MESH_ENC_K = 3  # the 8 MiB v1 device encode at 8 KiB blocks: 1024 blocks padded to 1026
MESH_OPT_BYTES = 1 << 20  # its optimal parse on the first 1 MiB: 128 blocks padded to 129
MESH_NLZC_K = 3  # NLZC's 256 blocks padded to 258
MESH_RAGGED_K = 4  # a 2k + 1-block shipping container
MESH_REPS = 3  # host-clock best of
MP_TIMEOUT = 300  # seconds for a multi-process run, its children killed past it
# csrc/ppm_decode.cu's scheme (ppm_model): slots a chunk (the most rows it
# can read, 2 tables x 32 lanes x 16 steps), the slots in shared memory,
# and the stream words that fit it (the rest read device memory)
PPM_SLOTS = 1024
PPM_CACHE = 576
PPM_SW_MAX = 6368
PPM_HALVINGS = 10  # halvings that take any carry (at most 1023) to 0
PPM_RANDOM = ((256, 512), (128, 1024))  # random words: the bench's shape, DEFAULT_BLOCK's
PPM_W_32K = 8448  # words of a 32 KiB block's stream at ratio ~1.03 (past PPM_SW_MAX)
RESEARCH_KERNELS = tuple(NLZC_LAUNCHES)
# csrc/find_matches.cu's scheme (fm_model): items a lane at most (threads a
# CTA: fm_threads), and under FM_FEW_BLOCKS blocks, zero bytes held past N,
# and the largest block whose positions sit in shared memory (past it,
# device memory)
FM_ITEMS = 16
FM_FEW_ITEMS = 4
FM_FEW_BLOCKS = 264
FM_PAD = 272
FM_SHORT = 16  # bytes a lane compares alone; past them the warp searches together
FM_SMEM_MAX_N = 32768
MAX_MATCH = 264  # a match's longest length (encode_ops.MAX_MLEN)
# synthetic plane specs (PlaneSpec fields) swapped in for dst: the 4-row
# spec of tests/test_wide.py, a 2-read one, read 1 keyed by row0 * 8 + y,
# and one wider than 64 lanes (csrc/plane_decode.cu's general path)
SYNTH_PLANES = {"four_row": ("dst", 8, 1, (16,), (4,)), "two_read": ("dst", 24, 2, (8, 16), (4, 32)),
                "wide_lanes": ("dst", 128, 1, (64,), (1,))}
SYNTH_BLOCKS = 245
PE_BIG_BLOCK = 131072  # parallel/blocks.py WIDE_MAX_BLOCK: plane_encode's large path
# the synthetic two_read plane on plane_encode's large path: blocks, most
# symbols a block (~1700 steps, ~215 chunks: fences in two windows)
PE_LARGE_BLOCKS = 12
PE_LARGE_COUNT = 40800
# csrc/plane_scan.cu's scheme (scan_model): slot order (lanes, alphabet,
# wire plane), its ring of window rows (slots; a chunk's row copied up to
# PS_MAX_CLEN lanes' worth of pairs), the 8-bit register counts of tok
# and len
PS_SLOTS = ((64, 4, 0), (32, 8, 2), (32, 64, 4), (64, 256, 1), (16, 256, 3))
PS_RING = 4
PS_MAX_CLEN = 8  # format/wide.py CHUNK_STEPS
PS_WIRE_LANES = (64, 64, 32, 16, 32)  # tok, lit, len, lex, dst
PS_WIRE_ALPH = (4, 256, 8, 256, 64)
PS_WH_SHIP = (72, 352, 64, 48, 88)  # window ints a chunk, the shipping bucket 0
PS_CDF = 1 << 14  # the wide profile's CDF scale
# csrc/assemble.cu's scheme (assemble_model): threads a CTA (ASM_NT_SMALL up
# to ASM_SMALL slots), the most command slots a chunk holds (slots a
# thread: the least power of two whose chunk holds the tok width, up to
# ASM_CHMAX / threads), and the shared bytes up to which the raw-bit row is
# staged
ASM_NT = 896
ASM_NT_SMALL = 512
ASM_SMALL = 1024
ASM_CHMAX = 16384
ASM_SMEM_MAX = 224 * 1024
# csrc/stage_windows.cu (windows_model): chunks a CTA at most, a warp each.
# csrc/bits_forward.cu (bits_model): threads a CTA, steps a run, the shared
# bytes G sections may take; BITS_CAP_MAX is the largest cap its wrapper
# takes (encode_ops._BITS_SMEM_MAX)
SW_MAX_WARPS = 8
BITS_NT = 512
BITS_R = 8
BITS_SMEM_MAX = 224 * 1024
BITS_CAP_MAX = 204796


def build_corpus(n: int) -> bytes:
    """Deterministic enwik-like mix: a copy of bench.py:47 build_corpus
    (tests/test_torch_host.py holds the two equal)."""
    import random

    rng = random.Random(0xBEEF)
    import itertools

    words = [
        "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randrange(2, 10)))
        for _ in range(4000)
    ]
    cum = list(itertools.accumulate(1.0 / (i + 1) for i in range(len(words))))
    pick = lambda: rng.choices(words, cum_weights=cum)[0]
    base = bytearray()
    while len(base) < 1 << 20:
        kind = rng.random()
        if kind < 0.55:  # prose
            sent = " ".join(pick() for _ in range(rng.randrange(6, 18)))
            base += (sent.capitalize() + ". ").encode()
        elif kind < 0.75:  # markup
            w = pick()
            base += f"<{w} id=\"{rng.randrange(10**6)}\">{pick()}</{w}>\n".encode()
        elif kind < 0.95:  # records
            base += (
                f"{rng.randrange(10**8):08d},{pick()},"
                f"{rng.randrange(10**6):06d},OK;\n"
            ).encode()
        else:  # noise
            base += bytes(rng.randrange(256) for _ in range(rng.randrange(40, 200)))
    base = bytes(base)
    out = bytearray()
    while len(out) < n:
        chunk = bytearray(base)
        for _ in range(len(chunk) // 256):
            chunk[rng.randrange(len(chunk))] = rng.randrange(32, 127)
        out += chunk
    return bytes(out[:n])


def fuzz_commands(seed: int, T: int = 77, B: int = 64):
    """[T, B] int32 (op_len, op_val, op_rep) drawn from a seed, beyond what
    a parse gives: dead rows between live ones and below -1, literals
    outside 0..255, lengths to 1000 (length extensions past 255),
    distances 0 to 2^30 and negative, rep slots -1..7. For the kernels'
    clamps; tests/test_torch_v1_encode.py holds the plain versions to JAX
    on them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kind = rng.choice(5, size=(T, B), p=[0.15, 0.35, 0.25, 0.15, 0.10])
    op_len = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [rng.integers(-5, 0, (T, B)), 0, rng.integers(2, 11, (T, B)),
                        rng.integers(11, 300, (T, B))], rng.integers(300, 1001, (T, B)))
    dist = np.exp2(rng.uniform(0, 30, (T, B))).astype(np.int64)
    op_val = np.where(kind == 1, rng.integers(-20, 300, (T, B)),
                      np.where(rng.random((T, B)) < 0.05, rng.integers(-9, 1, (T, B)), dist))
    op_rep = np.where(rng.random((T, B)) < 0.6, -1, rng.integers(0, 8, (T, B)))
    return tuple(a.astype(np.int32) for a in (op_len, op_val, op_rep))


def hostile_streams(arr, seed: int):
    """A valid [B, S] uint8 v1 stream matrix (pack_streams) made hostile
    from a seed, row b by kind b % 5: random bytes; the stream cut short
    (zeros from a point inside its first frame); the first frame's
    nb_bytes sending rans_base below 0, past the row, and to within 40
    bytes of the i32 limit, where the cursors wrap. For fsm_decode's clamps
    and frozen terminator pairs; tests/test_torch_decode_v2.py holds the
    plain version to JAX on them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = arr.copy()
    B, S = out.shape
    for b in range(B):
        kind = b % 5
        if kind == 0:
            out[b] = rng.integers(0, 256, S)
        elif kind == 1:
            out[b, int(rng.integers(12, max(13, min(S, 4096)))):] = 0
        else:
            nb = (-int(rng.integers(1, 5000)), S + int(rng.integers(0, 10000)),
                  2**31 - 1 - int(rng.integers(0, 40)))[kind - 2]
            out[b, 4:8] = np.frombuffer((nb & 0xFFFFFFFF).to_bytes(4, "big"), np.uint8)
    return out


def fuzz_opt(seed: int, B: int = 48, N: int = 700, C: int = 3):
    """Inputs of the optimal-parse kernels drawn from a seed, beyond what a
    parse gives: data [B, N] uint8 and n_valid [B] (0, N and between);
    delta / mlen [B, N, C] int32 (distances -5..2^30, lengths -3..300);
    cost rows [B, 6] int32 within 300 of the i32 limits or small, so that
    the DP's sums wrap; choice_len [B, N] -3..N + 300 (jumps past n_valid
    and N) and choice_cand -2..C + 1; spans [T, B, 6] with freq 0, above
    2^14 and up to 65535 beside commands from fuzz_commands. For the
    kernels' wraps and clamps; tests/test_torch_optimal_parse.py holds the
    plain versions to JAX on them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    i32 = lambda a: np.asarray(a, np.int32)
    data = rng.integers(0, 256, (B, N)).astype(np.uint8)
    n_valid = i32(np.where(rng.random(B) < 0.2, rng.choice([0, N], B), rng.integers(1, N, B)))
    delta = i32(np.where(rng.random((B, N, C)) < 0.3, rng.integers(-5, 2, (B, N, C)),
                         np.exp2(rng.uniform(0, 30, (B, N, C)))))
    mlen = i32(rng.integers(-3, 301, (B, N, C)))
    edge = rng.integers(0, 300, (B, 6))
    costs = i32(np.select([rng.random((B, 6)) < 0.3, rng.random((B, 6)) < 0.5],
                          [2**31 - 1 - edge, -(2**31) + edge], rng.integers(-50, 400, (B, 6))))
    choice_len = i32(np.where(rng.random((B, N)) < 0.1, rng.integers(-3, N + 301, (B, N)),
                              rng.integers(-3, 40, (B, N))))
    choice_cand = i32(rng.integers(-2, C + 2, (B, N)))
    op_len, op_val, op_rep = fuzz_commands(seed, T=N, B=B)
    shape = (N, B, 6)
    freq = np.select([rng.random(shape) < 0.2, rng.random(shape) < 0.3],
                     [0, rng.integers(1 << 14, 1 << 16, shape)], rng.integers(1, 1 << 14, shape))
    spans = (freq << 16) | rng.integers(0, 1 << 16, shape)
    spans = np.where(rng.random(shape) < 0.2, 0, spans).astype(np.uint32).view(np.int32)
    return dict(data=data, n_valid=n_valid, delta=delta, mlen=mlen, costs=costs,
                choice_len=choice_len, choice_cand=choice_cand,
                commands=(spans, op_len, op_val, op_rep))


def fuzz_dp_runs(seed: int, B: int = 12, N: int = 2048, C: int = 3):
    """dp_parse inputs drawn from a seed, cut into the runs its kernel takes
    apart: literal-only runs of 1..5000 positions (no distance, or mlen
    below mmin(d)) between edged segments of 1..600 positions whose reach is
    at most 16 or up to 300. Block 0 has no valid edge, block 1 reaches
    above 16 at every position, blocks 2-4 reach 2..16 at every position
    and block 5 is one literal run; n_valid is 0, N, a run's first or last
    position, or between (N on blocks 2-5). Cost rows [B, 6]: c_lit within
    300 of the i32 limits (a run's sum wraps several times), large enough
    that a run's sum passes DP_BIG, or small; the other columns as
    fuzz_opt's. Blocks 2-5 hold the kernel's tame rows (every entry
    0..2^20, N * c_lit <= 2^27) at their limits: block 2 has c_lit = 2^27
    // N and 2^20 elsewhere, so its chain is all literals and an edge's sum
    sits near the largest a tame row reaches; blocks 3 (c_lit one more) and
    4 (one other column at 2^20 + 1) are just past a limit, and block 5's
    literal sums pass DP_BIG (c_lit = 2^28 // N + 1). Returns delta, mlen
    [B, N, C], n_valid [B], costs [B, 6], int32; hold dp_parse at each
    max_len of DP_RUNS_MAX_LENS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mmin = lambda d: 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF)

    def dists(shape):  # every mmin class alike
        cls = rng.integers(0, 4, shape)
        return rng.integers(np.array([1, 1 << 8, 1 << 12, 1 << 20])[cls],
                            np.array([1 << 8, 1 << 12, 1 << 20, 1 << 30])[cls])

    delta = np.zeros((B, N, C), np.int64)
    mlen = np.zeros((B, N, C), np.int64)
    n_valid = np.zeros(B, np.int64)
    for b in range(B):
        bounds, p, edged = [0], 0, bool(rng.integers(2))
        while p < N:
            if b in (0, 5) or (b > 4 and not edged):
                k = min(int(np.exp(rng.uniform(0, np.log(5001)))), N - p)  # log-uniform
                d = np.where(rng.random((k, C)) < 0.3, rng.integers(-5, 1, (k, C)), dists((k, C)))
                m = rng.integers(-3, mmin(d))  # below mmin: no valid length
            else:
                k = min(int(rng.integers(1, 601)), N - p)
                top = 300 if b == 1 or (b > 4 and rng.random() < 0.3) else 16
                d = np.where(rng.random((k, C)) < 0.15, rng.integers(-5, 1, (k, C)), dists((k, C)))
                m = np.where(rng.random((k, C)) < 0.7, rng.integers(mmin(d), top + 1),
                             rng.integers(-3, top + 1, (k, C)))
                if b in (1, 2, 3, 4):  # an edge everywhere: above 16 on block 1, else to 16
                    d[:, 0] = dists(k)
                    m[:, 0] = rng.integers(17 if b == 1 else mmin(d[:, 0]), top + 1)
            delta[b, p:p + k], mlen[b, p:p + k] = d, m
            p += k
            bounds.append(p)
            edged = not edged
        at = bounds[int(rng.integers(len(bounds)))]
        n_valid[b] = rng.choice([0, N, at, max(at - 1, 0), int(rng.integers(1, N))])
    edge = rng.integers(0, 300, (B, 6))
    costs = np.select([rng.random((B, 6)) < 0.3, rng.random((B, 6)) < 0.5],
                      [2**31 - 1 - edge, -(2**31) + edge], rng.integers(-50, 400, (B, 6)))
    costs[:, 0] = np.select(
        [rng.random(B) < 0.3, rng.random(B) < 0.4, rng.random(B) < 0.5],
        [2**31 - 1 - edge[:, 0], -(2**31) + edge[:, 0], rng.integers(1 << 16, 1 << 22, B)],
        rng.integers(-50, 400, B))
    costs[2:6] = 1 << 20  # the tame limits and just past them
    costs[2:6, 0] = [(1 << 27) // N, (1 << 27) // N + 1, (1 << 27) // N, (1 << 28) // N + 1]
    costs[4, rng.integers(1, 6)] += 1
    n_valid[2:6] = N
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(delta=i32(delta), mlen=i32(mlen), n_valid=i32(n_valid), costs=i32(costs))


def fuzz_cover(seed: int, B: int = 16, N: int = 4096, C: int = 3) -> dict:
    """Inputs of the cover walk (greedy_cover, dp_cover) drawn from a seed,
    for the worst cases of csrc/greedy_cover.cu's segmented walk, one dict
    a pattern of steps:
    - "never_meet": 3 at position 0 and 2 after it, so the walk from 0
      never meets the walks from the even positions;
    - "long_match": a 264-long match at every position of a run of zeros:
      every segment is crossed by one step;
    - "far_jumps": mostly steps of 33..N + 300, over whole segments and
      past N;
    - "literals": a step of 1 everywhere, a start at every position;
    - "mixed": literals and matches of every length, 1% of them up to N +
      300;
    - "few_steps": literals and matches of 2..16 with num_steps 37, below
      the command count.
    A literal is a hostile one at random: greedy delta <= 0 (any mlen) or
    mlen below mmin(delta); dp choice_len -3..1 (1 is a match of length 1).
    Each dict: data [B, N] uint8, n_valid [B] (0, 1, mid-segment, N - 1,
    N, then 1..N), greedy delta / mlen [B, N], dp delta3 [B, N, C] (-5..
    2^30) with choice_len / choice_cand [B, N] (candidates -2..C + 1),
    int32, and num_steps (N, or 37)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (B, N)
    i32 = lambda a: np.asarray(a, np.int32)
    mmin = lambda d: 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF)
    lo = np.array([1, 1 << 8, 1 << 12, 1 << 20])  # a distance of each mmin class 2..5
    hi = np.array([1 << 8, 1 << 12, 1 << 20, 1 << 30])
    fixed = [0, 1, 32 * int(rng.integers(1, N // 32)) + 17, N - 1, N]
    n_valid = np.where(rng.random(B) < 0.3, N, rng.integers(1, N + 1, B))
    n_valid[:min(B, 5)] = fixed[:B]

    u = rng.random(shape)
    short = np.where(u < 0.5, 1, rng.integers(2, 17, shape))

    steps = {
        "never_meet": np.full(shape, 2),
        "long_match": np.full(shape, 264),
        "far_jumps": np.where(rng.random(shape) < 0.8, rng.integers(33, N + 301, shape),
                              rng.integers(1, 33, shape)),
        "literals": np.ones(shape, np.int64),
        "mixed": np.select([u < 0.8, u < 0.99], [short, rng.integers(17, 265, shape)],
                           rng.integers(2, N + 301, shape)),
        "few_steps": short,
    }
    steps["never_meet"][:, 0] = 3
    out = {}
    for name, st in steps.items():
        lit = st == 1
        cls = np.minimum(rng.integers(0, 4, shape), np.clip(st - 2, 0, 3))  # mmin(d) <= st
        d = rng.integers(lo[cls], hi[cls])
        hostile = rng.random(shape) < 0.5
        d_lit = np.where(hostile, rng.integers(-5, 1, shape), d)
        m_lit = np.where(hostile, rng.integers(-3, N + 301, shape),
                         rng.integers(-3, mmin(d)))
        zeros = name == "long_match"
        data = np.zeros(shape, np.uint8) if zeros else rng.integers(0, 256, shape, np.uint8)
        delta = np.where(lit, d_lit, 1 if zeros else d)
        delta3 = np.where(rng.random((B, N, C)) < 0.3, rng.integers(-5, 2, (B, N, C)),
                          rng.integers(1, 1 << 30, (B, N, C)))
        out[name] = dict(data=data, n_valid=i32(n_valid), delta=i32(delta),
                         mlen=i32(np.where(lit, m_lit, st)), delta3=i32(delta3),
                         choice_len=i32(np.where(lit, rng.integers(-3, 2, shape), st)),
                         choice_cand=i32(rng.integers(-2, C + 2, shape)),
                         num_steps=37 if name == "few_steps" else N)
    return out


def cover_model(data, delta, length, n_valid, num_steps: int, cand=None, W: int = COVER_W):
    """A numpy model of csrc/greedy_cover.cu's segmented walk, W positions
    a segment. Greedy when cand is None (delta, length: [B, N] delta and
    mlen), else dp (delta [B, N, C], length: choice_len, cand:
    choice_cand). 1. next[p] = min(p + step, N) by the kernel's rules; 2.
    J[p], the first position of the walk from p at or past its segment's
    end, by one backward pass a segment (J[p] = next[p] if that is past the
    segment, else J[next[p]]); 3. the crossing walk q <- J[q] from 0 while
    q < n_valid, each q its segment's entry; 4. each entered segment walked
    by next from its entry to its end or n_valid, marking starts, the walk
    that crosses n_valid giving the end; 5. the starts in order, those at
    num_steps or later dropped, then the dead rows (-1, the byte at the
    end clamped to N - 1). Returns (op_len, op_val) [num_steps, B] int32."""
    import numpy as np

    data = np.asarray(data)
    B, N = data.shape
    d, ln = np.asarray(delta, np.int64), np.asarray(length, np.int64)
    byte = data.astype(np.int64)
    if cand is None:
        use = (d > 0) & (ln >= 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF))
        step = np.where(use, ln, 1)
    else:
        c = np.asarray(cand, np.int64)
        C = d.shape[2]
        d = np.take_along_axis(d, np.clip(c, 0, C - 1)[..., None], 2)[..., 0]
        d = np.where((c >= 0) & (c < C), d, 0)
        use = ln > 0
        step = np.maximum(ln, 1)
    cmd_len, cmd_val = np.where(use, ln, 0), np.where(use, d, byte)
    pos = np.arange(N)
    nxt = np.minimum(pos + step, N)  # 1
    seg_end = np.minimum((pos // W + 1) * W, N)
    jump = np.full((B, N + 1), N, np.int64)
    for i in range(W - 1, -1, -1):  # 2: every segment's offset i at once
        p = pos[i::W]
        nx = nxt[:, p]
        jump[:, p] = np.where(nx >= seg_end[p], nx, np.take_along_axis(jump, nx, 1))
    op_len = np.full((num_steps, B), -1, np.int32)
    op_val = np.zeros((num_steps, B), np.int32)
    for b in range(B):
        nv = min(max(int(n_valid[b]), 0), N)
        entries, q = [], 0
        while q < nv:  # 3
            entries.append(q)
            q = int(jump[b, q])
        starts, end = [], 0
        for e in entries:  # 4
            cur, lim = e, min((e // W + 1) * W, nv)
            while cur < lim:
                starts.append(cur)
                cur = int(nxt[b, cur])
            if cur >= nv:
                end = cur
        ncmd = min(len(starts), num_steps)  # 5
        at = np.asarray(starts[:ncmd], np.int64)
        op_len[:ncmd, b] = cmd_len[b, at]
        op_val[:ncmd, b] = cmd_val[b, at]
        op_val[ncmd:, b] = byte[b, min(end, N - 1)]
    return op_len, op_val


def fuzz_rep(seed: int, B: int = 16, T: int = 4096, names=None) -> dict:
    """Inputs of repify drawn from a seed, for the worst cases of
    csrc/repify.cu's segmented replay, one (op_len, op_val) pair of [T, B]
    int32 a pattern:
    - "cycle5": every row a match over the cycle 1..5 (each block at its
      own phase): from the start table, four hits a miss, a phase that
      carries from each segment to the next; from the guess, every match
      misses, so the speculation never catches up (the fallback);
    - "rle": distance-1 matches (hits on slot 0), literals between;
    - "cycle4": every row a match over a cycle of 4 fresh distances;
    - "fresh": every row a match, every distance new;
    - "random6": matches on 20% of rows, distances among 6 values (1..4
      and two others), literals elsewhere;
    - "literals", "dead": no match, op_len 0 or -1 everywhere;
    - "hostile": dead rows (-1 and below) in the middle, literals, and
      matches of distances <= 0, INT_MIN, INT_MAX, the guess's values and
      1..6;
    - "last_match": one match a block, its last row;
    - "ragged": hostile at T - 27 rows (no multiple of 32) and B - 3
      blocks; "one_row": hostile at T = 1, B - 1 blocks.
    names: the patterns to return (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (T, B)
    t = np.arange(T)[:, None]
    b = np.arange(B)[None, :]
    length = rng.integers(2, 300, shape)
    byte = rng.integers(0, 256, shape)
    i32 = lambda a: np.asarray(a, np.int32)

    def mixed(p_match, dist):
        is_m = rng.random(shape) < p_match
        return np.where(is_m, length, 0), np.where(is_m, dist, byte)

    def hostile(T, B):
        kind = rng.choice(4, (T, B), p=[0.2, 0.2, 0.3, 0.3])
        op_len = np.select([kind == 0, kind == 1], [rng.integers(-9, 0, (T, B)), 0],
                           rng.integers(1, 300, (T, B)))
        odd = np.array([*REP_GUESS, -7, np.iinfo(np.int32).min, np.iinfo(np.int32).max])
        dist = np.where(kind == 2, rng.choice(odd, (T, B)), rng.integers(1, 7, (T, B)))
        return i32(op_len), i32(np.where(op_len == 0, rng.integers(0, 256, (T, B)), dist))

    six = np.concatenate([np.arange(1, 5), rng.integers(5, 1 << 20, 2)])
    four = rng.integers(5, 1 << 20, (4, B))
    last = np.zeros(shape, np.int64)
    last[-1] = rng.integers(2, 300, B)
    make = {
        "cycle5": lambda: (length, 1 + (t + b) % 5),
        "rle": lambda: mixed(0.6, 1),
        "cycle4": lambda: (length, np.take_along_axis(four, np.broadcast_to(t % 4, shape), 0)),
        "fresh": lambda: (length, 5 + t * B + b),
        "random6": lambda: mixed(0.2, six[rng.integers(0, 6, shape)]),
        "literals": lambda: (np.zeros(shape, np.int64), byte),
        "dead": lambda: (np.full(shape, -1), byte),
        "hostile": lambda: hostile(T, B),
        "last_match": lambda: (last, np.where(last > 0, 1 + b % 6, byte)),
        "ragged": lambda: hostile(T - 27, B - 3),
        "one_row": lambda: hostile(1, B - 1),
    }
    return {k: tuple(i32(a) for a in make[k]()) for k in (names or make)}


def rep_model(op_len, op_val, S: int = REP_S, R: int = REP_R):
    """A numpy model of csrc/repify.cu's segmented replay, S segments a
    block of ceil(T / S) rows, at most R runs. Run 0 walks each segment
    from (1, 2, 3, 4) (segment 0) or REP_GUESS and keeps its summary (k =
    min(inserts, 4), exit table); each later run composes the summaries
    before a segment into its entry, walks again (writing) a segment that
    has not written yet or whose entry changed, and stops the block when
    no summary (k and its first k slots) changed; a block still changed
    after R runs is replayed row by row from the segment after the first
    changed one, f, whose exit table is exact. Returns (op_rep [T, B]
    int32, the runs each block took: 2..R, or R + 1 for R runs and the
    fallback)."""
    import numpy as np

    L, V = np.asarray(op_len, np.int64), np.asarray(op_val, np.int64)
    T, B = L.shape
    seg = -(-T // S)
    Ls = np.full((S * seg, B), -1, np.int64)
    Vs = np.zeros((S * seg, B), np.int64)
    Ls[:T], Vs[:T] = L, V
    Ls, Vs = Ls.reshape(S, seg, B), Vs.reshape(S, seg, B)
    out = np.full((S, seg, B), -1, np.int64)
    q = np.arange(4)

    def step(tab, m, v):
        """One row on tables [..., 4]: (slot or -1, inserted, new table)."""
        eq = tab == v[..., None]
        hit = eq.any(-1)
        ins = m & ~hit
        pushed = np.concatenate([v[..., None], tab[..., :3]], -1)
        return np.where(m & hit, eq.argmax(-1), -1), ins, np.where(ins[..., None], pushed, tab)

    def walk(tab, write):
        k = np.zeros((S, B), np.int64)
        for j in range(seg):
            slot, ins, tab = step(tab, Ls[:, j] > 0, Vs[:, j])
            out[:, j] = np.where(write, slot, out[:, j])
            k += ins
        return tab, np.minimum(k, 4)

    def entries(x, k):
        e = np.empty((S, B, 4), np.int64)
        cur = np.broadcast_to(np.arange(1, 5), (B, 4))
        for s in range(S):
            e[s] = cur
            ks = k[s][:, None]  # cur <- x[0:k] ++ cur[0:4 - k]
            cur = np.where(q < ks, x[s], np.take_along_axis(cur, np.clip(q - ks, 0, 3), 1))
        return e

    entry = np.broadcast_to(np.asarray(REP_GUESS, np.int64), (S, B, 4)).copy()
    entry[0] = np.arange(1, 5)
    x, k = walk(entry, False)
    written = np.zeros((S, B), bool)
    done = np.zeros(B, bool)
    runs = np.ones(B, np.int64)
    first = np.full(B, S)
    for _ in range(1, R):
        ne = entries(x, k)
        rerun = (~written | (ne != entry).any(-1)) & ~done
        entry = np.where(rerun[..., None], ne, entry)
        x2, k2 = walk(entry.copy(), rerun)
        changed = rerun & ((k2 != k) | ((x2 != x) & (q < k2[..., None])).any(-1))
        x, k = np.where(rerun[..., None], x2, x), np.where(rerun, k2, k)
        written |= rerun
        runs[~done] += 1
        first = np.where(changed.any(0), changed.argmax(0), S)
        done |= first == S
        if done.all():
            break
    op_rep = out.reshape(S * seg, B)[:T]
    fb = np.nonzero(~done)[0]
    if len(fb):
        runs[fb] = R + 1
        start = (first[fb] + 1) * seg
        tab = x[first[fb], fb]
        for r in range(int(start.min()), T):
            act = r >= start
            slot, _, new = step(tab, act & (L[r, fb] > 0), V[r, fb])
            op_rep[r, fb] = np.where(act, slot, op_rep[r, fb])
            tab = np.where(act[:, None], new, tab)
    return op_rep.astype(np.int32), runs


def fuzz_spans(seed: int, T: int = 4096, B: int = 16, names=None) -> dict:
    """Inputs of rans_backward drawn from a seed, for the worst cases of
    csrc/rans_backward.cu, one [T, B, 6] int32 array of spans ((freq << 16)
    | start, u32 bits; 0 = no span) a pattern:
    - "dense": all six slots of every row, freq 1..2^14 - 1, start within
      the 2^14 scale: the longest chain (6T / 4 steps);
    - "f14": freq 2^14 (the threshold wraps to 0: every span renorms) on
      half the slots;
    - "f1": freq 0 or 1 (f = 1: x grows until 2^18 before each renorm),
      any start, nonzero spans only, half the slots;
    - "wide_f": freq in (2^14, 2^16) with 2^15 (threshold 0) and 65535
      among them, start 0xFFFF (the new state wraps in u32);
    - "random": random u32 spans, a third of them 0;
    - "last_row": spans only in the last row;
    - "empty_full": blocks with no span beside blocks with every slot;
    - "mod4": block b holds 4m + (b mod 4) spans at random places;
    - "every_f": dense, freq running through 1..65535 in order (every
      magic the kernel works out);
    - "ragged": random at T - 37 rows (no multiple of 128) and B - 3
      blocks; "one_row": random at T = 1, B - 1 blocks.
    names: the patterns to return (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (T, B, 6)
    u32 = lambda a: np.ascontiguousarray(np.asarray(a, np.uint64).astype(np.uint32).view(np.int32))

    def span(freq, start):
        return (np.asarray(freq, np.uint64) << np.uint64(16)) | np.asarray(start, np.uint64)

    def scaled(sh):
        freq = rng.integers(1, 1 << 14, sh)
        return span(freq, rng.integers(0, (1 << 14) - freq + 1, sh))

    def half(a, sh):
        return np.where(rng.random(sh) < 0.5, a, 0)

    def random(sh):
        v = rng.integers(0, 1 << 32, sh, dtype=np.uint64)
        return np.where(rng.random(sh) < 1 / 3, 0, v)

    def f1():
        freq = rng.integers(0, 2, shape)
        start = rng.integers(freq == 0, 1 << 16, shape)  # freq 0: a start of 1 or more
        return half(span(freq, start), shape)

    def wide_f():
        freq = rng.integers((1 << 14) + 1, 1 << 16, shape)
        pick = rng.random(shape)
        freq = np.where(pick < 0.2, 65535, np.where(pick < 0.3, 1 << 15, freq))
        return span(freq, 0xFFFF)

    def last_row():
        a = np.zeros(shape, np.uint64)
        a[-1] = half(scaled((B, 6)), (B, 6))
        a[-1, :, 0] = scaled(B)  # at least one span a block
        return a

    def empty_full():
        a = scaled(shape)
        a[:, ::2] = 0
        return a

    def mod4():
        a = np.zeros((B, T * 6), np.uint64)
        for b in range(B):
            k = min(4 * int(rng.integers(0, T * 6 // 8 + 1)) + b % 4, T * 6)
            at = rng.choice(T * 6, k, replace=False)
            a[b, at] = scaled(k)
        return a.reshape(B, T, 6).transpose(1, 0, 2)

    def every_f():
        n = T * B * 6
        freq = (np.arange(n) % 65535 + 1).reshape(B, T, 6).transpose(1, 0, 2)
        return span(freq, rng.integers(0, 1 << 16, shape))

    make = {
        "dense": lambda: scaled(shape),
        "f14": lambda: half(span(np.full(shape, 1 << 14), rng.integers(0, 1 << 16, shape)), shape),
        "f1": f1,
        "wide_f": wide_f,
        "random": lambda: random(shape),
        "last_row": last_row,
        "empty_full": empty_full,
        "mod4": mod4,
        "every_f": every_f,
        "ragged": lambda: random((T - 37, B - 3, 6)),
        "one_row": lambda: random((1, B - 1, 6)),
    }
    return {k: u32(make[k]()) for k in (names or make)}


def rans_magic(f):
    """The magic of csrc/rans_backward.cu's span records for each f (1 <= f
    < 2^16), uint64 numpy: the (high, low) words of (ceil(2^48 / f) << 16)
    mod 2^64, 0 at f = 1, as the kernel works it out: m = the double 1 / f
    (correctly rounded) times 2^48, truncated (at most 2 below), then
    raised by e = m * f - 2^48 (1 if e < 0, 2 if e < -f)."""
    import numpy as np

    f = np.asarray(f, np.uint64)
    m = ((1.0 / f.astype(np.float64)) * 2.0**48).astype(np.uint64)
    e = (m * f).astype(np.int64) - (1 << 48)
    m = m + (e < 0).astype(np.uint64) + (e < -f.astype(np.int64)).astype(np.uint64)
    m = np.where(f == 1, np.uint64(0), m)
    return m >> np.uint64(16), (m << np.uint64(16)) & np.uint64(0xFFFFFFFF)


def recip_div(x1, f):
    """floor(x1 / f) for u32 x1 and 1 <= f < 2^16 (broadcast), uint64 numpy,
    as csrc/rans_backward.cu's step gets it: the high word of x1 *
    (ceil(2^48 / f) << 16), t = hi32(x1 * low), q = hi32(x1 * high + t),
    from rans_magic's words. At f = 1 the magic is 0 and the kernel folds
    the quotient, x1, into its multiplier a = 2^14."""
    import numpy as np

    x1, f = np.asarray(x1, np.uint64), np.asarray(f, np.uint64)
    hi, lo = rans_magic(f)
    sh = np.uint64(32)
    return np.where(f == 1, x1, (x1 * hi + ((x1 * lo) >> sh)) >> sh)


def rans_model(spans, cap: int, R: int = RANS_R):
    """A numpy model of csrc/rans_backward.cu's scheme. Tiles of R rows from
    the last back; a block's nonzero spans of a tile compacted in backward
    order (row, then slot, descending), r the backward index, label r & 3
    a chain from 1 << 16; each span's quantities worked out ahead of its
    chain: f = max(freq, 1), thr = (f << 18) mod 2^32, c = 2^14 - f, a =
    2^14 at f = 1 (else 1) and its magic (rans_magic); the step over =
    x >= thr, x1 = over ? x >> 16 : x, x = q * c + x1 * a + start (mod
    2^32) with q from the magic's two multiplies (recip_div); each tile's
    pairs harvested in backward order; the seeds put in forward lane order,
    lane L = label (K - 1 - L) & 3, once K is known. Returns (stream [B,
    cap] uint8, rans_bytes [B] int32) as rans_backward."""
    import numpy as np

    sp = np.asarray(spans).view(np.uint32).astype(np.uint64)
    T, B, _ = sp.shape
    M, sh = np.uint64(0xFFFFFFFF), np.uint64(32)
    x = np.full((B, 4), 1 << 16, np.uint64)
    K = np.zeros(B, np.int64)
    pairs = [[] for _ in range(B)]  # backward order
    rows = np.arange(B)[:, None]
    for i in range(-(-T // R)):
        tile = sp[max(T - (i + 1) * R, 0) : T - i * R][::-1, :, ::-1]
        tile = tile.transpose(1, 0, 2).reshape(B, -1)
        live = tile != 0
        n = live.sum(1)
        rec = np.take_along_axis(tile, np.argsort(~live, axis=1, kind="stable"), 1)
        f = np.maximum(rec >> np.uint64(16), np.uint64(1))
        start = rec & np.uint64(0xFFFF)
        hi, lo = rans_magic(f)
        thr, c = (f << np.uint64(18)) & M, (np.uint64(0x4000) - f) & M
        a = np.where(f == 1, np.uint64(0x4000), np.uint64(1))
        code = np.full(rec.shape, RANS_NO_PAIR, np.uint64)
        j = (np.arange(4)[None, :] - K[:, None]) & 3  # each label's first span of the tile
        steps = (n[:, None] - j + 3) // 4
        for s in range(int(steps.max(initial=0))):
            act = s < steps
            k = np.minimum(j + 4 * s, rec.shape[1] - 1)
            at = lambda v: v[rows, k]
            over = x >= at(thr)
            x1 = np.where(over, x >> np.uint64(16), x)
            q = (x1 * at(hi) + ((x1 * at(lo)) >> sh)) >> sh
            code[np.broadcast_to(rows, k.shape)[act], k[act]] = np.where(
                over, x & np.uint64(0xFFFF), RANS_NO_PAIR)[act]
            x = np.where(act, (q * at(c) + x1 * at(a) + at(start)) & M, x)
        for b in range(B):
            cb = code[b, : n[b]]
            pairs[b].extend(int(v) for v in cb[cb != RANS_NO_PAIR])
        K += n
    stream = np.zeros((B, cap), np.uint8)
    for b in range(B):
        seeds = (int(x[b, (K[b] - 1 - L) & 3]).to_bytes(4, "little") for L in range(4))
        body = b"".join(seeds) + b"".join(v.to_bytes(2, "big") for v in reversed(pairs[b]))
        m = min(cap, len(body))
        stream[b, :m] = np.frombuffer(body[:m], np.uint8)
    return stream, np.asarray([16 + 2 * len(p) for p in pairs], np.int32)


def huff_staged(container: bytes):
    """huff0.stage_blocks of a container on the CPU, as numpy:
    (streams, base_l, limit_l, offs, syms, T)."""
    from nlzm_tpu_torch.research import huff0

    st = huff0.stage_blocks(container, *huff0._parse(container), "cpu")
    return tuple(a.numpy() for a in st[:5]) + (st[6],)


def huff_tables(lengths_list):
    """(base_l, limit_l, offs, syms) int32 [B, 15] x 3 and [B, 256] of
    huff0.left_tables for each block's code lengths."""
    import numpy as np

    from nlzm_tpu_torch.research import huff0

    cols = zip(*(huff0.left_tables(np.asarray(ln)) for ln in lengths_list))
    return tuple(np.stack(c).astype(np.int32) for c in cols)


def fuzz_huff(seed: int, B: int = 16, T: int = 4096, names=None) -> dict:
    """Inputs of huff_scan drawn from a seed, for the worst cases of
    csrc/huff_scan.cu, as staged (streams [B, S] uint8, base_l, limit_l,
    offs [B, 15] int32, syms [B, 256] int32, T) a pattern:
    - "corpus": build_corpus at T-byte blocks (chains merge within a span);
    - "random": random bytes under all-8 code lengths (chains that start in
      different phases never merge: 8 exits a span);
    - "uniform64", "uniform128": bytes drawn uniformly from 64 or 128
      symbols (base64 text, 7-bit data), coded by huff0.encode: lengths 6
      or 7 but for a few, so chains that start apart rarely merge within a
      span, and spans of 32 KW bits (KW odd) start in another phase of the
      7-bit codes;
    - "repeat": one symbol a block, repeated (length 1: a step a bit);
    - "limit14": Fibonacci counts, cut to 14 bits by code_lengths' halving,
      and symbols drawn with probability 2^-length (the longest codes);
    - "zeros": all-zero streams under the corpus tables (peek 0 at every
      step);
    - "noise": random rows of S = 301 bytes under the corpus tables (the
      last word is nonzero, so the periodic tail is not zero);
    - "hostile": random int32 limits, bases, offsets and symbols over
      random rows of S = 301 (wrapping index arithmetic, every clamp);
    - "truncated": the corpus container with block 1's payload cut by 37
      bytes (huff0._truncated);
    - "short_last": the corpus at B - 1 full blocks and a last one of T / 3
      bytes;
    - "ragged": the corpus at T - 37 bytes a block (no multiple of 32) and
      B - 3 blocks;
    - "t1": T = 1, B = 1, S = 1.
    names: the patterns to return (default all)."""
    import numpy as np

    from nlzm_tpu_torch.research import huff0

    rng = np.random.default_rng(seed)
    corpus = build_corpus(B * T + 4096)
    start = int(rng.integers(0, 4096))
    text = corpus[start : start + B * T]

    def from_payloads(blocks, lengths_list):
        payloads = [huff0._encode_payload(d, ln) for d, ln in zip(blocks, lengths_list)]
        streams = np.zeros((len(payloads), max(map(len, payloads)) + 8), np.uint8)
        for b, p in enumerate(payloads):
            streams[b, : len(p)] = np.frombuffer(p, np.uint8)
        return (streams, *huff_tables(lengths_list), max(map(len, blocks)))

    def random():
        return from_payloads([rng.integers(0, 256, T, np.uint8).tobytes() for _ in range(B)],
                             [np.full(256, 8)] * B)

    def uniform(k):
        return huff_staged(huff0.encode(rng.integers(0, k, B * T, np.uint8).tobytes(), T))

    def repeat():
        return huff_staged(huff0.encode(bytes(rng.integers(0, 256, B, np.uint8).repeat(T)), T))

    def limit14():
        fib = [1, 1]
        while len(fib) < 256:
            fib.append(min(fib[-1] + fib[-2], 1 << 40))
        lengths = huff0.code_lengths(np.asarray(fib, np.int64))
        lengths_list, blocks = [], []
        for _ in range(B):
            ln = rng.permutation(lengths)
            p = 2.0 ** -ln.astype(np.float64)
            blocks.append(rng.choice(256, T, p=p / p.sum()).astype(np.uint8).tobytes())
            lengths_list.append(ln)
        return from_payloads(blocks, lengths_list)

    def under_corpus(streams):
        return (streams, *huff_staged(huff0.encode(text, T))[1:])

    def hostile():
        i32 = lambda *sh: rng.integers(-(1 << 31), 1 << 31, sh, np.int64).astype(np.int32)
        return (rng.integers(0, 256, (B, 301), np.uint8), i32(B, 15), i32(B, 15), i32(B, 15),
                i32(B, 256), T)

    make = {
        "corpus": lambda: huff_staged(huff0.encode(text, T)),
        "random": random,
        "uniform64": lambda: uniform(64),
        "uniform128": lambda: uniform(128),
        "repeat": repeat,
        "limit14": limit14,
        "zeros": lambda: under_corpus(np.zeros_like(huff_staged(huff0.encode(text, T))[0])),
        "noise": lambda: under_corpus(rng.integers(0, 256, (B, 301), np.uint8)),
        "hostile": hostile,
        "truncated": lambda: huff_staged(huff0._truncated(huff0.encode(text, T), 1, 37)),
        "short_last": lambda: huff_staged(huff0.encode(text[: (B - 1) * T + T // 3], T)),
        "ragged": lambda: huff_staged(huff0.encode(text[: (B - 3) * (T - 37)], T - 37)),
        "t1": lambda: (rng.integers(0, 256, (1, 1), np.uint8),
                       *huff_staged(huff0.encode(text[:1], 1))[1:5], 1),
    }
    return {k: make[k]() for k in (names or make)}


def huff_decode_table(base_l, limit_l, offs, syms):
    """Every 14-bit peek's code length and symbol, [B, 2^14] int64 each, as
    csrc/huff_scan.cu tabulates them: L = clip(1 + #{l : peek >=
    limit_l[l]}, 1, 14), the symbol syms[clip(offs[L] + ((peek - base_l[L])
    >> (14 - L)), 0, 255)] & 255, the index arithmetic in int32 (wrapping,
    as JAX's)."""
    import numpy as np

    wrap = lambda v: ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    peek = np.arange(1 << HUFF_LIMIT, dtype=np.int64)[None, :]
    lim = np.asarray(limit_l, np.int64)[:, 1:]
    L = np.clip(1 + (peek[:, :, None] >= lim[:, None, :]).sum(2), 1, HUFF_LIMIT)
    pick = lambda t: np.take_along_axis(np.asarray(t, np.int64), L, 1)
    idx = wrap(pick(offs) + (wrap(peek - pick(base_l)) >> (HUFF_LIMIT - L)))
    sym = np.take_along_axis(np.asarray(syms, np.int64), np.clip(idx, 0, 255), 1) & 255
    return L, sym


def huff_words(streams):
    """[B, W] uint64: the rows as big-endian u32 words, zero-padded to W =
    ceil(S / 4) words (bit p of the stream is bit 31 - (p & 31) of word p >>
    5; the decode clamps the word to W - 1)."""
    import numpy as np

    B, S = streams.shape
    W = -(-S // 4)
    pad = np.zeros((B, 4 * W), np.uint64)
    pad[:, :S] = streams
    pad = pad.reshape(B, W, 4)
    return (pad[..., 0] << 24) | (pad[..., 1] << 16) | (pad[..., 2] << 8) | pad[..., 3]


def huff_peek(words, p):
    """The 14 bits at bit offsets p ([B, ...] int64) of each row's stream
    (words from huff_words): the two words at p >> 5, each clamped to W -
    1, funnel-shifted left by p & 31."""
    import numpy as np

    B, W = words.shape
    rows = np.arange(B).reshape((B,) + (1,) * (p.ndim - 1))
    i = np.minimum(p >> 5, W - 1)
    hi, lo = words[rows, i], words[rows, np.minimum(i + 1, W - 1)]
    s = (p & 31).astype(np.uint64)
    v = ((hi << s) | (lo >> (np.uint64(32) - s))) & np.uint64(0xFFFFFFFF)
    return (v >> np.uint64(18)).astype(np.int64)


def huff_maps(words, L, a, b):
    """Phase A of csrc/huff_scan.cu for spans [a, b) (int64 [n] bit
    offsets, every row the same): each span's map from its 14 entries (a
    codeword starting at a + e, e = 0..13) to (exit, count): the first
    codeword start at or past b, minus b, and the codewords before it.
    Entry 0's chain runs first and marks its starts; every other entry
    runs until it lands on a mark, where it joins entry 0's chain: its
    count is then its own steps plus the marks from there on. Returns
    (exit, count), [B, n, 14] int64 each."""
    import numpy as np

    B, n = words.shape[0], len(a)
    rows = np.arange(B)[:, None, None]
    K = int((b - a).max(initial=1))
    p = np.broadcast_to(a[None, :], (B, n)).copy()
    n0 = np.zeros((B, n), np.int64)
    marks = np.zeros((B, n, K + 1), bool)
    while True:
        act = p < b
        if not act.any():
            break
        bi, si = np.nonzero(act)
        marks[bi, si, p[bi, si] - a[si]] = True
        n0 += act
        p = np.where(act, p + np.take_along_axis(L, np.clip(huff_peek(words, p), 0, None), 1), p)
    x0 = p - b
    suffix = np.cumsum(marks[..., ::-1], axis=2)[..., ::-1]  # marks at or past q
    pe = (a[:, None] + np.arange(1, HUFF_NE))[None].repeat(B, 0)  # [B, n, 13]
    ne = np.zeros_like(pe)
    joined = np.zeros(pe.shape, bool)
    bb = b[None, :, None]
    si = np.arange(n)[None, :, None]
    while True:
        act = (pe < bb) & ~joined
        q = np.clip(pe - a[None, :, None], 0, K)
        hit = act & marks[rows, si, q]
        joined |= hit
        act &= ~hit
        if not act.any():
            break
        ne += act
        step = np.take_along_axis(L, huff_peek(words, pe).reshape(B, -1), 1).reshape(pe.shape)
        pe = np.where(act, pe + step, pe)
    q = np.clip(pe - a[None, :, None], 0, K)
    exit_ = np.concatenate([x0[..., None], np.where(joined, x0[..., None], pe - bb)], 2)
    count = np.concatenate([n0[..., None], ne + np.where(joined, suffix[rows, si, q], 0)], 2)
    return exit_, count


def huff_model(streams, base_l, limit_l, offs, syms, T: int, K=None, page=None,
               threads: int = 512, stats=None):
    """A numpy model of csrc/huff_scan.cu's scheme: [B, T] uint8 as
    huff_scan. The chain of codeword starts is a function of the bit offset
    alone, and a codeword is at most 14 bits. From word z on, every word
    the decode reads equals word W - 1 (z: one past the last earlier word
    that does not; reads past W - 1 read it), so a block's bits from E = 32
    z repeat with period 32. The bits [0, R), R = min(E, 14 T) (the first T
    starts lie below 14 T; the kernel takes each block's own R, the model
    the largest, which reads past a smaller E as the tail would), are cut
    into pages of `page` bits (default
    HUFF_PAGE[threads]) and each page into spans of K bits (default the
    kernel's rule: 32 KW, KW the least odd number of words, at least
    HUFF_KW_MIN, that gives at most `threads` spans). A page's maps
    (huff_maps: the kernel computes an entry's map where it needs it, by
    the same marks) are composed in threads // 14 chunks: each chunk walked
    from an entry, recording that walk's entry at each of its spans (the
    kernel's path words); a walk over the chunks' exits from the carried
    entry; each span's true entry read from its record, its count there,
    and their running sum from the carried count, each span's first output
    index; then each span decodes again from its entry, dropping indices
    at or past T. The kernel walks each chunk from its guess (its first
    span's e1, the carried entry for the first) and, from the first chunk
    entered off its guess on, from every entry; the model walks every chunk
    from every entry, which gives the same records, and counts in
    stats["repaired"] (a dict, if given) the pages of blocks where a guess
    failed, and in stats["pages"] all of them. A block
    still short of T at E walks residues mod 32 from its entry (the exit
    of the last span): 64 steps, then the cycle, whose length is the first
    return to the 32nd residue, repeats to T."""
    import numpy as np

    streams = np.asarray(streams)
    B, S = streams.shape
    out = np.zeros((B, T), np.uint8)
    if B == 0 or T == 0:
        return out
    words = huff_words(streams)
    W = words.shape[1]
    L, sym = huff_decode_table(base_l, limit_l, offs, syms)
    other = words[:, : W - 1] != words[:, W - 1 :]
    z = np.where(other, np.arange(1, W), 0).max(initial=0)
    R = min(32 * int(z), HUFF_LIMIT * T)
    page = page or HUFF_PAGE.get(threads, HUFF_PAGE[512])
    entry = np.zeros(B, np.int64)
    nout = np.zeros(B, np.int64)
    for pa in range(0, R, page):
        if (nout >= T).all():
            break
        bits = min(page, R - pa)
        kw = max(HUFF_KW_MIN, -(-bits // 32 // threads)) if K is None else K // 32
        kw += K is None and kw % 2 == 0
        a = pa + np.arange(0, bits, 32 * kw, dtype=np.int64)
        b = np.minimum(a + 32 * kw, pa + bits)
        n = len(a)
        ex, cnt = huff_maps(words, L, a, b)
        C = -(-n // max(threads // HUFF_NE, 1))
        rows = np.arange(B)
        path = np.zeros((B, n, HUFF_NE), np.int64)  # each chunk's walk from entry x, at span s
        c_exit = []
        for c0 in range(0, n, C):
            e = np.broadcast_to(np.arange(HUFF_NE), (B, HUFF_NE)).copy()
            for s in range(c0, min(c0 + C, n)):
                path[:, s] = e
                e = np.take_along_axis(ex[:, s], e, 1)
            c_exit.append(e)
        c_ent = np.zeros((B, len(c_exit)), np.int64)
        guess = c_ent.copy()
        for c, e in enumerate(c_exit):  # the walk over the chunks' exits
            c_ent[:, c] = entry
            guess[:, c] = ex[:, c * C - 1, 0] if c else entry
            entry = e[rows, entry]
        if stats is not None:
            live = nout < T
            stats["repaired"] = stats.get("repaired", 0) + int(((c_ent != guess).any(1) & live).sum())
            stats["pages"] = stats.get("pages", 0) + int(live.sum())
        s_ent = np.take_along_axis(path, c_ent[:, np.arange(n) // C, None], 2)[..., 0]
        s_cnt = np.take_along_axis(cnt, s_ent[..., None], 2)[..., 0]
        s_out = nout[:, None] + np.cumsum(s_cnt, 1) - s_cnt
        nout = nout + s_cnt.sum(1)
        p, idx = a[None, :] + s_ent, np.minimum(s_out, T)
        while True:  # phase C: every span from its true entry
            act = (p < b[None, :]) & (idx < T)
            if not act.any():
                break
            pk = huff_peek(words, p)
            bi, si = np.nonzero(act)
            out[bi, idx[bi, si]] = np.take_along_axis(sym, pk, 1)[bi, si]
            idx += act
            p = np.where(act, p + np.take_along_axis(L, pk, 1), p)
    for bi in np.nonzero(nout < T)[0]:  # the periodic tail from E
        w = int(words[bi, W - 1])
        v = [((w << r) | (w >> (32 - r))) & 0xFFFFFFFF for r in range(32)]
        pk = np.asarray([x >> 18 for x in v])
        Lr, sr = L[bi, pk], sym[bi, pk]
        r, walk = int(entry[bi]), []
        for _ in range(64):
            walk.append(r)
            r = (r + int(Lr[r])) & 31
        lam = next((k for k in range(1, 32) if walk[32 + k] == walk[32]), 32)
        j = np.arange(T - int(nout[bi]))
        at = np.where(j < 32, np.minimum(j, 63), 32 + (j - 32) % lam)
        out[bi, int(nout[bi]) :] = sr[np.asarray(walk)[at]]
    return out


def fuzz_ppm(seed: int, B: int = 4, block: int = 2048, names=None) -> dict:
    """Inputs of _decode_blocks drawn from a seed, for the worst cases of
    csrc/ppm_decode.cu, as staged numpy (words [B, W] int32, seg_lens [B,
    32] int32, prior [2, 4096, 16] int32, steps) a pattern. Real streams
    come from the port's encoder (encode_blocks) on slices of build_corpus
    under P, the prior of B blocks of `block` bytes of it (build_prior, as
    a container of 64 KiB or more ships), unless named otherwise:
    - "text": those B blocks (steps 64 at the default);
    - "random", "zero_words": text's segments, prior and W with random or
      all-zero words (every row read in every chunk; every lane renorms
      at every read, against one row);
    - "short": two full blocks and one of 20 bytes (under 32: lanes
      without a byte, a short last block);
    - "long_segs": short's streams with every segment at or past steps
      (lanes decode past their bytes, into the padding);
    - "ragged_segs": text's stream, segment lengths from -2..steps + 3;
    - "prior0", "prior255": text encoded under an all-0 prior (what a
      short container ships) and an all-255 one (the largest totals);
    - "zeros", "repetitive": the containers of tests/test_ppm_tpu.py at 4
      KiB blocks (5,000 zero bytes: a short last block; 4,000 bytes of
      "abcabcabd"), with no prior;
    - "steps2", "steps16", "steps32": blocks of 64, 512 and 1024 bytes, the
      smallest schedules (2; 2/2/4/8; then a 16);
    - "cut40": text's streams cut to 40 words (the clamped window reads the
      last word, which holds data);
    - "truncated": text's streams with the last cut by 301 bytes, as a
      container cut short.
    names: the patterns to return (default all)."""
    import numpy as np

    from nlzm_tpu_torch.research import ppm_tpu

    rng = np.random.default_rng(seed)
    corpus = build_corpus(B * block + 8192)
    start = int(rng.integers(0, 4096))
    text = corpus[start : start + B * block]
    cut = lambda data, bs: [data[i : i + bs] for i in range(0, len(data), bs)]
    P = ppm_tpu.build_prior(*ppm_tpu._layout(cut(text, block))[:4])

    def staged(args):
        return tuple(a.numpy() for a in args[:3]) + (args[3],)

    def under(data, bs, prior=P, trim=0):
        streams = ppm_tpu.encode_blocks(cut(data, bs), prior)
        streams[-1] = streams[-1][: len(streams[-1]) - trim]
        return staged(ppm_tpu.stage_streams(streams, bs, len(data), prior, ["cpu"])[0][0])

    def container(data, bs):
        return staged(ppm_tpu.stage_container(ppm_tpu.compress(data, bs), "cpu")[0])

    def words(fill):
        w, seg, pr, steps = under(text, block)
        return fill(w), seg, pr, steps

    def segs(args, make):
        w, seg, pr, steps = args
        return w, make(seg.shape, steps).astype(np.int32), pr, steps

    const = lambda v: np.full((2, ppm_tpu.ROWS, 16), v, np.int64)
    short = text[: 2 * block + 20]
    make = {
        "text": lambda: under(text, block),
        "random": lambda: words(lambda w: rng.integers(
            -(1 << 31), 1 << 31, w.shape, np.int64).astype(np.int32)),
        "zero_words": lambda: words(np.zeros_like),
        "short": lambda: under(short, block),
        "long_segs": lambda: segs(under(short, block), lambda sh, st: st + rng.integers(0, 6, sh)),
        "ragged_segs": lambda: segs(under(text, block),
                                    lambda sh, st: rng.integers(-2, st + 4, sh)),
        "prior0": lambda: under(text, block, const(0)),
        "prior255": lambda: under(text, block, const(255)),
        "zeros": lambda: container(bytes(5000), 4096),
        "repetitive": lambda: container((b"abcabcabd" * 600)[:4000], 4096),
        "steps2": lambda: under(text[: 64 * B], 64),
        "steps16": lambda: under(text[: 512 * B], 512),
        "steps32": lambda: under(text[: 1024 * B], 1024),
        "cut40": lambda: words(lambda w: np.ascontiguousarray(w[:, :40])),
        "truncated": lambda: under(text, block, trim=301),
    }
    return {k: make[k]() for k in (names or make)}


def ppm_quot(n, d):
    """floor(n / d) as csrc/ppm_decode.cu's quot gets it (int64 numpy, n <
    2^26, n / d < 2^14): the float32 of n times the float32 reciprocal of
    d (both correctly rounded), truncated, then one step each way."""
    import numpy as np

    n, d = np.asarray(n, np.int64), np.asarray(d, np.int64)
    q = (n.astype(np.float32) * (np.float32(1) / d.astype(np.float32))).astype(np.int64)
    r = n - q * d
    return q + (r >= d) - (r < 0)


def ppm_model(words, seg_lens, prior, steps: int, cache_rows: int = PPM_CACHE, stats=None):
    """A numpy model of csrc/ppm_decode.cu's scheme: [B, steps, 32] uint8 as
    _decode_blocks. Carries K [B, 8192, 16] with a stamp a row (the chunk
    + 1 of its last fold, -PPM_HALVINGS: never); chunk c builds from K >>
    (c - stamp), read as 0 where c - stamp >= PPM_HALVINGS. At each read,
    the live lanes whose (table, row) has no slot this chunk get slots,
    distinct rows in lane order of their first lane (the kernel's leader
    may be another lane of the row, which orders a batch's slots
    otherwise: no output depends on it), and each such row is built: its
    group's 16 per-symbol sums
    (once a chunk a group), eff = K + gs // 2 + 8 * prior + 2, tot,
    freq = 1 + ppm_quot(eff * 16368, tot + 1), fences by a cumulative sum
    with the last at 2^14; slots below cache_rows are kept in one array
    (the kernel's shared memory), the rest in another (its device
    memory). A read takes its fences from its slot and logs (slot,
    symbol). At each chunk's end but the last, each slot's row is folded:
    K = (K >> (c + 1 - stamp)) + its counts, stamp c + 1; no other row is
    written. Asserts the bounds the kernel's u16 tables and 32-bit
    division rely on: K and every group sum <= 1023, tot + 1 <= 34,207,
    eff * 16368 < 2^26, ppm_quot equal to floor division. stats (a dict,
    if given) gets "rows" (slots built), "groups" (distinct groups summed,
    chunk by chunk) and "spilled" (slots at or past cache_rows)."""
    import numpy as np

    from nlzm_tpu_torch.research import ppm_tpu

    ROWS, L, M = ppm_tpu.ROWS, ppm_tpu.LANES, 0xFFFFFFFF
    keys_n = 2 * ROWS
    w = np.asarray(words).view(np.uint32).astype(np.int64)
    B, W = w.shape
    seg = np.asarray(seg_lens, np.int64)
    pri = np.asarray(prior, np.int64).reshape(keys_n, 16)
    assert 0 <= pri.min() and pri.max() <= 255
    K = np.full((B, keys_n, 16), -1, np.int64)  # never read before a fold writes it
    stamp = np.full((B, keys_n), -PPM_HALVINGS, np.int64)
    halved = lambda k, sh: np.where(sh < PPM_HALVINGS, k >> np.clip(sh, 0, 31), 0)
    spill_n = max(PPM_SLOTS - cache_rows, 1)
    area = [np.zeros((B, cache_rows, 16), np.int64), np.zeros((B, spill_n, 16), np.int64)]
    x = w[:, :L].copy()
    cursor = np.full(B, 4 * L, np.int64)
    prev = np.zeros((B, L), np.int64)
    prev2 = np.zeros_like(prev)
    out = np.zeros((B, steps, L), np.uint8)
    bidx = np.arange(B)[:, None]
    lower = np.tril(np.ones((L, L), bool), -1)  # [l, l2]: l2 < l
    st_ = stats if stats is not None else {}
    for k in ("rows", "groups", "spilled"):
        st_.setdefault(k, 0)

    def get(b, j):
        inner = j < cache_rows
        jc = np.clip(j, 0, cache_rows - 1)
        js = np.clip(j - cache_rows, 0, spill_n - 1)
        return np.where(inner[..., None], area[0][b, jc], area[1][b, js])

    def put(b, j, v):
        inner = j < cache_rows
        area[0][b[inner], j[inner]] = v[inner]
        area[1][b[~inner], j[~inner] - cache_rows] = v[~inner]

    def build(b, j, key, c, gvalid, gsum):
        g = key >> 4
        rows16 = g[:, None] * 16 + np.arange(16)
        kc = halved(K[b[:, None], rows16], (c - stamp[b[:, None], rows16])[..., None])
        new = ~gvalid[b, g]
        gs = np.where(new[:, None], kc.sum(1), gsum[b, g])
        fresh = np.unique(b[new] * (keys_n // 16) + g[new])
        st_["groups"] += len(fresh)
        gsum[b[new], g[new]] = kc.sum(1)[new]
        gvalid[b, g] = True
        kr = kc[np.arange(len(key)), key & 15]
        eff = kr + gs // 2 + ppm_tpu.PRIOR_W * pri[key] + ppm_tpu.BLEND
        tot = eff.sum(1, keepdims=True)
        assert kc.max(initial=0) <= 1023 and gs.max(initial=0) <= 1023
        assert tot.max(initial=0) + 1 <= 34207 and (eff * 16368).max(initial=0) < 1 << 26
        q = ppm_quot(eff * 16368, tot + 1)
        assert np.array_equal(q, eff * 16368 // (tot + 1))
        fen = np.cumsum(1 + q, 1)
        fen[:, 15] = ppm_tpu.CDF_SCALE_TOTAL
        put(b, j, fen)

    s = 0
    sched = ppm_tpu.chunk_schedule(steps)
    for c, clen in enumerate(sched):
        slot_of = np.full((B, keys_n), -1, np.int64)
        skeys = np.zeros((B, PPM_SLOTS), np.int64)
        nsl = np.zeros(B, np.int64)
        gvalid = np.zeros((B, keys_n // 16), bool)
        gsum = np.zeros((B, keys_n // 16, 16), np.int64)
        log = []
        for _ in range(clen):
            a = s < seg
            base = cursor >> 2
            sym = []
            for r in range(2):
                key = ((prev << 4) | (prev2 >> 4)) if r == 0 else ROWS + ((sym[0] << 8) | prev)
                sl = slot_of[bidx, key]
                miss = a & (sl < 0)
                if miss.any():
                    same = (key[:, :, None] == key[:, None, :]) & miss[:, None, :]
                    lead = miss & ~(same & lower).any(2)
                    bi, li = np.nonzero(lead)
                    j = nsl[bi] + (np.cumsum(lead, 1) - lead)[bi, li]
                    kk = key[bi, li]
                    slot_of[bi, kk] = j
                    skeys[bi, j] = kk
                    n = lead.sum(1)
                    st_["rows"] += int(n.sum())
                    st_["spilled"] += int(np.maximum(nsl + n - np.maximum(nsl, cache_rows), 0).sum())
                    nsl += n
                    build(bi, j, kk, c, gvalid, gsum)
                    sl = slot_of[bidx, key]
                F = get(np.broadcast_to(bidx, sl.shape), np.maximum(sl, 0))
                f = x & 0x3FFF
                y = (f[..., None] >= F[..., :15]).sum(-1)
                start = np.where(y > 0, np.take_along_axis(F, np.maximum(y - 1, 0)[..., None], -1)[..., 0], 0)
                end = np.take_along_axis(F, y[..., None], -1)[..., 0]
                x2 = ((end - start) * (x >> 14) + (f - start)) & M
                ren = a & (x2 < (1 << 16))
                rr = ren.astype(np.int64)
                rank = np.cumsum(rr, 1) - rr
                h = np.clip((cursor[:, None] + 2 * rank - 4 * base[:, None]) >> 1, 0,
                            ppm_tpu.WIN_H - 1)
                wd = w[bidx, np.clip(base[:, None] + (h >> 1), 0, W - 1)]
                half = (wd >> (16 * (h & 1))) & 0xFFFF
                pair = ((half & 0xFF) << 8) | (half >> 8)
                x = np.where(a, np.where(ren, ((x2 << 16) | pair) & M, x2), x)
                cursor = cursor + 2 * rr.sum(1)
                y = np.where(a, y, 0)
                bi, li = np.nonzero(a)
                log.append((bi, sl[bi, li], y[bi, li]))
                sym.append(y)
            byte = (sym[0] << 4) | sym[1]
            prev2 = np.where(a, prev, prev2)
            prev = np.where(a, byte, prev)
            out[:, s] = byte
            s += 1
        if c + 1 == len(sched):
            break
        bi = np.repeat(np.arange(B), nsl)
        j = np.concatenate([np.arange(n) for n in nsl]) if B else np.zeros(0, np.int64)
        key = skeys[bi, j]
        put(bi, j, halved(K[bi, key], (c + 1 - stamp[bi, key])[:, None]))
        cnt = np.zeros((B, PPM_SLOTS, 16), np.int64)
        for lb, ls, ly in log:
            np.add.at(cnt, (lb, ls, ly), 1)
        folded = get(bi, j) + cnt[bi, j]
        assert folded.max(initial=0) <= 1023
        K[bi, key] = folded
        stamp[bi, key] = c + 1
    return out


def fuzz_matches(seed: int, card: bool = False, names=None) -> dict:
    """Inputs of find_matches drawn from a seed, for the worst cases of
    csrc/find_matches.cu: (data [B, N] uint8, n_valid [B] int32, reach, C)
    a pattern. At 4 x 4096, reach 4095, three candidates unless named
    otherwise:
    - "text": blocks of build_corpus; "random": random bytes (~N distinct
      hashes, lengths mostly 0); "zeros": one hash group of N, every length
      264 up to the tail;
    - "runs_short", "runs_long": a random unit of period 1, 2, 3, 4 and of
      7, 264, 265 and 9 repeated, then random bytes from 3/4 of the block;
    - "collisions": distinct words that share one 16-bit hash (from the
      hash's inverse), aligned, one to three bytes apart, and with true
      repeats among them;
    - "ragged_a", "ragged_b": zero padding past n_valid 4096, 0, 1, 2 and
      3, 4096, 4096, 1234 (a short last block);
    - "nvalid_wrap": random 2-bit bytes at n_valid N + 100, -5, -2^31 and
      2^31 - 1 (the limit max(n_valid - p, 0) wraps in int32);
    - "reach1" (two candidates), "reach2" (one), "reach_far" (N + 1000, four
      candidates): random bits, text and runs of period 1 and 2 at 4 x 700;
      "reach300" (one candidate): random 2-bit bytes and text;
    - "n4097" and "n8192" (the v1 block; one candidate each), "rle"
      (tests/test_wide.py's RLE data, n_valid 24000, at 32768, the largest
      block with positions in shared memory), "n32769" (two candidates) and
      "n40000" (one candidate): past it, positions in device memory;
    - card=True adds "n131072" (2 x 131072, text and zeros: the format's
      block cap), too big for the CPU tests.
    names: the patterns to return (default all)."""
    import numpy as np

    from nlzm_tpu_torch.constants import HASH4_MULT

    rng = np.random.default_rng(seed)
    corpus = np.frombuffer(build_corpus(1 << 18), np.uint8)
    B, N = 4, 4096

    def text(b, n):
        start = rng.integers(0, len(corpus) - b * n, b)
        return np.stack([corpus[s : s + n] for s in start])

    def full(data, reach=None, C=3, n_valid=None):
        b, n = data.shape
        nv = np.full(b, n, np.int64) if n_valid is None else np.asarray(n_valid, np.int64)
        return (np.ascontiguousarray(data, np.uint8), nv.astype(np.int32),
                n - 1 if reach is None else reach, C)

    def runs(periods):
        rows = []
        for k in periods:
            unit = rng.integers(0, 256, k, np.uint8)
            row = np.resize(unit, N)
            cut = 3 * N // 4
            row[cut:] = rng.integers(0, 256, N - cut, np.uint8)
            rows.append(row)
        return np.stack(rows)

    def collisions():
        # w * HASH4_MULT mod 2^32 in [h << 16, (h + 1) << 16): 65536 words a
        # hash, w = y * HASH4_MULT^-1 mod 2^32
        inv = pow(HASH4_MULT, -1, 1 << 32)
        h = int(rng.integers(0, 1 << 16))
        y = (h << 16) + rng.permutation(1 << 16)[: 4 * N].astype(np.uint64)
        words = (y * np.uint64(inv)) & np.uint64(0xFFFFFFFF)
        wb = words.astype("<u4").view(np.uint8).reshape(-1, 4)
        rows = [wb[:1024].reshape(-1)]
        gaps = []
        for i in range(1024):
            gaps.append(wb[1024 + i])
            gaps.append(rng.integers(0, 256, int(rng.integers(1, 4)), np.uint8))
        rows.append(np.concatenate(gaps)[:N])
        rep = wb[2048:2048 + 64][rng.integers(0, 64, 1024)]  # true repeats among them
        rows.append(rep.reshape(-1))
        mixed = wb[3072:4096].copy()
        mixed[::3] = wb[3072]
        rows.append(mixed.reshape(-1))
        return np.stack(rows)

    bits2 = lambda b, n: rng.integers(0, 4, (b, n), np.uint8)
    # short distances: random bits, text, runs of period 1 and 2
    near = lambda: np.concatenate([rng.integers(0, 2, (1, 700), np.uint8), text(1, 700),
                                   np.resize(rng.integers(0, 256, 1, np.uint8), (1, 700)),
                                   np.resize(rng.integers(0, 256, 2, np.uint8), (1, 700))])

    def padded(data, nv):
        data = data.copy()
        for b, n in enumerate(nv):
            data[b, max(n, 0):] = 0
        return full(data, n_valid=nv)

    rle = np.frombuffer((b"\x00" * 5000) + (b"ab" * 4000) + (b"xyz" * 3000) + b"tail" * 500,
                        np.uint8)
    make = {
        "text": lambda: full(text(B, N)),
        "random": lambda: full(rng.integers(0, 256, (B, N), np.uint8)),
        "zeros": lambda: full(np.zeros((B, N), np.uint8)),
        "runs_short": lambda: full(runs((1, 2, 3, 4))),
        "runs_long": lambda: full(runs((7, 264, 265, 9))),
        "collisions": lambda: full(collisions()),
        "ragged_a": lambda: padded(text(B, N), (N, 0, 1, 2)),
        "ragged_b": lambda: padded(text(B, N), (3, N, N, 1234)),
        "nvalid_wrap": lambda: full(bits2(B, N), n_valid=(N + 100, -5, -(1 << 31), (1 << 31) - 1)),
        "reach1": lambda: full(near(), 1, 2),
        "reach2": lambda: full(near(), 2, 1),
        "reach300": lambda: full(np.concatenate([bits2(2, N), text(2, N)]), 300, 1),
        "reach_far": lambda: full(near(), 1700, 4),
        "n4097": lambda: full(text(4, 4097), C=1),
        "n8192": lambda: full(np.concatenate([text(3, 8192), bits2(1, 8192)]), C=1),
        "rle": lambda: full(np.pad(rle, (0, 32768 - len(rle)))[None], n_valid=(len(rle),)),
        "n32769": lambda: full(text(1, 32769), C=2),
        "n40000": lambda: full(np.concatenate([text(1, 30000), np.zeros((1, 10000), np.uint8)], 1),
                               C=1),
    }
    if card:
        make["n131072"] = lambda: full(np.concatenate([text(1, 131072),
                                                       np.zeros((1, 131072), np.uint8)]))
    return {k: make[k]() for k in (names or make)}


def fm_threads(B: int, N: int) -> int:
    """csrc/find_matches.cu's threads a CTA for B blocks of N bytes."""
    t = -(-N // (FM_FEW_ITEMS if B < FM_FEW_BLOCKS else FM_ITEMS))
    return 32 if t <= 32 else (1024 if t >= 1024 else (t + 31) // 32 * 32)


def fm_words(data):
    """The block zero-padded past N as the kernel holds it (FM_PAD zero
    bytes, to 16), as little-endian u32 words [B, W] (uint64)."""
    import numpy as np

    B, N = data.shape
    width = (N + FM_PAD + 15) // 16 * 16
    padded = np.zeros((B, width), np.uint8)
    padded[:, :N] = data
    return padded.view("<u4").astype(np.uint64)


def fm_word(W, b, x):
    """The little-endian word at byte offsets x of blocks b: two aligned
    words and a funnel shift."""
    import numpy as np

    lo, hi = W[b, x >> 2], W[b, (x >> 2) + 1]
    return ((hi << np.uint64(32) | lo) >> ((x & 3) * 8).astype(np.uint64)) & np.uint64(0xFFFFFFFF)


def fm_first_byte(x):
    """The index of the lowest nonzero byte of each nonzero u32 x (__ffs)."""
    import numpy as np

    low = (x & (~x + np.uint64(1))).astype(np.float64)
    return np.log2(low).astype(np.int64) >> 3


def fm_long(W, bi, pi, d):
    """Lengths of the candidates equal through FM_SHORT bytes, as the
    kernel's long_prefix finds them: the positions of a warp (32 aligned
    ones), lowest first, with every alive one of the lowest's distance d;
    the warp compares 4 bytes a lane, 128 a step, over [p_s + FM_SHORT,
    p_last + 264), and each takes the first mismatch from its own p +
    FM_SHORT."""
    import numpy as np

    out = np.full(bi.size, MAX_MATCH, np.int64)
    steps = -(-(31 + MAX_MATCH - FM_SHORT) // 128)
    warp = bi * (1 << 20) + (pi >> 5)
    order = np.argsort(warp, kind="stable")
    cuts = np.flatnonzero(np.diff(warp[order])) + 1
    for todo in np.split(order, cuts) if order.size else ():
        while todo.size:
            s = todo[np.argmin(pi[todo])]
            group = todo[d[todo] == d[s]]
            base, end = pi[s] + FM_SHORT, pi[group].max() + MAX_MATCH
            y = base + 4 * np.arange(32 * steps)  # word jj = 32 j + lane
            xs = np.where(y < end, fm_word(W, bi[s], np.minimum(y, end))
                          ^ fm_word(W, bi[s], np.minimum(y, end) - d[s]), np.uint64(0))
            r = pi[group] - pi[s]  # bytes into the range; in word c < 8
            c = r >> 2
            xc = xs[c] & (np.uint64(0xFFFFFFFF) << (8 * (r & 3)).astype(np.uint64))
            nz = np.flatnonzero(xs)
            at = np.searchsorted(nz, c + 1)  # the first word past c with a mismatch
            cc = np.where(xc != 0, c, nz[np.minimum(at, max(nz.size - 1, 0))] if nz.size else 0)
            x = np.where(xc != 0, xc, xs[cc])
            found = (xc != 0) | (at < nz.size)
            m = 4 * cc + fm_first_byte(np.where(found, x, np.uint64(1)))
            out[group] = np.where(found, np.minimum(FM_SHORT + m - r, MAX_MATCH), MAX_MATCH)
            todo = todo[d[todo] != d[s]]
    return out


def fm_model(data, n_valid, reach: int, C: int):
    """A numpy model of csrc/find_matches.cu's scheme: (delta, mlen) int32
    [B, N, C] ([B, N] at C = 1) as find_matches. Warp w of fm_threads(B,
    N) owns items [32 R w, 32 R (w + 1)), R = ceil(N / threads).
    - Pass 1: per-warp counts of the hash's low byte, offsets by an
      exclusive sum in digit-major order, an item's rank its offset plus the
      warp's earlier items with its digit (the rounds' lower peers and the
      running count): `order`, positions by (low byte, position).
    - Pass 2 over `order`: an item's predecessor is the warp's previous item
      with its high byte, else the last such item of the nearest earlier
      warp (low byte << 24 | position, carried forward); prev[pos] is it
      when the low bytes agree.
    - The chain prev^k, ended by the first candidate out of reach; lengths a
      word at a time over the zero-padded block (fm_word), the first unequal
      byte from the XOR's lowest set bit, capped at 264 and at max(n_valid
      - p, 0) wrapped in int32."""
    import numpy as np

    from nlzm_tpu_torch.constants import HASH4_MULT

    data = np.asarray(data, np.uint8)
    B, N = data.shape
    T = fm_threads(B, N)
    NW, R = T // 32, -(-N // T)
    W = fm_words(data)
    bb = np.repeat(np.arange(B), N).reshape(B, N)
    j = np.broadcast_to(np.arange(N), (B, N))
    warp = j // (32 * R)

    def hashes(pos):
        return ((fm_word(W, bb, pos) * np.uint64(HASH4_MULT)) & np.uint64(0xFFFFFFFF)) >> np.uint64(16)

    def warp_ranks(key):
        """An item's rank among the earlier items of its warp with its
        key, the flat index of the warp's previous one (-1: none), and
        whether it is the warp's last."""
        flat = ((bb * NW + warp) * 256 + key).reshape(-1)
        idx = np.argsort(flat, kind="stable")
        sk = flat[idx]
        same = sk[1:] == sk[:-1]
        start = np.r_[0, np.flatnonzero(~same) + 1]
        first = np.repeat(start, np.diff(np.r_[start, sk.size]))
        rank, before = np.empty(sk.size, np.int64), np.full(sk.size, -1, np.int64)
        is_last = np.ones(sk.size, bool)
        rank[idx] = np.arange(sk.size) - first
        before[idx[1:]] = np.where(same, idx[:-1], -1)
        is_last[idx[:-1]] = ~same
        return rank.reshape(B, N), before.reshape(B, N), is_last.reshape(B, N)

    # pass 1
    lo = (hashes(j) & np.uint64(255)).astype(np.int64)
    counts = np.zeros((B, 256, NW), np.int64)
    np.add.at(counts, (bb, lo, warp), 1)
    flat = counts.reshape(B, -1)
    offsets = (np.cumsum(flat, 1) - flat).reshape(B, 256, NW)
    rank, _, _ = warp_ranks(lo)
    dest = offsets[bb, lo, warp] + rank
    order = np.full((B, N), -1, np.int64)
    order[bb, dest] = j
    assert (np.sort(order, 1) == j).all(), "pass 1 ranks are no permutation"

    # pass 2
    h2 = hashes(order)
    hi, lo2 = (h2 >> np.uint64(8)).astype(np.int64), (h2 & np.uint64(255)).astype(np.int64)
    item = lo2 << 24 | order
    _, before, is_last = warp_ranks(hi)
    last = np.full((B, NW, 256), -1, np.int64)
    last[bb[is_last], warp[is_last], hi[is_last]] = item[is_last]  # the warp's last a digit
    carried = np.full((B, NW, 256), -1, np.int64)
    for w in range(1, NW):
        carried[:, w] = np.where(last[:, w - 1] >= 0, last[:, w - 1], carried[:, w - 1])
    pred = np.where(before >= 0, item.reshape(-1)[np.maximum(before, 0)].reshape(B, N),
                    carried[bb, warp, hi])
    prev = np.full((B, N), -1, np.int64)
    prev[bb, order] = np.where((pred >= 0) & (pred >> 24 == lo2), pred & 0xFFFFFF, -1)

    # the chain and the lengths
    lim = np.maximum((np.asarray(n_valid, np.int64)[:, None] - j + (1 << 31)) % (1 << 32)
                     - (1 << 31), 0)
    D = np.zeros((B, N, C), np.int64)
    L = np.zeros((B, N, C), np.int64)
    q = prev
    for k in range(C):
        ok = (q >= 0) & (j - q <= reach)
        bi, pi = np.nonzero(ok)
        qi = q[bi, pi]
        n = np.zeros(bi.size, np.int64)
        alive = np.ones(bi.size, bool)
        for w4 in range(0, FM_SHORT, 4):  # a lane alone: the first FM_SHORT bytes
            x = fm_word(W, bi, pi + w4) ^ fm_word(W, bi, qi + w4)
            hit = alive & (x != 0)
            n[hit] = w4 + fm_first_byte(x[hit])
            alive &= ~hit
        n[alive] = fm_long(W, bi[alive], pi[alive], pi[alive] - qi[alive])
        D[bi, pi, k] = pi - qi
        L[bi, pi, k] = np.minimum(n, lim[bi, pi])
        q = np.where(ok, prev[bb, np.maximum(q, 0)], -1)
    D, L = D.astype(np.int32), L.astype(np.int32)
    return (D[..., 0], L[..., 0]) if C == 1 else (D, L)


def fuzz_scan(seed: int, names=None) -> dict:
    """Inputs of plane_scan_fused drawn from a seed, for the worst cases of
    csrc/plane_scan.cu: (seeds [B, 208] uint32, wins (five int32 [NC, B,
    WH_p], wire order), n_syms [B, 5] int32, steps, priors (five int32
    [alph], wire order) or None) a pattern. Random u32 seeds and u16
    windows; at B = 4, steps 40 and the shipping bucket's window widths
    (72, 352, 64, 48, 88) unless named otherwise:
    - "random": n_sym random in 0..steps * L_p; "b1": the same at B = 1;
    - "edges_low", "edges_high": n_sym 0, 1, L - 1, L and steps * L, steps
      * L + 5, -3, 2^31 - 1 in every plane, one value a block;
    - "one_empty": block b's wire plane b empty, the others full (steps *
      L); "dst_empty": B = 1, dst empty, the others full;
    - "seeds_zero": every seed 0, planes full (every lane renormalises at
      once);
    - "priors_random", "priors_zero", "priors_max": random u16 priors, all
      0 (lit's 255 fences in its first 256 CDF values), all 65535;
    - "narrow": windows (8, 16, 8, 8, 8), planes full: pairs past every
      plane's window, dst's into the zero padding (JAX's index); "narrow_odd":
      (5, 13, 7, 3, 9), random priors: rows copied 4 bytes at a time;
    - "wide": B = 2, windows 8 L_p (the ring's whole slot), planes full;
    - "steps2" (B = 1, the smallest launch), "steps4", "steps8", "steps16"
      (B = 2): the warmup chunks alone, planes full, random priors.
    names: the patterns to return (default all)."""
    import numpy as np

    from nlzm_tpu_torch.format.wide import chunk_schedule

    rng = np.random.default_rng(seed)
    Ls = np.asarray(PS_WIRE_LANES, np.int64)

    def make(B=4, steps=40, WH=PS_WH_SHIP, nsym="random", priors=None, seeds="random"):
        NC = len(chunk_schedule(steps))
        sd = (np.zeros((B, 208), np.uint32) if seeds == "zero"
              else rng.integers(0, 1 << 32, (B, 208), dtype=np.uint64).astype(np.uint32))
        wins = tuple(rng.integers(0, 1 << 16, (NC, B, w)).astype(np.int32) for w in WH)
        if isinstance(nsym, str):
            full = np.broadcast_to(steps * Ls, (B, 5))
            ns = full if nsym == "full" else rng.integers(0, full + 1)
        else:
            ns = nsym
        pri = None
        if priors == "random":
            pri = tuple(rng.integers(0, 1 << 16, a).astype(np.int32) for a in PS_WIRE_ALPH)
        elif priors is not None:
            pri = tuple(np.full(a, priors, np.int32) for a in PS_WIRE_ALPH)
        return sd, wins, np.ascontiguousarray(ns, np.int32), steps, pri

    def edges(values):
        return np.stack([[v(int(L)) for L in Ls] for v in values])

    def one_empty():
        ns = np.broadcast_to(40 * Ls, (4, 5)).copy()
        ns[np.arange(4), np.arange(4)] = 0
        return ns

    dst_empty = np.append(40 * Ls[:4], 0)[None]
    pats = {
        "random": lambda: make(),
        "b1": lambda: make(B=1),
        "edges_low": lambda: make(nsym=edges((lambda L: 0, lambda L: 1, lambda L: L - 1,
                                               lambda L: L))),
        "edges_high": lambda: make(nsym=edges((lambda L: 40 * L, lambda L: 40 * L + 5,
                                                lambda L: -3, lambda L: (1 << 31) - 1))),
        "one_empty": lambda: make(nsym=one_empty()),
        "dst_empty": lambda: make(B=1, nsym=dst_empty),
        "seeds_zero": lambda: make(nsym="full", seeds="zero"),
        "priors_random": lambda: make(priors="random"),
        "priors_zero": lambda: make(priors=0),
        "priors_max": lambda: make(priors=0xFFFF),
        "narrow": lambda: make(WH=(8, 16, 8, 8, 8), nsym="full"),
        "narrow_odd": lambda: make(WH=(5, 13, 7, 3, 9), nsym="full", priors="random"),
        "wide": lambda: make(B=2, WH=tuple(PS_MAX_CLEN * int(L) for L in Ls), nsym="full"),
        **{f"steps{n}": (lambda n=n: make(B=1 if n == 2 else 2, steps=n, nsym="full",
                                           priors="random"))
           for n in (2, 4, 8, 16)},
    }
    return {k: pats[k]() for k in (names or pats)}


def fuzz_expand(seed: int, names=None) -> dict:
    """Inputs of lz_expand_parallel drawn from a seed, for the worst cases
    of csrc/lz_expand.cu: (op_len [T, B] int32, op_val [T, B] int32, N,
    dictionary [D] uint8 or None) a pattern. The draw: op_len uniform in
    1..11, half of the slots then literals (op_len 0, op_val 0..255), a
    match's distance 1..63; B = 3 and T = N / 8 at N = 4096 without a
    dictionary ("_4k") and at the shipping shape, N = 32768 with a 32 KiB
    dictionary ("_ship"):
    - "valid": the draw;
    - "delta_big", "delta_neg": each block's 6th match at distance 2^17,
      at -3; "lit_big": each block's 6th literal's op_val 40000;
      "past_end": the last 16 slots matches of 8 KiB at distance 1 (the
      four classes where JAX's packed words leave their packing);
    - "b1" (ship): the draw at B = 1; "rle_one" (ship, B = 1): one literal,
      then one match of N - 1 at distance 1;
    - "dict_far" (ship): distances up to 20,000 past the dictionary;
    - "deep_chain" (4k): each match copies the command before it (chains
      ~N / 8 deep); "zero_delta": a tenth of the matches at distance 0;
      "pad_middle": a fifth of the slots padding (op_len -1..-5) between
      live ones; "past_n": lengths to 40 (the sum passes N);
      "past_2_31": lengths of ~2^30 and 2^31 - 1 in each block (the sum
      passes 2^31, and 2^32 in block 2);
    - "t0" (4k): T = 0 (JAX's expansion raises there).
    names: the patterns to return (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = {"4k": (3, 4096, 0), "ship": (3, 32768, 32768)}
    dicts = {D: rng.integers(0, 256, D).astype(np.uint8) for D in (32768,)}

    def draw(B, N, max_len=11, max_dist=63):
        T = N // 8
        ol = rng.integers(1, max_len + 1, (T, B))
        lit = rng.random((T, B)) < 0.5
        ol[lit] = 0
        ov = np.where(lit, rng.integers(0, 256, (T, B)), rng.integers(1, max_dist + 1, (T, B)))
        return ol.astype(np.int64), ov.astype(np.int64)

    def nth(mask, n):
        """(rows, cols) of each block's n-th True slot in mask [T, B]."""
        rows = np.argmax(np.cumsum(mask, 0) == n, 0)
        return rows, np.arange(mask.shape[1])

    def make(shape, change=None, B=None, **kw):
        B0, N, D = shapes[shape]
        ol, ov = draw(B or B0, N, **kw)
        if change is not None:
            change(ol, ov, N)
        return (ol.astype(np.int32), ov.astype(np.int32), N, dicts.get(D))

    def set_nth(kind, value):
        def change(ol, ov, N):
            ov[nth(ol > 0 if kind == "match" else ol == 0, 6)] = value
        return change

    def past_end(ol, ov, N):
        ol[-16:], ov[-16:] = 8192, 1

    def rle_one(ol, ov, N):
        ol[:], ov[:] = -1, 0
        ol[0], ov[0], ol[1], ov[1] = 0, 0x5A, N - 1, 1

    def dict_far(ol, ov, N):
        m = ol > 0
        ov[m] = rng.integers(1, 32768 + 20000, m.sum())

    def deep_chain(ol, ov, N):
        T, B = ol.shape
        for b, period in enumerate((8, 3, None)):
            if period is None:
                ol[:, b] = rng.integers(1, 12, T)
                ol[0, b], ov[:, b] = 0, 0
                ov[1:, b] = ol[:-1, b]
                ov[1, b] = 1
            else:
                ol[:period, b], ov[:period, b] = 0, rng.integers(0, 256, period)
                ol[period:, b], ov[period:, b] = period, period

    def zero_delta(ol, ov, N):
        ov[(ol > 0) & (rng.random(ol.shape) < 0.1)] = 0

    def pad_middle(ol, ov, N):
        pad = rng.random(ol.shape) < 0.2
        ol[pad] = rng.integers(-5, 0, pad.sum())

    def past_2_31(ol, ov, N):
        ol[100, 0] = (1 << 31) - 1
        ol[100:102, 1] = 1 << 30
        ol[200, 2] = ol[300, 2] = ol[400, 2] = (1 << 31) - 1

    pats = {
        **{f"valid_{s}": (lambda s=s: make(s)) for s in shapes},
        **{f"delta_big_{s}": (lambda s=s: make(s, set_nth("match", 1 << 17))) for s in shapes},
        **{f"delta_neg_{s}": (lambda s=s: make(s, set_nth("match", -3))) for s in shapes},
        **{f"lit_big_{s}": (lambda s=s: make(s, set_nth("literal", 40000))) for s in shapes},
        **{f"past_end_{s}": (lambda s=s: make(s, past_end)) for s in shapes},
        "b1": lambda: make("ship", B=1),
        "rle_one": lambda: make("ship", rle_one, B=1),
        "dict_far": lambda: make("ship", dict_far),
        "deep_chain": lambda: make("4k", deep_chain),
        "zero_delta": lambda: make("4k", zero_delta),
        "pad_middle": lambda: make("4k", pad_middle),
        "past_n": lambda: make("4k", max_len=40),
        "past_2_31": lambda: make("4k", past_2_31),
        "t0": lambda: tuple(np.zeros((0, 3), np.int32) for _ in range(2)) + (4096, None),
    }
    return {k: pats[k]() for k in (names or pats)}


def expand_packed_model(ol, ov, s32, prod, N: int, D: int, dict_arr, rounds_hint):
    """csrc/lz_expand.cu's lz_expand_packed_kernel on one flagged block:
    JAX's packed-path sorts word for word (u32 words in int64), the rounds,
    the corner patch and the zeroing past prod. ol, ov, s32: the block's
    [T] int64 op_len, op_val and int32-wrapped starts."""
    import numpy as np

    M32, PAD = 0xFFFFFFFF, 0xFFFFFFFF
    i = np.arange(N, dtype=np.int64)

    def fill(src, qry, pb, post):
        pmask = (1 << pb) - 1
        s = np.sort(np.concatenate([src, qry]))
        q = (((s >> pb) & 1) == 1) & (s != PAD)
        f = np.maximum.accumulate(np.where(q | (s == PAD), 0, s))
        key = np.where(q, ((s & pmask) << pb) | post(f, s & pmask), PAD)
        return np.sort(key)[:N] & pmask

    pb = 16 if D else 15
    lens = np.where(ol < 0, 0, np.where(ol == 0, 1, ol))
    src = np.where(lens > 0, (((s32 & M32) << (pb + 1)) & M32) | (np.where(ol == 0, 0, ov) & M32),
                   PAD)

    def post_parent(f, qpay):
        m, d = f >> (pb + 1), f & ((1 << pb) - 1)
        par = np.where(d == 0, qpay, m - d + np.mod(qpay - m, np.maximum(d, 1)))
        return np.clip(par + D, 0, D + N - 1)

    cur = fill(src, (((i << 1) | 1) << pb) | i, pb, post_parent)
    bound = max(1, (N - 1).bit_length())
    bound = bound if rounds_hint is None else min(int(rounds_hint), bound)
    for _ in range(bound):
        nxt = np.where(cur >= D, cur[np.clip(cur - D, 0, N - 1)], cur)
        changed = (nxt != cur).any()
        cur = nxt
        if not changed:
            break
    lit = ol == 0
    pos = (s32 + D) & M32
    src = np.where(lit, ((pos << 16) & M32) | (ov & M32), PAD)
    if D:
        src = np.concatenate([(np.arange(D, dtype=np.int64) << 16) | dict_arr, src])
    key = np.minimum(cur, D + N - 2) if D else cur
    out = fill(src, (((key << 1) | 1) << 15) | i, 15, lambda f, qpay: f & 0xFF)
    if D and cur[N - 1] == D + N - 1:
        out[N - 1] = int(np.where(lit & (s32 == N - 1), ov, 0).sum()) & 0xFF
    return np.where(i < prod, out & 0xFF, 0).astype(np.uint8)


def expand_model(op_len, op_val, N: int, rounds_hint=None, dict_arr=None, stats=None):
    """numpy model of csrc/lz_expand.cu (op_len, op_val [T, B] int32;
    dict_arr [D] uint8 or None) -> (out [B, N] uint8, produced [B] int32):
    on JAX's packed path, the kernel's packing check and, for a flagged
    block, expand_packed_model; else each block as lz_expand_kernel runs
    it: int64 starts, the start marks and a max-scan for each position's
    covering command, its parent m - d + ((i - m) mod d) shifted by D and
    clamped (u16 on the packed path), positions past the produced count
    rooted at themselves; synchronous rounds, stopped after one that
    changes nothing; the byte pass with the packed path's corner and cap,
    and, when a parent is neither in the dictionary nor a literal, the
    literal bytes rewritten with the latest literal's (or the last
    dictionary byte) and the pass again. stats, when given, gets per block
    "flagged", "rounds" (those that changed something) and "unresolved"."""
    import numpy as np

    T, B = op_len.shape
    D = 0 if dict_arr is None else len(dict_arr)
    packed = N <= 32768 and D + N <= 1 << 16
    top = D + N - 1
    dct = None if dict_arr is None else np.asarray(dict_arr).astype(np.int64)
    ol = op_len.T.astype(np.int64)
    ov = op_val.T.astype(np.int64)
    lens = np.where(ol < 0, 0, np.where(ol == 0, 1, ol))
    ends = np.cumsum(lens, 1)
    starts = ends - lens
    total = ends[:, -1] if T else np.zeros(B, np.int64)
    wrap = lambda x: ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    prod, s32 = wrap(total), wrap(starts)
    delta = np.where(ol == 0, 0, ov)
    flagged = np.zeros(B, bool)
    if packed:
        span, pay = (1 << 15, 1 << 16) if D else (1 << 16, 1 << 15)
        bad = (lens > 0) & ((s32 < 0) | (s32 >= span) | (delta < 0) | (delta >= pay))
        bad |= (ol == 0) & ((ov < 0) | (ov >= 1 << 15) | (s32 + D >= 1 << 16))
        flagged = bad.any(1)
    i = np.arange(N, dtype=np.int64)
    out = np.zeros((B, N), np.uint8)
    st = {"flagged": flagged.tolist(), "rounds": [], "unresolved": []}
    for b in range(B):
        if flagged[b]:
            out[b] = expand_packed_model(ol[b], ov[b], s32[b], prod[b], N, D, dct, rounds_hint)
            st["rounds"].append(None)
            st["unresolved"].append(None)
            continue
        live = (lens[b] > 0) & (starts[b] < N)
        mk = starts[b][live]
        delta_at = np.zeros(N, np.int64)
        delta_at[mk] = delta[b][live] & 0xFFFF if packed else delta[b][live]
        mark = np.full(N, -1, np.int64)
        mark[mk] = mk
        m = np.maximum.accumulate(mark)
        d = np.where(m >= 0, delta_at[np.maximum(m, 0)], 0)
        par = np.where((m < 0) | (i >= total[b]) | (d == 0), i,
                       m - d + np.mod(i - m, np.maximum(d, 1)))
        cur = np.clip(par + D, 0, top)
        if packed:
            assert cur.max(initial=0) < 1 << 16  # the u16 parents
            cur = cur.astype(np.uint16).astype(np.int64)
        bound = max(1, (N - 1).bit_length())
        bound = bound if rounds_hint is None else min(int(rounds_hint), bound)
        changed_rounds = 0
        for _ in range(bound):
            nxt = np.where(cur >= D, cur[np.clip(cur - D, 0, N - 1)], cur)
            changed = (nxt != cur).any()
            cur = nxt
            if not changed:
                break
            changed_rounds += 1
        lits = live & (ol[b] == 0)
        lit = np.zeros(N, np.int64)
        lit[starts[b][lits]] = ov[b][lits] & 0xFF
        lmask = np.zeros(N, bool)
        lmask[starts[b][lits]] = True
        sort_dict = packed and D > 0
        q = np.minimum(cur, top - 1) if sort_dict else cur
        j = np.clip(q - D, 0, N - 1)
        from_dict = q < D
        unresolved = (i < prod[b]) & ~from_dict & ~lmask[j]
        if unresolved.any():
            lpos = np.maximum.accumulate(np.where(lmask, i, -1))
            none = int(dct[D - 1]) if sort_dict else 0
            lit = np.where(lmask, lit, np.where(lpos >= 0, lit[np.maximum(lpos, 0)], none))
        byte = np.where(from_dict, 0 if dct is None else dct[np.clip(q, 0, max(D - 1, 0))],
                        lit[j])
        if sort_dict and cur[N - 1] == top:
            byte[N - 1] = lit[N - 1] if lmask[N - 1] else 0
        out[b] = np.where(i < prod[b], byte, 0).astype(np.uint8)
        st["rounds"].append(changed_rounds)
        st["unresolved"].append(bool(unresolved.any()))
    if stats is not None:
        stats.update(st)
    return out, prod.astype(np.int32)


def fuzz_assemble(seed: int, names=None, card: bool = False) -> dict:
    """Inputs of assemble_ops drawn from a seed, for the worst cases of
    csrc/assemble.cu and JAX's packed compaction: (tok, len, lex, lit, slot
    [B, width] int32, bit_half [B, H] uint16, n_cmds [B] int32) a pattern,
    planes as numpy arrays (a column slice is a view of a wider array).
    The draw: B = 3, Tc = 256, tok 0..2, len 0..6, lex 0..7, lit 0..255,
    slot 0..7, every plane Tc wide, 300 random halfwords of raw bits,
    n_cmds = Tc:
    - "spill_30", "spill_32", "spill_33": each block's 6th dict (slot index
      5) at slot 30, 32, 33 (a distance past 2^15; 32 and 33 also past
      2^16); "spill_many": block 0 128 dicts at slots 30..33, then reps,
      block 1 such dicts and reps alternating, block 2 the draw with one;
    - "valid": the draw with len 0..7 (escapes); "rep_first": eight reps
      before the first dict (the virtual history 1..4); "rep_runs": runs
      of 6 reps every 16 slots; "only_reps": block 0 reps only;
      "only_lits": block 1 literals only; "tok3": tok 0..3;
    - "ncmd_low", "ncmd_high": n_cmds 0, -5, Tc // 2 and Tc, Tc + 100, 7;
    - "lex_past": len 7 a third of the matches, the lex plane 16 wide;
      "bits_past": the raw bits 8 halfwords wide; "col_slice": every plane
      a column slice (stride 320) of a wider array;
    - "tc1", "tc31" (B = 3), "tc1025" (B = 2), "tc4096_b1" (B = 1; len,
      lit and slot 2048 wide, lex 512): the draw at those widths.
    card=True adds shapes past the CPU tests' 64 KiB: "spill_tc32768" (B =
    2, Tc = 32768, the widest packed plane: two chunks, a spill in the
    second and reps in the first) and "big_tc40000" (B = 2, Tc = 40000:
    three chunks; for big=True only). names: the patterns to return
    (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(B=3, Tc=256, max_len=6, tok_max=2, widths=None, H=300):
        w = {**dict(len=Tc, lex=Tc, lit=Tc, slot=Tc), **(widths or {})}
        tok = rng.integers(0, tok_max + 1, (B, Tc))
        len_ = rng.integers(0, max_len + 1, (B, w["len"]))
        lex = rng.integers(0, 8, (B, w["lex"]))
        lit = rng.integers(0, 256, (B, w["lit"]))
        slot = rng.integers(0, 8, (B, w["slot"]))
        bits = rng.integers(0, 1 << 16, (B, H))
        return [tok, len_, lex, lit, slot, bits, np.full(B, Tc)]

    def done(p):
        planes = [np.asarray(a).astype(np.int32) for a in p[:5]]
        return (*planes, np.asarray(p[5]).astype(np.uint16), np.asarray(p[6]).astype(np.int32))

    def spill(S):
        p = draw()
        p[4][:, 5] = S
        return done(p)

    def spill_many():
        p = draw()
        tok, slot = p[0], p[4]
        tok[0, :128], tok[0, 128:] = 1, 2
        slot[0, :128] = rng.integers(30, 34, 128)
        tok[1, 0::2], tok[1, 1::2] = 1, 2
        slot[1, :128] = rng.integers(30, 34, 128)
        slot[2, 9] = 33
        return done(p)

    def change(fn, **kw):
        p = draw(**kw)
        fn(p)
        return done(p)

    def rep_first(p):
        p[0][:, :8] = 2

    def rep_runs(p):
        for s in range(0, p[0].shape[1], 16):
            p[0][:, s : s + 6] = 2

    def lex_past(p):
        p[1][rng.random(p[1].shape) < 1 / 3] = 7

    def col_slice():
        p = draw()
        for i in range(5):
            wide = np.zeros((3, 320), np.int32)
            wide[:, :256] = p[i]
            wide[:, 256:] = rng.integers(0, 8, (3, 64))
            p[i] = wide[:, :256]
        tok, len_, lex, lit, slot = p[:5]
        return (tok, len_, lex, lit, slot, p[5].astype(np.uint16), p[6].astype(np.int32))

    def card_spill():
        p = draw(B=2, Tc=32768, widths=dict(lex=4096), H=20000)
        tok, slot = p[0], p[4]
        tok[:, :8] = 2  # reps of the first chunk, before any dict
        slot[:, (tok[0] == 1).sum() * 3 // 4] = 32  # a dict of the second chunk
        return done(p)

    pats = {
        **{f"spill_{s}": (lambda s=s: spill(s)) for s in (30, 32, 33)},
        "spill_many": spill_many,
        "valid": lambda: done(draw(max_len=7)),
        "rep_first": lambda: change(rep_first),
        "rep_runs": lambda: change(rep_runs),
        "only_reps": lambda: change(lambda p: p[0].__setitem__(0, 2)),
        "only_lits": lambda: change(lambda p: p[0].__setitem__(1, 0)),
        "tok3": lambda: done(draw(tok_max=3)),
        "ncmd_low": lambda: change(lambda p: p.__setitem__(6, np.array([0, -5, 128]))),
        "ncmd_high": lambda: change(lambda p: p.__setitem__(6, np.array([256, 356, 7]))),
        "lex_past": lambda: change(lex_past, max_len=7, widths=dict(lex=16)),
        "bits_past": lambda: done(draw(H=8)),
        "col_slice": col_slice,
        "tc1": lambda: done(draw(Tc=1, H=4)),
        "tc31": lambda: done(draw(Tc=31, H=40)),
        "tc1025": lambda: done(draw(B=2, Tc=1025, max_len=7, H=1200)),
        "tc4096_b1": lambda: done(draw(B=1, Tc=4096, max_len=7, H=4096,
                                       widths=dict(len=2048, lit=2048, slot=2048, lex=512))),
    }
    if card:
        pats["spill_tc32768"] = card_spill
        pats["big_tc40000"] = lambda: done(draw(B=2, Tc=40000, max_len=7, H=40000,
                                                widths=dict(lex=8192)))
    return {k: pats[k]() for k in (names or pats)}


def asm_config(Tc: int) -> tuple:
    """csrc/assemble.cu's (threads, slots a thread) for a tok width Tc
    (config_of)."""
    nt = ASM_NT_SMALL if Tc <= ASM_SMALL else ASM_NT
    spt = 1
    while spt * nt < Tc and 2 * spt * nt <= ASM_CHMAX:
        spt <<= 1
    return nt, spt


def assemble_model(tok, len_, lex, lit, slot, bit_half, n_cmds, big=False, wide_delta=True,
                   NT=None, SPT=None, stats=None):
    """numpy model of csrc/assemble.cu -> cmds [B, TP, 2] int32 (op_len,
    op_val pairs, TP = Tc rounded up to even, the padding slot -1, 0):
    chunks of NT x SPT slots (both as the kernel picks them unless given), a
    run of SPT consecutive slots a thread; scan 1 of each run's match,
    dict and literal counts and scan 2 of its escapes and raw-bit widths
    (exclusive sums in thread order, carried from chunk to chunk); the
    clamped gathers at those ranks; the chunk's dict distances by rank
    (DR), each rep's from DR or, before the chunk's first dicts, from the
    4-entry window carried from chunk to chunk (the virtual history 1..4
    at a block's start); on JAX's packed path (big false) a block with a
    dict distance outside the payload (2^15, 2^16 with wide_delta)
    resolves its reps again from flagged_block's sort of u32 keys merged
    with the Tc - n_dict fillers. stats, when given, gets per block
    "flagged" and "chunks"."""
    import numpy as np

    B, Tc = tok.shape
    TP = (Tc + 1) & ~1
    hb = bit_half.shape[1]
    if NT is None:
        NT, SPT = asm_config(Tc)
    CH = NT * SPT
    pb = 0 if big else (16 if wide_delta else 15)
    bits = bit_half.astype(np.int64) & 0xFFFF
    out = np.zeros((B, TP, 2), np.int64)
    out[:, :, 0] = -1
    wrap = lambda x: ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    mmin = lambda d: 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF)
    st = {"flagged": [], "chunks": []}

    def at(a, b, k):
        return int(a[b, min(max(k, 0), a.shape[1] - 1)])

    def fetch(b, off, width):
        if width <= 0:
            return 0
        h0 = off >> 4
        word = (int(bits[b, min(max(h0, 0), hb - 1)]) << 16) | int(bits[b, min(max(h0 + 1, 0),
                                                                                    hb - 1)])
        return ((word << (off & 15)) & 0xFFFFFFFF) >> (32 - min(width, 16))

    def ab_of(s):
        return min(max((s >> 1) - 1, 0), 16) if s >= 4 else 0

    def dict_delta(s, v):
        ab = ab_of(s)
        return (((2 + (s & 1)) << ab) + v if s >= 4 else s) + 1

    for b in range(B):
        nc = int(n_cmds[b])
        base = [0, 0, 0, 0, 0]  # match, dict, literal ranks; lex rank, bit offset
        carry = [1, 2, 3, 4]  # distances of dict ranks cb - 1 - q, the virtual history first
        flagged = False
        walk = []  # every slot's (kind, lv, d_rank, v) for flagged_block
        for c0 in range(0, Tc, CH):
            kind = np.zeros(CH, np.int64)  # 0 none, 1 literal, 2 dict, 3 rep
            g = c0 + np.arange(CH)
            t_ = np.where(g < Tc, tok[b, np.minimum(g, Tc - 1)], -1)
            live = (g < Tc) & (g < nc)
            kind[live & (t_ == 0)], kind[live & (t_ == 1)], kind[live & (t_ == 2)] = 1, 2, 3
            runs = kind.reshape(NT, SPT)
            cnt = np.stack([(runs >= 2).sum(1), (runs == 2).sum(1), (runs == 1).sum(1)], 1)
            ex = np.cumsum(cnt, 0) - cnt + np.array(base[:3])
            base[:3] = [base[i] + int(cnt[:, i].sum()) for i in range(3)]
            X = np.zeros(CH, np.int64)
            Y = np.zeros(CH, np.int64)
            f2 = np.zeros((NT, 2), np.int64)
            for t in range(NT):
                mr, dr, lr = (int(x) for x in ex[t])
                for i in range(SPT):
                    k, kd = t * SPT + i, runs[t, i]
                    if kd == 1:
                        X[k], Y[k] = 0, at(lit, b, lr)
                        lr += 1
                    elif kd == 0:
                        X[k] = 0 if live[k] else -1
                    else:
                        X[k] = at(len_, b, mr)
                        mr += 1
                        if kd == 2:
                            Y[k] = at(slot, b, dr)
                            dr += 1
                        f2[t] += (X[k] == 7, 2 if kd == 3 else ab_of(int(Y[k])))
            ex2 = np.cumsum(f2, 0) - f2 + np.array(base[3:])
            base[3:] = [base[3 + i] + int(f2[:, i].sum()) for i in range(2)]
            cb = int(ex[0, 1])  # the chunk's first dict rank
            DR = {}
            for t in range(NT):
                er, off = (int(x) for x in ex2[t])
                dr = int(ex[t, 1])
                for i in range(SPT):
                    k, kd = t * SPT + i, runs[t, i]
                    if kd < 2:
                        walk.append((kd, 0, 0, 0))
                        continue
                    ls = int(X[k])
                    lv = ls
                    if ls == 7:
                        lv = 7 + at(lex, b, er)
                        er += 1
                    if kd == 2:
                        ab = ab_of(int(Y[k]))
                        delta = dict_delta(int(Y[k]), fetch(b, off, ab))
                        off += ab
                        flagged |= pb > 0 and not 0 <= delta < 1 << pb
                        X[k], Y[k] = lv + mmin(delta), delta
                        DR[dr - cb] = delta
                        walk.append((kd, lv, dr, 0))
                        dr += 1
                    else:
                        v = fetch(b, off, 2)
                        off += 2
                        X[k], Y[k] = lv, v
                        walk.append((kd, lv, dr, v))
            for t in range(NT):
                dr = int(ex[t, 1]) - cb
                for i in range(SPT):
                    k, kd = t * SPT + i, runs[t, i]
                    if kd == 3:
                        j = dr - 1 - int(Y[k])
                        d = DR[j] if j >= 0 else carry[-1 - j]
                        X[k], Y[k] = X[k] + mmin(d), d
                    dr += kd == 2
            nd = len(DR)
            carry = [DR[nd - 1 - q] if nd > q else carry[q - nd] for q in range(4)]
            n = min(CH, TP - c0)
            out[b, c0 : c0 + n, 0] = X[:n]
            out[b, c0 : c0 + n, 1] = Y[:n]
        walk = walk[:Tc]
        if flagged:
            flip = 0x80000000 if pb == 15 else 0
            keys = [(((d_rank << pb) | (dl & 0xFFFFFFFF)) & 0xFFFFFFFF) ^ flip
                    for k, (kd, _, d_rank, _) in enumerate(walk) if kd == 2
                    for dl in [int(out[b, k, 1])]]
            S = np.sort(np.array(keys, np.int64))
            nd, fill, mask = len(keys), ((1 << (15 + pb)) ^ flip), (1 << pb) - 1
            n_lo = int((S < fill).sum())

            def D(i):
                if i < n_lo:
                    return int(S[i]) & mask
                if i < n_lo + Tc - nd:
                    return 0
                return int(S[i - (Tc - nd)]) & mask

            for k, (kd, lv, d_rank, v) in enumerate(walk):
                if kd == 3:
                    j = d_rank - 1 - v
                    d = D(j) if j >= 0 else -j
                    out[b, k] = (lv + mmin(d), d)
        st["flagged"].append(bool(flagged))
        st["chunks"].append(-(-Tc // CH))
    if stats is not None:
        stats.update(st)
    return wrap(out).astype(np.int32)


def fuzz_windows(seed: int, names=None) -> dict:
    """Inputs of stage_windows_fused drawn from a seed, for the worst cases of
    csrc/stage_windows.cu: (hw [B, H] uint16, offs [B, 5, NC] int32, ends
    [B, 5] int32, WHs) a pattern. The draw ("valid"): B = 5, NC = 6, WHs (16,
    48, 16, 8, 16), each chunk's pair count 0..WH_p, each plane's stream at
    its own base of the block's row, H their sum plus 7;
    - "offs_neg": a third of the offsets below 0; "offs_past": a third past
      H and a third within 8 of H - 1 (the clamp); "offs_down": each plane's
      offsets decreasing (negative pair counts); "offs_wrap": plane 0's
      first offset within 8 of 2^31 - 1 and its second past it, wrapped
      (the index wraps in int32, as JAX's), plane 2's fourth near -2^31;
    - "ends_low": each plane's end below its last chunk's offset;
      "count_past": pair counts up to 3 WH_p (the window cuts them);
    - "b1_nc1_h1": B = 1, NC = 1, H = 1; "widths_odd": WHs (5, 13, 7, 3, 9)
      (no 16-byte rows); "bases_odd": WHs (8, 6, 12, 8, 4) at B x NC = 15
      (planes 1 and 2 cell by cell: a width and a base off 16 bytes);
      "nc13_b7", "nc17_b2": chunk counts that leave a CTA's warps idle;
    - "big_h": B = 2, NC = 48, the shipping widths, H = 40000 (past 2^15:
      JAX's packed gather cannot take it), some offsets near H - 1.
    names: the patterns to return (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    I32 = 1 << 31

    def draw(B=5, NC=6, WHs=(16, 48, 16, 8, 16), pad=7, over=1, H=None):
        counts = np.stack([rng.integers(0, over * w + 1, (B, NC)) for w in WHs], 1)
        lens = counts.sum(2)
        base = np.concatenate([[0], np.cumsum(lens.max(0))[:-1]])
        offs = base[None, :, None] + np.cumsum(counts, 2) - counts
        ends = base[None, :] + lens
        H = H or int(lens.max(0).sum()) + pad
        return [rng.integers(0, 1 << 16, (B, H)), offs, ends, WHs]

    def done(p):
        hw, offs, ends, WHs = p
        return (np.asarray(hw).astype(np.uint16), np.asarray(offs).astype(np.int32),
                np.asarray(ends).astype(np.int32), tuple(WHs))

    def change(fn, **kw):
        p = draw(**kw)
        fn(p)
        return done(p)

    def some(a, frac=1 / 3):
        return rng.random(a.shape) < frac

    def offs_neg(p):
        o = p[1]
        m = some(o)
        o[m] = -rng.integers(1, 100, int(m.sum()))

    def offs_past(p):
        o, H = p[1], p[0].shape[1]
        r = rng.random(o.shape)
        o[r < 1 / 3] = H + rng.integers(0, 50, int((r < 1 / 3).sum()))
        near = (r >= 1 / 3) & (r < 2 / 3)
        o[near] = H - rng.integers(1, 9, int(near.sum()))

    def offs_down(p):
        o, H = p[1], p[0].shape[1]
        o[:] = -np.sort(-rng.integers(0, H, o.shape), axis=2)

    def offs_wrap(p):
        o = p[1]
        B = o.shape[0]
        o[:, 0, 0] = I32 - rng.integers(1, 9, B)
        o[:, 0, 1] = o[:, 0, 0] + rng.integers(1, 17, B) - 2 * I32
        o[:, 2, 3] = -I32 + rng.integers(0, 5, B)

    def ends_low(p):
        p[2][:] = p[1][:, :, -1] - rng.integers(1, 10, p[2].shape)

    def b1():
        offs = rng.integers(-2, 4, (1, 5, 1))
        ends = rng.integers(-2, 12, (1, 5))
        return done([rng.integers(0, 1 << 16, (1, 1)), offs, ends, (8, 8, 8, 8, 8)])

    def big_h(p):
        o, H = p[1], p[0].shape[1]
        o[:, 4, ::7] = H - rng.integers(1, 60, o[:, 4, ::7].shape)

    ship = PS_WH_SHIP
    pats = {
        "valid": lambda: done(draw()),
        "offs_neg": lambda: change(offs_neg),
        "offs_past": lambda: change(offs_past),
        "offs_down": lambda: change(offs_down),
        "offs_wrap": lambda: change(offs_wrap),
        "ends_low": lambda: change(ends_low),
        "count_past": lambda: done(draw(over=3)),
        "b1_nc1_h1": b1,
        "widths_odd": lambda: done(draw(WHs=(5, 13, 7, 3, 9))),
        "bases_odd": lambda: done(draw(B=3, NC=5, WHs=(8, 6, 12, 8, 4))),
        "nc13_b7": lambda: done(draw(B=7, NC=13)),
        "nc17_b2": lambda: done(draw(B=2, NC=17)),
        "big_h": lambda: change(big_h, B=2, NC=48, WHs=ship, H=40000),
    }
    return {k: pats[k]() for k in (names or pats)}


def windows_model(hw, offs, ends, WHs, stats=None):
    """numpy model of csrc/stage_windows.cu -> the five windows [NC, B, WH_p]
    int32: the output as one buffer, each plane's rows cut into units of 4
    cells (WH_p and the plane's base multiples of 4) or of 1; a warp per
    (block, chunk) walks the chunk's units in plane order, a unit's plane
    found by compares against the planes' first units; the chunk's offsets
    and next offsets (the stream end for the last chunk) give each plane's
    first pair and its pair count, both wrapping in int32; a cell k of a
    unit reads hw[b, clamp(first + k, 0, H - 1)] below the count and is 0
    past it. Every cell must be written exactly once. stats: units and
    cells of the 4-cell kind a chunk."""
    import numpy as np

    hw = np.asarray(hw).astype(np.int64)
    offs, ends = np.asarray(offs).astype(np.int64), np.asarray(ends).astype(np.int64)
    B, H = hw.shape
    NC = offs.shape[2]
    wrap = lambda x: ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    base, width, first, acc = [], [], [0], 0
    for w in WHs:
        base.append(acc)
        width.append(4 if w % 4 == 0 and acc % 4 == 0 else 1)
        first.append(first[-1] + w // width[-1])
        acc += NC * B * w
    u = np.arange(first[-1])
    p = sum((u >= first[q]).astype(np.int64) for q in range(1, 5))
    f, wd, wh, bs = (np.asarray(a, np.int64)[p] for a in (first[:5], width, WHs, base))
    k0 = (u - f) * wd
    out = np.zeros(acc, np.int64)
    hits = np.zeros(acc, np.int64)
    for b in range(B):
        for c in range(NC):
            o = offs[b, :, c]
            n = wrap((offs[b, :, c + 1] if c + 1 < NC else ends[b]) - o)
            dst = bs + (c * B + b) * wh + k0
            for i in range(4):
                m = i < wd
                k = k0[m] + i
                idx = np.clip(wrap(o[p[m]] + k), 0, max(H - 1, 0))
                live = (k < n[p[m]]) & (H > 0)
                out[dst[m] + i] = np.where(live, hw[b, idx] if H else 0, 0)
                np.add.at(hits, dst[m] + i, 1)
    if not (hits == 1).all():
        raise AssertionError("windows_model: a cell written other than once")
    if stats is not None:
        stats.update(units=first[-1], wide_units=int((wd == 4).sum()), widths=width)
    wins, pos = [], 0
    for w in WHs:
        n = NC * B * w
        wins.append(out[pos : pos + n].reshape(NC, B, w).astype(np.int32))
        pos += n
    return tuple(wins)


def bits_need(fields) -> int:
    """The largest n_bytes (total bits // 8 + 4) of a block of these fields."""
    import numpy as np

    nb = np.clip(np.asarray(fields[1], np.int64), 0, 24) + np.clip(
        np.asarray(fields[3], np.int64), 0, 24)
    return int(nb.sum(0).max(initial=0)) // 8 + 4


def fuzz_bits(seed: int, names=None, card: bool = False) -> dict:
    """Inputs of bits_forward drawn from a seed, for the worst cases of
    csrc/bits_forward.cu: ((va, nb_a, vb, nb_b) [T, B] int32, cap) a
    pattern, values any 32 bits. The draw: nb 0..24; "need" below is the
    largest block's n_bytes:
    - "random": T = 300, B = 9, cap need + 37; "nb_out": T = 200, B = 7, nb
      -40..60 (both clamps), cap need;
    - "straddle": T = 1100, B = 9, nb_a 24, nb_b 23 (every field crosses
      words; runs start inside words), cap need + 16; "zero_blocks": T =
      300, B = 9, blocks 0 and 3 nb 0, block 5 values 0, cap need;
    - "cap1", "cap3", "cap37": T = 150, B = 7, those caps; "cap_under",
      "cap_over": T = 256, B = 9, cap need - 1 and need + 1; "cap_max": T =
      64, B = 3, BITS_CAP_MAX (one block a CTA);
    - "b1": T = 700, B = 1; "b1023": T = 24, B = 1023.
    card=True adds tile edges of every blocks-a-CTA on a 132-SM card (G 8,
    4, 2: 1024, 2048 and 4096 steps a tile), with ragged groups:
    "tiles_b1023" (T = 2100, B = 1023), "tiles_b501" (T = 4200, B = 501),
    "tiles_b255" (T = 8300, B = 255), nb 20..24, cap need. names: the
    patterns to return (default all)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def draw(T, B, lo=0, hi=24):
        v = lambda: rng.integers(-(1 << 31), 1 << 31, (T, B))
        n = lambda: rng.integers(lo, hi + 1, (T, B))
        return [v(), n(), v(), n()]

    def done(f, cap=None, extra=0):
        f = tuple(np.asarray(a).astype(np.int32) for a in f)
        return f, (cap if cap is not None else bits_need(f) + extra)

    def straddle():
        f = draw(1100, 9)
        f[1][:], f[3][:] = 24, 23
        return done(f, extra=16)

    def zero_blocks():
        f = draw(300, 9)
        f[1][:, [0, 3]] = f[3][:, [0, 3]] = 0
        f[0][:, 5] = f[2][:, 5] = 0
        return done(f)

    def capped(T, B, delta):
        f = draw(T, B)
        return done(f, bits_need(f) + delta)

    pats = {
        "random": lambda: done(draw(300, 9), extra=37),
        "nb_out": lambda: done(draw(200, 7, -40, 60)),
        "straddle": straddle,
        "zero_blocks": zero_blocks,
        **{f"cap{c}": (lambda c=c: done(draw(150, 7), c)) for c in (1, 3, 37)},
        "cap_under": lambda: capped(256, 9, -1),
        "cap_over": lambda: capped(256, 9, 1),
        "cap_max": lambda: done(draw(64, 3), BITS_CAP_MAX),
        "b1": lambda: done(draw(700, 1)),
        "b1023": lambda: done(draw(24, 1023)),
    }
    if card:
        for T, B in ((2100, 1023), (4200, 501), (8300, 255)):
            pats[f"tiles_b{B}"] = lambda T=T, B=B: done(draw(T, B, 20, 24))
    return {k: pats[k]() for k in (names or pats)}


def bits_model(fields, cap: int, R: int = BITS_R, stats=None):
    """numpy model of csrc/bits_forward.cu -> (out [B, cap] uint8, n_bytes [B]
    int32): per block, runs of R steps; a run's first bit the sum of the
    runs' bit lengths before it; its bits built in a 64-bit accumulator,
    each whole word stored, its first (when it starts inside a word) and its
    last partial word ORed (a stored word that another run also writes
    fails the model); words past cap dropped; byte cap - 1 zeroed once full
    bytes + 4 reach cap; each row copied out from byte b * cap of a 16-byte
    aligned buffer: bytes to its first 16-byte boundary, then 16-byte
    chunks built from the words byte-swapped and funnel-shifted, then the
    tail's bytes. stats: stores and ORs of words."""
    import numpy as np

    M32, M64 = (1 << 32) - 1, (1 << 64) - 1
    va, na, vb, nb = (np.asarray(f).astype(np.int64) for f in fields)
    T, B = na.shape
    nw = (cap + 3) // 4
    SW = (nw + 1) | 1
    out = np.zeros((B, cap), np.uint8)
    n_bytes = np.zeros(B, np.int32)
    st = dict(stores=0, ors=0)
    for b in range(B):
        nx, ny = np.clip(na[:, b], 0, 24), np.clip(nb[:, b], 0, 24)
        x = [int(v) for v in (va[:, b] & M32) & ((1 << nx) - 1)]
        y = [int(v) for v in (vb[:, b] & M32) & ((1 << ny) - 1)]
        nx, ny = [int(v) for v in nx], [int(v) for v in ny]
        words = [0] * SW
        writers, stored = {}, set()

        def emit(w, word, shared, r):
            if w >= nw:
                return
            writers.setdefault(w, set()).add(r)
            if shared:
                words[w] |= word
                st["ors"] += 1
            else:
                words[w] = word
                stored.add(w)
                st["stores"] += 1

        off = 0
        for r, t0 in enumerate(range(0, T, R)):
            steps = range(t0, min(T, t0 + R))
            s = sum(nx[t] + ny[t] for t in steps)
            if s:
                w, used, head, acc = off >> 5, off & 31, (off & 31) != 0, 0
                for t in steps:
                    for v, n in ((x[t], nx[t]), (y[t], ny[t])):
                        acc |= (v << ((64 - used - n) & 63)) & M64
                        used += n
                        if used >= 32:
                            emit(w, acc >> 32, head, r)
                            head, acc, used, w = False, (acc << 32) & M64, used - 32, w + 1
                if used:
                    emit(w, acc >> 32, True, r)
            off += s
        if any(len(writers[w]) != 1 for w in stored):
            raise AssertionError("bits_model: a stored word holds another run's bits")
        full = off >> 3
        n_bytes[b] = full + 4
        if full + 4 >= cap:
            i = cap - 1
            words[i >> 2] &= ~(0xFF << (24 - 8 * (i & 3))) & M32
        wd = np.asarray(words, np.uint64)
        byte_of = lambda i: ((wd[i >> 2] >> (24 - 8 * (i & 3)).astype(np.uint64)) & 0xFF)
        h = min((16 - (b * cap) % 16) % 16, cap)
        nchunk = (cap - h) >> 4
        tail = h + 16 * nchunk
        edge = np.r_[np.arange(h), np.arange(tail, cap)]
        out[b, edge] = byte_of(edge).astype(np.uint8)
        if nchunk:
            i = h + 16 * np.arange(nchunk)
            sh = (8 * (i & 3)).astype(np.uint64)
            bs = np.asarray(words, np.uint32).byteswap().astype(np.uint64)  # bytes in order
            for k in range(4):
                lo, hi = bs[(i >> 2) + k], bs[(i >> 2) + k + 1]
                o = (((hi << np.uint64(32)) | lo) >> sh) & np.uint64(M32)
                for j in range(4):
                    out[b, i + 4 * k + j] = ((o >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(
                        np.uint8)
    if stats is not None:
        stats.update(st)
    return out, n_bytes


def ps_quot(n, d):
    """csrc/plane_scan.cu's quot: floor(n / d) for 0 <= n < 2^31 and d >= 1,
    as the multiply-high of n by floor((2^32 - 1) / d) and one correction
    (uint64 arrays)."""
    import numpy as np

    n, d = np.asarray(n, np.uint64), np.asarray(d, np.uint64)
    q = (n * (np.uint64(0xFFFFFFFF) // d)) >> np.uint64(32)
    return q + (n - q * d >= d)


def ps_fences(car, A: int):
    """The kernel's rebuild: fences [B, A + 1] (int64) from carries [B, A]:
    freq = 1 + ps_quot(carry * (2^14 - A), tot + 1), fences the exclusive
    sums with the last pinned at 2^14."""
    import numpy as np

    B = car.shape[0]
    fr = 1 + ps_quot(car * (PS_CDF - A), car.sum(1, keepdims=True) + 1).astype(np.int64)
    fen = np.zeros((B, A + 1), np.int64)
    fen[:, 1:A] = np.cumsum(fr, 1)[:, :-1]
    fen[:, A] = PS_CDF
    return fen


def ps_bitmap(fen, A: int):
    """The kernel's search table (count, bits) [B, 512]: bit v & 31 of word
    v >> 5 set for each fence 1..A-1 at value v, count the fences before the
    word (an exclusive sum of the words' popcounts)."""
    import numpy as np

    B = fen.shape[0]
    bits = np.zeros((B, PS_CDF // 32), np.uint64)
    v = fen[:, 1:A]
    np.bitwise_or.at(bits, (np.repeat(np.arange(B), A - 1), (v >> 5).reshape(-1)),
                     (np.uint64(1) << (v & 31).astype(np.uint64)).reshape(-1))
    pop = ps_popc(bits)
    return np.cumsum(pop, 1) - pop, bits


def ps_popc(v):
    """Set bits of each value of a uint64 array below 2^32 (int64)."""
    import numpy as np

    return np.unpackbits(np.asarray(v, "<u8")[..., None].view(np.uint8), axis=-1).sum(
        -1, dtype=np.int64)


def scan_model(seeds, wins, n_syms, steps: int, priors=None, stats=None):
    """A numpy model of csrc/plane_scan.cu's scheme, five int32 [B, steps *
    L_p] (wire order) as plane_scan_fused. Each plane apart (PS_SLOTS),
    each block to its own live steps ceil(n_sym / L) (0..steps), zeros past
    them. Lane 2t + j of a 64-lane plane is thread t's j-th, and its renorm
    rank the popc of the plane's ballots below it. A renorm pair at index h
    of the chunk is the ring's (the row's first min(WH_p, PS_MAX_CLEN L_p)
    ints) or else JAX's (the chunk's rows concatenated in wire order,
    zero-padded to a multiple of 64, h clamped). tok and len: fences in
    every lane, counts in 8-bit fields of a thread summed in 16-bit halves
    every PS_MAX_CLEN steps; dst, lit and lex: the fence bitmap (ps_bitmap),
    a symbol the count before f's word plus the word's bits up to f, counts
    one at a time. Tables rebuilt (ps_fences) only while a block's steps
    remain. stats, a dict, gets per wire plane its live steps a block
    ("live"), pairs read from the ring ("ring") and at JAX's index
    ("jax_index"; "padding": of those, in the zero padding), and searches
    whose word held more than one fence ("dense")."""
    import numpy as np

    from nlzm_tpu_torch.format.wide import chunk_schedule

    seeds = np.asarray(seeds).view(np.uint32).astype(np.uint64)
    n_syms = np.asarray(n_syms, np.int64)
    B = seeds.shape[0]
    NC = len(chunk_schedule(steps))
    WHs = [int(w.shape[2]) for w in wins]
    base = np.cumsum([0] + WHs)[:5]
    cat = np.concatenate([np.asarray(w, np.int64) for w in wins]
                         + [np.zeros((NC, B, -sum(WHs) % 64), np.int64)], axis=2)
    WHc = cat.shape[2]
    M32 = np.uint64(0xFFFFFFFF)
    bi = np.arange(B)[:, None]
    outs = [None] * 5
    lane0 = 0
    for L, A, p in PS_SLOTS:
        LPT = 2 if L == 64 else 1
        nthr = L // LPT
        n = n_syms[:, p]
        live = np.where(n <= 0, 0, np.minimum(steps, (np.maximum(n, 1) - 1) // L + 1))
        last_n = np.minimum(L, n - (np.maximum(live, 1) - 1) * L)
        x = seeds[:, lane0 : lane0 + L].copy()
        lane0 += L
        car = (np.zeros((B, A), np.int64) if priors is None
               else np.broadcast_to(np.asarray(priors[p], np.int64), (B, A)).copy())
        if priors is None:
            fen = np.broadcast_to(np.append(np.arange(A) * (PS_CDF // A), PS_CDF),
                                  (B, A + 1)).copy()
        else:
            fen = ps_fences(car, A)
        cnt_t, bits_t = ps_bitmap(fen, A)
        out = np.zeros((B, steps, L), np.int32)
        ncopy = min(WHs[p], PS_MAX_CLEN * L)
        st_p = dict(live=live.tolist(), ring=0, jax_index=0, padding=0, dense=0)
        lanes = np.arange(L)
        s = 0
        for c, clen in enumerate(chunk_schedule(steps)):
            if s >= live.max(initial=0):
                break
            cnt = np.zeros((B, A), np.int64)
            rel = np.zeros((B, 1), np.int64)
            pk = np.zeros((B, nthr), np.uint64)  # tok, len: 8-bit fields a thread
            for i in range(clen):
                f = (x & np.uint64(0x3FFF)).astype(np.int64)
                if A <= 8:
                    y = (f[:, :, None] >= fen[:, None, 1:A]).sum(2)
                else:
                    w = f >> 5
                    word = bits_t[bi, w]
                    y = cnt_t[bi, w] + ps_popc(word & ((np.uint64(2) << (f & 31).astype(np.uint64))
                                                       - np.uint64(1)))
                    st_p["dense"] += int(((ps_popc(word) > 1) & (s < live[:, None])).sum())
                st = fen[bi, y]
                fr = fen[bi, y + 1] - st
                x2 = (fr.astype(np.uint64) * (x >> np.uint64(14))
                      + (f - st).astype(np.uint64)) & M32
                act = (s < live[:, None] - 1) | ((s == live[:, None] - 1)
                                                   & (lanes < last_n[:, None]))
                ren = act & (x2 < np.uint64(1 << 16))
                R = ren.reshape(B, nthr, LPT).astype(np.int64)
                below = np.cumsum(R.sum(2), 1) - R.sum(2)  # popc of the ballots below
                rank = (below[:, :, None] + np.cumsum(R, 2) - R).reshape(B, L)
                h = rel + rank
                ring = (np.asarray(wins[p][c], np.int64)[bi, np.minimum(h, ncopy - 1)] if ncopy
                        else np.zeros_like(h))
                jax_h = np.minimum(base[p] + h, WHc - 1)
                far = cat[c][bi, np.maximum(jax_h, 0)] if WHc else np.zeros_like(h)
                pair = np.where(h < ncopy, ring, far).astype(np.uint64)
                st_p["ring"] += int((ren & (h < ncopy)).sum())
                st_p["jax_index"] += int((ren & (h >= ncopy)).sum())
                st_p["padding"] += int((ren & (h >= ncopy) & (jax_h >= sum(WHs))).sum())
                x = np.where(ren, ((x2 << np.uint64(16)) | pair) & M32, np.where(act, x2, x))
                rel = rel + ren.sum(1, keepdims=True)
                y = np.where(act, y, 0)
                if A <= 8:
                    one = np.where(act, np.uint64(1) << (np.uint64(8) * y.astype(np.uint64)),
                                   np.uint64(0))
                    pk += one.reshape(B, nthr, LPT).sum(2, dtype=np.uint64)
                    if (i + 1) % PS_MAX_CLEN == 0 or i + 1 == clen:
                        for w in range(A // 4):
                            v = (pk >> np.uint64(32 * w)) & M32
                            ev = (v & np.uint64(0x00FF00FF)).sum(1)
                            od = ((v >> np.uint64(8)) & np.uint64(0x00FF00FF)).sum(1)
                            lo16, hi16 = np.uint64(0xFFFF), np.uint64(16)
                            for k, part in ((0, ev & lo16), (1, od & lo16), (2, ev >> hi16),
                                            (3, od >> hi16)):
                                cnt[:, 4 * w + k] += part.astype(np.int64)
                        pk[:] = 0
                else:
                    np.add.at(cnt, (np.broadcast_to(bi, y.shape)[act], y[act]), 1)
                out[:, s] = np.where(s < live[:, None], y, 0)
                s += 1
                if s >= live.max(initial=0):
                    break
            more = s < live  # blocks whose tables are rebuilt for the next chunk
            car = np.where(more[:, None], (car >> 1) + cnt, car)
            fen = np.where(more[:, None], ps_fences(car, A), fen)
            cnt_t, bits_t = ps_bitmap(fen, A)
        outs[p] = out.reshape(B, steps * L)
        if stats is not None:
            stats[p] = st_p
    return tuple(outs)


_LAST_EMIT = [time.perf_counter()]


def emit(obj) -> None:
    """Print obj as one JSON line; a phase line also gets phase_seconds, the
    host seconds since the line before it."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_seconds": now - _LAST_EMIT[0]}
    _LAST_EMIT[0] = now
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def best_ms(fn, reps: int) -> float:
    """Best of `reps` CUDA-event timings of fn(), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching tensors (or tuples of them);
    raises on a shape or dtype mismatch."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want, strict=True))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
                             f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Tally:
    """Per kernel: max |err| against the plain version, summed kernel and
    plain ms, and summed bound inputs (bytes moved, operations)."""

    def __init__(self):
        self.k = {}

    def hold(self, name, kernel, plain, reps=KERNEL_REPS, reps_plain=KERNEL_REPS,
             work=(0, 0), timed=True):
        """Compare kernel() with plain() exactly; then time both (the
        comparison call is their warm-up). reps_plain=0 times the plain
        version on its comparison call, cold, and calls it no more: for
        the step loops of a second or more a call. work = (bytes, ops)."""
        got = kernel()
        plain_ms, want = timed_call(plain)
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        r = self.k.setdefault(name, dict(max_abs_err=0, ms=0.0, plain_ms=0.0, bytes=0, ops=0))
        if timed:
            r["ms"] += timed_mean(kernel, reps)
            r["plain_ms"] += timed_mean(plain, reps_plain) if reps_plain else plain_ms
            r["bytes"] += work[0]
            r["ops"] += work[1]
        return want

    def summary(self, names):
        return {n: self.k[n] for n in names}


def timed_call(fn):
    """(CUDA-event ms, result) of one call of fn()."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1), out


def timed_mean(fn, reps: int) -> float:
    """CUDA-event mean of reps back-to-back calls, no extra warm-up."""
    import torch

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(work_bytes: int, ops: int):
    """(least ms for the work on the card, what bounds it): bytes over the
    HBM rate against operations over the int32 peak."""
    t_bytes = work_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stage(container: bytes, device):
    """Parse a wide container and stage its buckets on `device` as the
    decode path does: (info, [(staged, block_index_list)])."""
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import block_payloads, parse_container

    info = parse_container(container)
    return info, wd.stage_buckets(block_payloads(container, info), info.wide_priors,
                                  info.total_reads, wd.dict_tensor(info.dictionary, device),
                                  device=device)


def expand_work(op_len, block_size, rounds_hint, dict_arr):
    """lz_expand's (bytes, ops): command arrays in, bytes and counts out;
    ~10 operations per position for its parent and byte, 3 per doubling
    round of the hint (without one, the rounds the data needs are not
    known here and not counted: a lower bound)."""
    T, B = op_len.shape
    rounds = rounds_hint or 0
    byts = 2 * T * B * 4 + (0 if dict_arr is None else dict_arr.numel()) + B * block_size + 4 * B
    return byts, B * block_size * (10 + 3 * rounds)


def check_kernels(tally: Tally, buckets, block_size: int):
    """Each wide-path kernel against its plain version on the same device
    tensors, bucket by bucket (times summed over buckets)."""
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    for staged, _ in buckets:
        sw = (staged["hw_cat"], staged["offs"], staged["ends"], staged["WHs"])
        wins = tally.hold("stage_windows", lambda: wd.stage_windows_fused(*sw),
                          lambda: wd.stage_windows_fused_ref(*sw), work=sw_work(sw))
        ps = (staged["seeds_cat"], wins, staged["n_sym"], staged["steps"], staged["priors"])
        # the main path's entry: the container's u16 priors are not checked,
        # and come staged in slot order
        ys = tally.hold("plane_scan", lambda: wd._plane_scan_fused(*ps, staged["slot_priors"]),
                        lambda: wd.plane_scan_fused_ref(*ps), reps_plain=2, work=ps_work(ps))
        if block_size <= wd.CAP15:
            ys = tuple(a[:, : min(a.shape[1], wd.CAP15)] for a in ys)
        tok_y, lit_y, len_y, lex_y, slot_y = ys
        asm = (tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
               staged["n_sym"][:, 0].contiguous(), block_size > wd.CAP15,
               staged["dict_arr"] is not None)
        Tc = tok_y.shape[1]
        # the main path's entries: commands as [B, TP] pairs, no transpose
        cmds = tally.hold("assemble", lambda: wd._assemble_rows(*asm),
                          lambda: wd._rows_of(*wd.assemble_ops_ref(*asm)), work=asm_work(asm))
        op_len, op_val = (cmds[:, :Tc, i].t().contiguous() for i in (0, 1))
        ex = (op_len, op_val, block_size, staged["rounds_hint"], staged["dict_arr"])
        tally.hold("lz_expand", lambda: xo._lz_expand_rows(cmds, Tc, *ex[2:]),
                   lambda: xo.lz_expand_parallel_ref(*ex),
                   work=expand_work(op_len, block_size, staged["rounds_hint"], staged["dict_arr"]))
        hold_low_hints(tally, op_len, op_val, block_size, staged["dict_arr"])


def hold_low_hints(tally: Tally, op_len, op_val, block_size: int, dict_arr):
    """lz_expand at round hints 0 and 1, below the chain depth: parents
    stay unresolved, and the kernel must fill them as the plain version
    (and the JAX one) do. Untimed."""
    from nlzm_tpu_torch.ops import expand_ops as xo

    for hint in (0, 1):
        lo = (op_len, op_val, block_size, hint, dict_arr)
        tally.hold("lz_expand", lambda: xo.lz_expand_parallel(*lo),
                   lambda: xo.lz_expand_parallel_ref(*lo), timed=False)


def check_frontier_hints(tally: Tally, container: bytes, device) -> dict:
    """hold_low_hints on the frontier buckets (128 KiB blocks with a
    dictionary: the JAX 2-operand path), commands from the kernels; there
    plane_scan held against its plain version, untimed in the tally, and
    timed apart. Returns {label: ps_timing}."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    info, buckets = stage(container, device)
    timing = {}
    for i, (staged, _) in enumerate(buckets):
        ps = ps_args(staged)
        tok_y, lit_y, len_y, lex_y, slot_y = tally.hold(
            "plane_scan", lambda: wd.plane_scan_fused(*ps), lambda: wd.plane_scan_fused_ref(*ps),
            timed=False)
        timing[f"frontier_b{i}"] = ps_timing(ps)
        op_len, op_val = wd.assemble_ops(tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
                                         staged["n_sym"][:, 0].contiguous(), True)
        hold_low_hints(tally, op_len, op_val, info.block_size, staged["dict_arr"])
    return timing


def fsm_work(streams, op_len, op_val, reads: int):
    """fsm_decode's (bytes, ops) on one bucket: streams in, command arrays
    out; per taken CDF read 17 fences x 4 operations (compare, adapt)
    and ~8 of rANS state, per command ~32 of bits, rep table and emit.

    Taken reads, from the commands: a literal 3, a match 2, +2 with a
    length escape, +2 for a dictionary distance. The commands do not tell
    a dictionary match from a rep one; `reads` (the bucket's container
    read counts: CDF reads plus raw-bit reads) gives X = dict + bit reads
    of dictionary matches, at most 2 each, so at least ceil(X / 3)
    dictionary matches are counted: a lower bound."""
    import torch

    lit = op_len == 0
    match = op_len > 0
    d = op_val.long()
    mmin = 2 + (d > 0xFF).long() + (d > 0xFFF).long() + (d > 0xFFFFF).long()
    esc = match & (op_len.long() - mmin >= 7)
    n_lit, n_match, n_esc = (int(torch.count_nonzero(x)) for x in (lit, match, esc))
    x = reads - 3 * n_lit - 3 * n_match - 2 * n_esc
    cdf_reads = 3 * n_lit + 2 * n_match + 2 * n_esc + 2 * -(-max(x, 0) // 3)
    return nbytes(streams, op_len, op_val), cdf_reads * (4 * 17 + 8) + (n_lit + n_match) * 32


def check_kernels_v1(tally: Tally, buckets, info):
    """fsm_decode and lz_expand against their plain versions on the v1
    buckets (the plain fsm, one step's CUDA graph replayed for some ten
    seconds, timed on its comparison call);
    then fsm_decode on hostile streams made from the first bucket
    (untimed). Returns the hostile streams' shape."""
    import torch

    from nlzm_tpu_torch.ops import decode_v2 as dv
    from nlzm_tpu_torch.ops import expand_ops as xo

    block_size = info.block_size
    for streams, num_steps, idx in buckets:
        op_len, op_val = dv.fsm_decode_v2(streams, num_steps)  # for the work count
        work = fsm_work(streams, op_len, op_val, sum(info.total_reads[b] for b in idx))
        op_len, op_val = tally.hold(
            "fsm_decode", lambda: dv.fsm_decode_v2(streams, num_steps),
            lambda: dv.fsm_decode_v2_ref(streams, num_steps), reps=FSM_REPS, reps_plain=0,
            work=work)
        ex = (op_len, op_val, block_size)
        tally.hold("lz_expand_v1", lambda: xo.lz_expand_parallel(*ex),
                   lambda: xo.lz_expand_parallel_ref(*ex), reps_plain=3,
                   work=expand_work(op_len, block_size, None, None))
    arr = buckets[0][0].cpu().numpy()
    for seed in HOSTILE_SEEDS:
        bad = torch.as_tensor(hostile_streams(arr, seed), device=buckets[0][0].device)
        tally.hold("fsm_decode", lambda: dv.fsm_decode_v2(bad, HOSTILE_STEPS),
                   lambda: dv.fsm_decode_v2_ref(bad, HOSTILE_STEPS), timed=False)
    return {"blocks": arr.shape[0], "steps": HOSTILE_STEPS, "seeds": list(HOSTILE_SEEDS)}


def fsm_timing(buckets, num_cmds) -> list:
    """fsm_decode's CUDA-event mean on each (streams, num_steps, idx)
    bucket, with its steps, the serial chain of its longest block (its
    commands and the terminator step) and ns a step of that chain."""
    from nlzm_tpu_torch.ops import decode_v2 as dv

    out = []
    for streams, num_steps, idx in buckets:
        ms = timed_mean(lambda: dv.fsm_decode_v2(streams, num_steps), FSM_REPS)
        chain = max(num_cmds[b] for b in idx) + 1
        out.append({"blocks": len(idx), "num_steps": num_steps, "chain": chain, "ms": ms,
                    "ns_per_step": ms * 1e6 / chain})
    return out


def counters():
    from nlzm_tpu_torch.ops import decode_v2 as dv
    from nlzm_tpu_torch.ops import encode_ops as eo
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.ops import wide_encode_dev as we
    from nlzm_tpu_torch.research import huff0, ppm_tpu

    return {
        "stage_windows": wd.stage_windows_fused,
        "plane_scan": wd.plane_scan_fused,
        "assemble": wd.assemble_ops,
        "lz_expand": xo.lz_expand_parallel,
        "fsm_decode": dv.fsm_decode_v2,
        "find_matches": eo.find_matches,
        "greedy_cover": eo.greedy_cover,
        "repify": eo.repify,
        "plane_encode": we.plane_encode,
        "emit_model": eo.emit_model,
        "rans_backward": eo.rans_backward,
        "bits_forward": eo.bits_forward,
        "dp_parse": eo.dp_parse,
        "dp_cover": eo.dp_cover,
        "measure_costs": eo.measure_costs,
        "plane_decode": wd.plane_scan,
        "huff_scan": huff0._huff_scan,
        "ppm_decode": ppm_tpu._decode_blocks,
    }


def launched(label: str, need, run):
    """run() with every launch count set to 0 just before and read just
    after; fails unless every kernel in `need` launched. Returns (run's
    result, the counts)."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    res = run()
    launches = {n: fn.launches for n, fn in fns.items()}
    missing = [n for n in need if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched on the main path: {missing}")
    return res, launches


def decode_path(label: str, data: bytes, container: bytes, card: str, device, need,
                staged_run=None) -> dict:
    """Decode on `device` through launched(); check the bytes; time the
    decode (and staged_run(), the device pipeline over buckets already on
    the card, when given). Returns the counts."""
    from nlzm_tpu_torch.parallel.blocks import decode_container, parse_container

    out, launches = launched(label, need, lambda: decode_container(container, device=device))
    if out != data:
        raise AssertionError(f"{label}: decoded bytes differ from the input")

    e2e = best_ms(lambda: decode_container(container, device=device), REPS)
    info = parse_container(container)
    line = {
        "phase": label, "ok": True, "bytes": len(data), "container_bytes": len(container),
        "blocks": len(info.comp_sizes), "launches": launches,
        "e2e_ms": e2e, "e2e_MBps": len(data) / e2e / 1e3,
    }
    if staged_run is not None:
        dev_ms = best_ms(staged_run, REPS)
        line.update(staged_ms=dev_ms, staged_MBps=len(data) / dev_ms / 1e3)
    line.update(timing=f"CUDA events, best of {REPS}", card=card)
    emit(line)
    return launches


def corrupt_copy(container: bytes) -> bytes:
    """The wide container with the first tok-plane renorm pair of block 0
    flipped (the live-stream flip of tests/test_dict.py)."""
    from nlzm_tpu_torch.format.wide import HDR_BYTES, N_PLANES, PLANES, chunk_schedule, padded_steps
    from nlzm_tpu_torch.parallel.blocks import block_payloads, parse_container

    info = parse_container(container)
    payload = block_payloads(container, info)[0]
    tables = 0
    for i in range(N_PLANES):
        sym_count = int.from_bytes(payload[8 * i : 8 * i + 4], "big")
        tables += 2 * (len(chunk_schedule(padded_steps(sym_count, PLANES[i].lanes))) - 1)
    blob = bytearray(container)
    blob[info.payload_off + HDR_BYTES + tables + 4 * PLANES[0].lanes] ^= 0xFF
    return bytes(blob)


def expect_integrity_error(label, bad: bytes, good: bytes, data: bytes, device):
    from nlzm_tpu_torch.parallel.blocks import IntegrityError, decode_container

    try:
        decode_container(bad, device=device)
    except IntegrityError as e:
        caught = str(e)
    else:
        raise AssertionError(f"{label}: corrupt container decoded without IntegrityError")
    if decode_container(good, device=device) != data:
        raise AssertionError(f"{label}: valid decode after the corrupt one failed")
    emit({"phase": label, "ok": True, "raised": caught})


def run_wide(tally: Tally, data: bytes, device, card: str):
    """Phases 3-6; returns (the shipping container, main-path launches,
    plane_scan's timings on the frontier buckets, the frontier container)."""
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import encode_container

    t0 = time.perf_counter()
    container = encode_container(data, parser="optimal", profile="wide", **SHIP)
    encode_s = time.perf_counter() - t0
    info, buckets = stage(container, device)
    check_kernels(tally, buckets, info.block_size)
    emit({"phase": "kernels", "ok": True, "encode_s": encode_s,
          "buckets": [len(idx) for _, idx in buckets], "kernels": tally.summary(WIDE_KERNELS),
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls (plain "
                    f"plane_scan: 2) per bucket, summed over buckets", "card": card})

    def staged_run():
        for staged, _ in buckets:
            wd.decode_wide_staged(staged, info.block_size)

    launches = decode_path("e2e_ship", data, container, card, device, WIDE_KERNELS, staged_run)
    del buckets

    fdata = data[:FRONTIER_BYTES]
    fcont = encode_container(fdata, parser="optimal", profile="wide", **FRONTIER)
    decode_path("e2e_frontier", fdata, fcont, card, device, WIDE_KERNELS)
    frontier_ps = check_frontier_hints(tally, fcont, device)

    expect_integrity_error("corrupt", corrupt_copy(container), container, data, device)
    return container, launches, frontier_ps, fcont


def run_v1(tally: Tally, data: bytes, device, card: str):
    """Phases 7-11; returns (the bench v1 container, main-path launches, the
    512 KiB container)."""
    from nlzm_tpu_torch.ops.decode_v2 import fsm_decode_v2
    from nlzm_tpu_torch.parallel.blocks import (
        block_payloads, decode_v1_staged, encode_container, parse_container, stage_v1_buckets,
        stage_v1_payloads)

    t0 = time.perf_counter()
    container = encode_container(data, **V1_BENCH)
    encode_s = time.perf_counter() - t0
    info = parse_container(container)
    cli_data = data[:V1_CLI_BYTES]
    cli_c = encode_container(cli_data, **V1_CLI)
    cli_info = parse_container(cli_c)
    buckets = stage_v1_buckets(container, info, device=device)
    hostile = check_kernels_v1(tally, buckets, info)
    # fsm_decode at the bench buckets, one 2 MiB bucket of the file decode
    # and the CLI default's buckets
    nb = STREAM_BUCKET // info.block_size
    file_bucket = stage_v1_payloads(block_payloads(container, info)[:nb], info.num_cmds[:nb],
                                    device=device)
    shapes = {"bench": fsm_timing(buckets, info.num_cmds),
              "file_bucket": fsm_timing(file_bucket, info.num_cmds),
              "cli": fsm_timing(stage_v1_buckets(cli_c, cli_info, device=device),
                                cli_info.num_cmds)}
    emit({"phase": "kernels_v1", "ok": True, "encode_s": encode_s,
          "buckets": [len(idx) for _, _, idx in buckets],
          "num_steps": [s for _, s, _ in buckets], "max_cmds": max(info.num_cmds),
          "kernels": tally.summary(("fsm_decode", "lz_expand_v1")), "hostile": hostile,
          "fsm_decode_shapes": shapes,
          "timing": f"CUDA events; fsm_decode: mean of {FSM_REPS} calls, plain once (its "
                    f"comparison call past 1 s; one step's CUDA graph, captured, replayed); "
                    f"lz_expand: mean of {KERNEL_REPS}, plain of 3",
          "card": card})

    def staged_run():
        for streams, num_steps, _ in buckets:
            decode_v1_staged(streams, num_steps, info.block_size)

    launches = decode_path("e2e_v1_bench", data, container, card, device, V1_KERNELS,
                           staged_run)
    del buckets

    decode_path("e2e_v1_cli", cli_data, cli_c, card, device, V1_KERNELS)

    big = data[:V1_BIG_BYTES]
    big_c = encode_container(big, **V1_BIG)
    decode_path("e2e_v1_512k", big, big_c, card, device, V1_KERNELS)
    big_info = parse_container(big_c)
    for streams, num_steps, _ in stage_v1_buckets(big_c, big_info, device=device):
        op_len, op_val = fsm_decode_v2(streams, num_steps)
        hold_low_hints(tally, op_len, op_val, big_info.block_size, None)

    bad = bytearray(container)
    bad[info.payload_off + info.comp_sizes[0] // 2] ^= 0x40  # mid-payload bit
    expect_integrity_error("corrupt_v1", bytes(bad), container, data, device)
    return container, launches, big_c


def bench_commands(data: bytes):
    """The bench's device-encode input (bench.py:299-340): native parse,
    depth lift and rep classification at 32 KiB blocks, [T, B] int32."""
    import numpy as np

    from nlzm_tpu_torch import native

    op_len, op_val = native.parse_blocks(data, ENC_GREEDY["block_size"], ENC_HIST_BITS)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    native.lift_deep(op_len, op_val, ENC_GREEDY["block_size"])
    return op_len, op_val, native.classify_reps(op_len, op_val)


def plane_work(args):
    """plane_encode's (bytes, ops) for one plane: symbols, counts and
    priors in, seeds, pairs and mask out; per live symbol ~6 operations
    forward (lookup, count) and ~30 backward (u32 division and remainder,
    renorm test, state update); per chunk, block and table entry ~4 to
    rebuild."""
    from nlzm_tpu_torch.format.wide import PLANES, chunk_schedule

    syms, rows, n_sym, idx, steps, prior = args
    spec = PLANES[idx]
    B = n_sym.shape[0]
    K = steps * spec.reads * spec.lanes
    ins = nbytes(*syms, *rows, n_sym, *(prior or ()))
    outs = B * spec.lanes * 4 + B * K * 5
    table = sum(spec.rows[r] * spec.alphabets[r] for r in range(spec.reads))
    live = int(n_sym.long().sum()) * spec.reads
    return ins + outs, live * 36 + len(chunk_schedule(steps)) * B * table * 4


def pe_work(staged):
    """plane_encode_planes' (bytes, ops): plane_work summed over its planes."""
    works = [plane_work(a) for a in staged]
    return sum(w[0] for w in works), sum(w[1] for w in works)


def pe_inputs(data: bytes, device):
    """plane_encode_planes' inputs, [(label, staged planes)]: the bench's
    commands (8 MB at 32 KiB blocks, bench_commands) with and without
    priors ("ship", "ship_no_priors"), and 1 MiB of random bytes at 128 KiB
    blocks (WIDE_MAX_BLOCK), all literals but a few matches by chance, with
    and without priors ("all_literal_128k", "all_literal_128k_no_priors":
    its lit plane, 2048 steps, takes the large path)."""
    import numpy as np

    from nlzm_tpu_torch import native
    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    out = []
    batched = wide.batch_plane_arrays(*bench_commands(data))[1]
    priors = wide.build_priors_from_batched(batched)
    for label, pri in (("ship", priors), ("ship_no_priors", None)):
        out.append((label, [we.stage_plane(batched, pri, i, device) for i in range(wide.N_PLANES)]))
    rnd = np.random.default_rng(3).integers(0, 256, 8 * PE_BIG_BLOCK, dtype=np.uint8).tobytes()
    op_len, op_val = native.parse_blocks(rnd, PE_BIG_BLOCK, 17)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    native.lift_deep(op_len, op_val, PE_BIG_BLOCK)
    big = wide.batch_plane_arrays(op_len, op_val, native.classify_reps(op_len, op_val))[1]
    bpri = wide.build_priors_from_batched(big)
    for label, pri in (("all_literal_128k", bpri), ("all_literal_128k_no_priors", None)):
        out.append((label, [we.stage_plane(big, pri, i, device) for i in range(wide.N_PLANES)]))
    return out


def pe_shape(staged) -> dict:
    """csrc/plane_encode.cu's launch for the planes `staged` on this card
    (nlzm_plane_encode_shape): CTAs, threads, dynamic shared bytes,
    registers a thread, resident CTAs an SM, waves, the large planes and
    their scratch bytes."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.format.wide import PLANES
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    plan, smem, scratch = we.launch_plan([(PLANES[a[3]], a[4], a[2].shape[0]) for a in staged])
    out = (ctypes.c_int * 4)()
    st = _build.entry("plane_encode", "nlzm_plane_encode_shape", 1, 1)(
        ctypes.addressof(out), smem, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_plane_encode_shape: CUDA error {st}")
    regs, ctas, sms, threads = out
    grid = sum(a[2].shape[0] for a in staged)
    return dict(ctas=grid, threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                waves=-(-grid // (ctas * sms)) if ctas else None,
                large=[PLANES[staged[i][3]].name for i, _, large, _ in plan if large],
                scratch_bytes=scratch)


def pe_timing(staged) -> dict:
    """plane_encode_planes on `staged` through the device encodes' entry
    (priors checked by stage_plane on the host): ms (CUDA events, mean of
    KERNEL_REPS calls), device ms a launch (torch.profiler), the bound
    and the launch shape."""
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    fn = lambda: we._plane_encode_planes(staged)
    return dict(ms=timed_mean(fn, KERNEL_REPS), device_ms=kernel_device_ms(fn, "plane_encode"),
                bound_ms=bound(*pe_work(staged))[0], shape=pe_shape(staged))


def check_kernels_enc(tally: Tally, data: bytes, device):
    """The four encode kernels against their plain versions at the 8 MB,
    32 KiB-block shapes: find_matches with 1 and 3 candidates, greedy_cover
    and repify on its output, plane_encode_planes on pe_inputs (the five
    planes in one launch; the shipping planes also one at a time),
    plane_encode on a synthetic 4-row plane, and its large path on a
    synthetic two-read plane (check_pe_large)."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops import encode_ops as eo
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    N = ENC_GREEDY["block_size"]
    arr, nv = eo._blocks_arrays(data, N)
    dt, nvt = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    B = dt.shape[0]
    reach = (1 << ENC_HIST_BITS) - 1
    delta, mlen = eo.find_matches(dt, nvt, reach)  # for the work count
    delta, mlen = tally.hold("find_matches", lambda: eo.find_matches(dt, nvt, reach),
                             lambda: eo.find_matches_ref(dt, nvt, reach), reps_plain=3,
                             work=fm_work(dt, nvt, delta, mlen))
    d3, m3 = eo.find_matches(dt, nvt, reach, 3)
    tally.hold("find_matches_c3", lambda: eo.find_matches(dt, nvt, reach, 3),
               lambda: eo.find_matches_ref(dt, nvt, reach, 3), reps_plain=3,
               work=fm_work(dt, nvt, d3, m3))
    del d3, m3
    T = (N + 255) // 256 * 256
    gc = (dt, delta, mlen, nvt, T)
    op_len, op_val = eo.greedy_cover(*gc)  # for the work count
    n_cmd = int(torch.count_nonzero(op_len >= 0))
    op_len, op_val = tally.hold(
        "greedy_cover", lambda: eo.greedy_cover(*gc), lambda: eo.greedy_cover_ref(*gc),
        reps_plain=1, work=cover_work("greedy_cover", gc[:4], op_len, op_val))
    tally.hold("repify", lambda: eo.repify(op_len, op_val), lambda: eo.repify_ref(op_len, op_val),
               reps_plain=1, work=rep_work(op_len))
    rep_wide = rep_timing(op_len, op_val)

    # plane_encode: the five planes in one launch (the main path's entry),
    # with and without priors, each plane through the one-plane entry too;
    # then the 128 KiB all-literal input, whose lit plane takes the large path
    pe = {}
    for label, staged in pe_inputs(data, device):
        if label.startswith("all_literal_128k"):
            plan = we.launch_plan([(wide.PLANES[a[3]], a[4], a[2].shape[0]) for a in staged])[0]
            if [wide.PLANES[staged[i][3]].name for i, _, large, _ in plan if large] != ["lit"]:
                raise AssertionError("kernels_enc: the 128 KiB all-literal lit plane did not "
                                     "take the large path")
        tally.hold("plane_encode", lambda: we._plane_encode_planes(staged),
                   lambda: [we.plane_encode_ref(*a) for a in staged], reps_plain=0,
                   work=pe_work(staged), timed=label == "ship")
        if label == "ship":
            steps = {wide.PLANES[a[3]].name: a[4] for a in staged}
            for args in staged:
                tally.hold("plane_encode", lambda: we.plane_encode(*args),
                           lambda: we.plane_encode_ref(*args), timed=False)
        if not label.endswith("_no_priors"):
            pe[label] = pe_timing(staged)

    # the multi-row machinery: the synthetic 4-row, 16-symbol plane of
    # tests/test_wide.py in place of dst, with a prior; untimed
    spec4 = wide.PlaneSpec("dst", 8, 1, (16,), (4,))
    rng = np.random.default_rng(11)
    counts = np.array([300, 41], np.int32)
    st4 = wide.padded_steps(int(counts.max()), spec4.lanes)
    syms = np.zeros((2, st4 * spec4.lanes), np.int32)
    rows = np.zeros_like(syms)
    for b, n in enumerate(counts):
        syms[b, :n] = rng.integers(0, 16, n)
        rows[b, :n] = rng.integers(0, 4, n)
    put = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    args4 = ((put(syms),), (put(rows),), put(counts), 4, st4,
             (put(rng.integers(0, 200, (4, 16))),))
    planes = wide.PLANES
    wide.PLANES = planes[:4] + (spec4,)
    try:
        tally.hold("plane_encode", lambda: we.plane_encode(*args4),
                   lambda: we.plane_encode_ref(*args4), timed=False)
    finally:
        wide.PLANES = planes
    pe["synthetic_large"] = check_pe_large(tally, device)
    return {"blocks": B, "commands": n_cmd, "plane_steps": steps, "repify": rep_wide,
            "plane_encode": pe}


def check_pe_large(tally: Tally, device) -> dict:
    """plane_encode's large path on a plane of several reads and context
    rows: SYNTH_PLANES' two_read spec in place of dst, PE_LARGE_BLOCKS
    blocks of up to PE_LARGE_COUNT symbols (one block empty, one at steps
    x lanes), so that its counts and fences live in device scratch and
    the backward pass takes its fences in two windows; held against the
    plain version with its priors and with uniform tables; untimed."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    put = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    spec, counts, syms, rows, _, steps, prior = synth_plane(
        SYNTH_PLANES["two_read"], 5, PE_LARGE_BLOCKS, PE_LARGE_COUNT)
    counts[0], counts[1] = 0, steps * spec.lanes
    smem, large, _ = we.plane_layout(spec, steps)
    windows = -(-len(wide.chunk_schedule(steps)) // max(1, smem // (2 * sum(
        spec.rows[r] * (spec.alphabets[r] + 1) for r in range(spec.reads)))))
    if not large or windows < 2:
        raise AssertionError(f"kernels_enc: the synthetic large plane (steps {steps}) took "
                             f"large={large}, {windows} windows; want the large path, 2+")
    planes = wide.PLANES
    wide.PLANES = planes[:4] + (spec,)
    try:
        base = (tuple(put(a) for a in syms), tuple(None if r is None else put(r) for r in rows),
                put(counts), 4, steps)
        for pri in (tuple(put(a) for a in prior), None):
            args = base + (pri,)
            tally.hold("plane_encode", lambda: we.plane_encode(*args),
                       lambda: we.plane_encode_ref(*args), timed=False)
    finally:
        wide.PLANES = planes
    return {"spec": SYNTH_PLANES["two_read"], "blocks": PE_LARGE_BLOCKS, "steps": steps,
            "windows": windows, "symbols": int(counts.sum())}


def one_plane_launch(label: str, launches: dict) -> None:
    """Fail unless a wide encode's five planes took one plane_encode launch."""
    if launches["plane_encode"] != 1:
        raise AssertionError(f"{label}: {launches['plane_encode']} plane_encode launches, not 1")


def run_encode(tally: Tally, data: bytes, device, card: str, ratios: dict):
    """Phases kernels_enc, e2e_enc_greedy and e2e_enc_pipeline; returns
    {path: main-path launches} and puts e2e_enc_greedy's ratio in
    ratios."""
    from nlzm_tpu_torch import native
    from nlzm_tpu_torch.ops.encode_ops import parse_blocks_device
    from nlzm_tpu_torch.ops.wide_encode_dev import (
        encode_pipeline_device, encode_wide_blocks_device)
    from nlzm_tpu_torch.parallel.blocks import (
        block_payloads, decode_container, encode_container, parse_container)

    shape = check_kernels_enc(tally, data, device)
    emit({"phase": "kernels_enc", "ok": True, **shape,
          "kernels": tally.summary(ENC_KERNELS + ("find_matches_c3",)),
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls (plane_encode: "
                    f"one launch for the five planes); plain: 3 calls for find_matches, 1 for "
                    f"greedy_cover and repify (the comparison call past 1 s), the comparison "
                    f"call for plane_encode; plane_encode's device_ms from torch.profiler",
          "card": card})

    by_path = {}
    enc = lambda: encode_container(data, device=device, engine="device", **ENC_GREEDY)
    container, by_path["e2e_enc_greedy"] = launched("e2e_enc_greedy", ENC_KERNELS, enc)
    one_plane_launch("e2e_enc_greedy", by_path["e2e_enc_greedy"])
    # the device plane encode against the native one on the device-parsed ops
    op_len, op_val, op_rep, _ = parse_blocks_device(
        data, ENC_GREEDY["block_size"], ENC_HIST_BITS, device=device)
    pd, bd = encode_wide_blocks_device(op_len, op_val, op_rep, device=device)
    if (pd, bd) != native.wide_encode(op_len, op_val, op_rep):
        raise AssertionError("e2e_enc_greedy: device payloads differ from native.wide_encode")
    info = parse_container(container)
    if block_payloads(container, info) != pd or info.wide_priors != bd:
        raise AssertionError("e2e_enc_greedy: the container does not hold these payloads")
    if decode_container(container, device=device) != data:
        raise AssertionError("e2e_enc_greedy: the card's decode differs from the input")
    e2e = best_ms(enc, REPS)
    ratios["e2e_enc_greedy"] = len(container) / len(data)
    emit({"phase": "e2e_enc_greedy", "ok": True, "bytes": len(data),
          "container_bytes": len(container), "ratio": len(container) / len(data),
          "blocks": len(info.comp_sizes), "launches": by_path["e2e_enc_greedy"],
          "e2e_ms": e2e, "e2e_MBps": len(data) / e2e / 1e3,
          "timing": f"CUDA events around encode_container, best of {REPS}", "card": card})

    def pipeline():
        r = encode_pipeline_device(data, ENC_GREEDY["block_size"], device=device)
        r[0]()  # the first run, as the bench's warm-up
        return r

    (run, parse_s, stage, first_s), by_path["e2e_enc_pipeline"] = launched(
        "e2e_enc_pipeline", ("plane_encode",), pipeline)
    one_plane_launch("e2e_enc_pipeline", by_path["e2e_enc_pipeline"])
    ops = bench_commands(data)
    if encode_wide_blocks_device(*ops, device=device) != native.wide_encode(*ops):
        raise AssertionError("e2e_enc_pipeline: device payloads differ from native.wide_encode")
    run_s = host_best(run, REPS)
    stage_s = host_best(stage, 3)  # steady state
    e2e_s = parse_s + stage_s + run_s
    emit({"phase": "e2e_enc_pipeline", "ok": True, "bytes": len(data),
          "launches": by_path["e2e_enc_pipeline"], "parse_ms": parse_s * 1e3,
          "staging_ms": stage_s * 1e3, "staging_first_ms": first_s * 1e3,
          "run_ms": run_s * 1e3, "e2e_MBps": len(data) / e2e_s / 1e6,
          "stage_only_MBps": len(data) / run_s / 1e6, "payloads_checked_bytes": len(data),
          "timing": f"host clock as bench.py:313-334: parse once, staging best of 3, run "
                    f"best of {REPS}", "card": card})
    return by_path


def check_kernels_v1enc(tally: Tally, data: bytes, device):
    """The three v1 encode kernels against their plain versions at the
    8 MiB, 8 KiB-block shapes, on the commands of the parse kernels; then
    rans_backward and bits_forward at a small cap (untimed)."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    N = V1_ENC["block_size"]
    _, rans_cap, bits_cap = eo.frame_caps(N)  # encode_blocks_device's caps
    op_len, op_val = v1_commands(data, device)
    T, B = op_len.shape
    op_rep = tally.hold("repify", lambda: eo.repify(op_len, op_val),
                        lambda: eo.repify_ref(op_len, op_val), timed=False)
    rep_v1 = rep_timing(op_len, op_val)
    cmds = (op_len, op_val, op_rep)

    spans, fields, nops = eo.emit_model(*cmds)  # for the work count
    n_cmd = int(torch.count_nonzero(op_len >= 0))
    n_span = int(torch.count_nonzero(spans))
    # emit_model: ~64 operations a command (what it codes, its fields),
    # 4 a fence of each coded read (load, target, adapt, store)
    spans, fields, nops = tally.hold(
        "emit_model", lambda: eo.emit_model(*cmds), lambda: eo.emit_model_ref(*cmds),
        reps_plain=0, work=(nbytes(*cmds, spans, *fields, nops), 64 * n_cmd + 68 * n_span))
    tally.hold("rans_backward", lambda: eo.rans_backward(spans, rans_cap),
               lambda: eo.rans_backward_ref(spans, rans_cap), reps_plain=0,
               work=rans_work(spans, rans_cap))
    rans_v1 = rans_timing(spans, rans_cap)
    tally.hold("bits_forward", lambda: eo.bits_forward(fields, bits_cap),
               lambda: eo.bits_forward_ref(fields, bits_cap), reps_plain=1,
               work=bits_work(fields, bits_cap))
    cap = V1_ENC_SMALL_CAP
    tally.hold("rans_backward", lambda: eo.rans_backward(spans, cap),
               lambda: eo.rans_backward_ref(spans, cap), timed=False)
    tally.hold("bits_forward", lambda: eo.bits_forward(fields, cap),
               lambda: eo.bits_forward_ref(fields, cap), timed=False)
    # one 2 MiB bucket of the file encode: its first 256 blocks
    nb = STREAM_BUCKET // N
    fcmds = tuple(c[:, :nb].contiguous() for c in cmds)
    fl, fv = fcmds[:2]
    tally.hold("repify", lambda: eo.repify(fl, fv), lambda: eo.repify_ref(fl, fv), timed=False)
    rep_bucket = rep_timing(fl, fv)
    fb_ms = timed_mean(lambda: eo.emit_model(*fcmds), KERNEL_REPS)
    file_bucket = {"blocks": nb, "steps": T, "ms": fb_ms, "ns_per_step": fb_ms * 1e6 / T,
                   "max_cmds": int((fcmds[0] >= 0).sum(0).max())}
    fsp = spans[:, :nb].contiguous()
    tally.hold("rans_backward", lambda: eo.rans_backward(fsp, rans_cap),
               lambda: eo.rans_backward_ref(fsp, rans_cap), timed=False)
    rans_bucket = rans_timing(fsp, rans_cap)
    # the clamps, on commands no parse gives (untimed)
    fz = tuple(torch.as_tensor(a, device=device) for a in fuzz_commands(5))
    fspans, ffields, _ = tally.hold("emit_model", lambda: eo.emit_model(*fz),
                                    lambda: eo.emit_model_ref(*fz), timed=False)
    for fcap in (1024, 37):
        tally.hold("rans_backward", lambda: eo.rans_backward(fspans, fcap),
                   lambda: eo.rans_backward_ref(fspans, fcap), timed=False)
        tally.hold("bits_forward", lambda: eo.bits_forward(ffields, fcap),
                   lambda: eo.bits_forward_ref(ffields, fcap), timed=False)
    return {"blocks": B, "steps": T, "commands": n_cmd, "spans": n_span, "rans_cap": rans_cap,
            "bits_cap": bits_cap, "small_cap": cap,
            "max_cmds": int((op_len >= 0).sum(0).max()),
            "emit_model_ns_per_step": tally.k["emit_model"]["ms"] * 1e6 / T,
            "emit_model_file_bucket": file_bucket, "repify_1024x8192": rep_v1,
            "repify_file_bucket": rep_bucket, "rans_1024x8192": rans_v1,
            "rans_file_bucket": rans_bucket}


def run_v1_encode(tally: Tally, data: bytes, device, card: str, ratios: dict):
    """Phases kernels_v1enc, e2e_enc_v1 and stream_enc_v1; returns {path:
    main-path launches} and puts e2e_enc_v1's ratio in ratios."""
    from nlzm_tpu_torch import encode_container_stream, native
    from nlzm_tpu_torch.parallel.blocks import (
        block_payloads, decode_container, encode_container, parse_container)

    shape = check_kernels_v1enc(tally, data, device)
    emit({"phase": "kernels_v1enc", "ok": True, **shape,
          "kernels": tally.summary(V1ENC_KERNELS[3:]),
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; plain: 1 "
                    f"call (its comparison call past 1 s)", "card": card})

    N = V1_ENC["block_size"]
    by_path = {}
    enc = lambda: encode_container(data, device=device, engine="device", **V1_ENC)
    container, by_path["e2e_enc_v1"] = launched("e2e_enc_v1", V1ENC_KERNELS, enc)
    info = parse_container(container)
    for b, p in enumerate(block_payloads(container, info)):
        if native.decode_block(p, info.hist_bits, N) != data[b * N : (b + 1) * N]:
            raise AssertionError(f"e2e_enc_v1: native.decode_block differs on block {b}")
    if decode_container(container, device=device) != data:
        raise AssertionError("e2e_enc_v1: the card's decode differs from the input")
    e2e = best_ms(enc, REPS)
    ratios["e2e_enc_v1"] = len(container) / len(data)
    emit({"phase": "e2e_enc_v1", "ok": True, "bytes": len(data),
          "container_bytes": len(container), "ratio": len(container) / len(data),
          "blocks": len(info.comp_sizes), "launches": by_path["e2e_enc_v1"],
          "e2e_ms": e2e, "e2e_MBps": len(data) / e2e / 1e3,
          "timing": f"CUDA events around encode_container, best of {REPS}", "card": card})

    build = Path(__file__).resolve().parent / ".build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.nlzp"
        src.write_bytes(data)
        t0 = time.perf_counter()
        r, by_path["stream_enc_v1"] = launched(
            "stream_enc_v1", V1ENC_KERNELS, lambda: encode_container_stream(
                str(src), str(dst), device=device, engine="device",
                bucket_bytes=STREAM_BUCKET, **V1_ENC))
        secs = time.perf_counter() - t0
        if dst.read_bytes() != container:
            raise AssertionError("stream_enc_v1: the file differs from e2e_enc_v1's container")
    if r != {"in": len(data), "out": len(container), "crc32": zlib.crc32(data)}:
        raise AssertionError(f"stream_enc_v1: result {r}")
    emit({"phase": "stream_enc_v1", "ok": True, "bytes": len(data),
          "bucket_bytes": STREAM_BUCKET, "buckets": -(-len(data) // STREAM_BUCKET),
          "launches": by_path["stream_enc_v1"], "seconds": secs, "MBps": len(data) / secs / 1e6,
          "timing": "host clock, one call, file to file", "card": card})
    return by_path


def dp_work(delta, mlen, n_valid, rows, N: int):
    """dp_parse's (bytes, ops): candidates, counts and cost rows in, two
    [B, N] choices out; per position ~10 operations (literal edge,
    reduction, window store), per edge the data makes valid (n in
    [mmin(d), mlen], d > 0) ~4 (cost add, compare, select): the edges a
    DP must price, the invalid ones not counted."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    B = delta.shape[0]
    d = delta.long()
    mm = eo._mmin(d)
    edges = 0
    for n in eo.DP_LENS:
        edges += int(torch.count_nonzero((d > 0) & (mlen >= n) & (mm <= n)))
    return nbytes(delta, mlen, n_valid, rows) + 2 * 4 * B * N, 10 * B * N + 4 * edges


def dp_steps(delta, mlen, max_len: int = 264) -> dict:
    """Shares of dp_parse's positions by reach, the longest valid length
    over a position's candidates: "run" (no valid edge), "short" (reach <=
    DP_SHORT) and "long" (reach above it). A model in Python of the rule by
    which csrc/dp_parse.cu picks a position's step in a tame cost row (the
    default and the measured ones), not read from the kernel."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    d = delta.long()
    mm = eo._mmin(d)
    top = torch.where(d > 0, mlen.long().clamp(max=max(eo._dp_lens(max_len))), 0)
    reach = torch.where(top >= mm, top, 0).amax(2)
    n = reach.numel()
    return {"run": int((reach == 0).sum()) / n,
            "short": int(((reach > 0) & (reach <= DP_SHORT)).sum()) / n,
            "long": int((reach > DP_SHORT).sum()) / n}


def long_match_data(seed: int, n: int = 1 << 20) -> bytes:
    """n bytes of one seeded random segment of 1-4 KiB repeated: past its
    first copy in each 8 KiB block, a position's candidates hold the
    segment's distance at the 264-byte match cap."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.resize(rng.integers(0, 256, int(rng.integers(1024, 4097)), dtype=np.uint8),
                     n).tobytes()


def dp_timing(delta, mlen, nvt, max_len: int = 264) -> dict:
    """dp_parse's CUDA-event mean at the default costs, ns a position of
    one block's chain, and the modelled shares of dp_steps."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    B, N, _ = delta.shape
    ms = timed_mean(lambda: eo.dp_parse(delta, mlen, nvt, max_len=max_len), KERNEL_REPS)
    return dict(blocks=B, positions=N, ms=ms, ns_per_position=ms * 1e6 / N,
                steps_modelled=dp_steps(delta, mlen, max_len))


def check_kernels_opt(tally: Tally, data: bytes, device):
    """The three optimal-parse kernels against their plain versions at the
    8 MiB, 8 KiB-block shapes, exact, with CUDA-event times: dp_parse with
    the default costs and with the [B, 6] rows measure_costs gives after
    round 1, dp_cover on its choices, measure_costs on emit_model's spans;
    then, untimed, dp_parse and dp_cover's global-scratch path at 128 KiB
    blocks on 1 MiB, all three on fuzz_opt and dp_parse on fuzz_dp_runs;
    dp_parse held and timed apart at the wide optimal shape and on the
    long-match input (dp_timing)."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    N = V1_OPT["block_size"]
    arr, nv = eo._blocks_arrays(data, N)
    dt, nvt = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    B, T = dt.shape[0], (N + 255) // 256 * 256
    delta, mlen = eo.find_matches(dt, nvt, (1 << V1_ENC_HIST_BITS) - 1, 3)
    defaults = eo.default_dp_costs(device).expand(B, 6).contiguous()
    choice = tally.hold("dp_parse", lambda: eo.dp_parse(delta, mlen, nvt),
                        lambda: eo.dp_parse_ref(delta, mlen, nvt), reps_plain=0,
                        work=dp_work(delta, mlen, nvt, defaults, N))
    dp_8k = dp_timing(delta, mlen, nvt)
    cov = (dt, delta, *choice, nvt, T)
    op_len, op_val = eo.dp_cover(*cov)  # for the work count
    n_cmd = int(torch.count_nonzero(op_len >= 0))
    op_len, op_val = tally.hold(
        "dp_cover", lambda: eo.dp_cover(*cov), lambda: eo.dp_cover_ref(*cov), reps_plain=1,
        work=cover_work("dp_cover", cov[:5], op_len, op_val))
    op_rep = tally.hold("repify", lambda: eo.repify(op_len, op_val),
                        lambda: eo.repify_ref(op_len, op_val), timed=False)
    rep_opt = rep_timing(op_len, op_val)
    spans, _, _ = eo.emit_model(op_len, op_val, op_rep)
    mc = (spans, op_len, op_val, op_rep)
    costs = tally.hold("measure_costs", lambda: eo.measure_costs(*mc),
                       lambda: eo.measure_costs_ref(*mc), work=mc_work(mc))
    # measure_costs also at the wide optimal shape and on a 2 MiB file
    # bucket (the first 256 blocks), held, then each shape timed
    mcs = {"1024x8192": mc,
           "245x32768": mc_round1(data[:SHIP_BYTES], WIDE_OPT["block_size"], ENC_HIST_BITS,
                                  device),
           "256x8192": tuple(a[:, :256].contiguous() for a in mc)}
    for label, args in mcs.items():
        if label != "1024x8192":
            tally.hold("measure_costs", lambda: eo.measure_costs(*args),
                       lambda: eo.measure_costs_ref(*args), timed=False)
    mc_times = {label: mc_timing(args) for label, args in mcs.items()}
    del mcs
    tally.hold("dp_parse", lambda: eo.dp_parse(delta, mlen, nvt, costs),
               lambda: eo.dp_parse_ref(delta, mlen, nvt, costs), reps_plain=0,
               work=dp_work(delta, mlen, nvt, costs, N))
    del delta, mlen, choice, cov

    # rans_backward on the spans the optimal encode codes (its last round)
    ol, ov = eo._device_parse(dt, nvt, (1 << V1_ENC_HIST_BITS) - 1, T, "optimal")
    ospans, _, _ = eo.emit_model(ol, ov, eo.repify(ol, ov))
    rcap = rans_frame_cap(N)
    tally.hold("rans_backward", lambda: eo.rans_backward(ospans, rcap),
               lambda: eo.rans_backward_ref(ospans, rcap), timed=False)
    rans_opt = rans_timing(ospans, rcap)
    del ol, ov, ospans

    # N > 32768: the walk's steps and start mask in global scratch
    big = BIG_COVER["block_size"]
    arr, nv = eo._blocks_arrays(data[: BIG_COVER["bytes"]], big)
    bt, bnv = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    bd, bm = eo.find_matches(bt, bnv, big - 1, 3)
    bchoice = tally.hold("dp_parse", lambda: eo.dp_parse(bd, bm, bnv),
                         lambda: eo.dp_parse_ref(bd, bm, bnv), timed=False)
    bcov = (bt, bd, *bchoice, bnv, big)
    tally.hold("dp_cover", lambda: eo.dp_cover(*bcov), lambda: eo.dp_cover_ref(*bcov),
               timed=False)
    del bd, bm, bcov

    # emit_model at the wide optimal encode's shape (T = 32768, 32 KiB
    # blocks, the commands of its last round): held, then timed
    WN = WIDE_OPT["block_size"]
    warr, wnv = eo._blocks_arrays(data[:SHIP_BYTES], WN)
    wt, wnvt = torch.as_tensor(warr, device=device), torch.as_tensor(wnv, device=device)
    wd, wm = eo.find_matches(wt, wnvt, (1 << ENC_HIST_BITS) - 1, 3)
    tally.hold("dp_parse", lambda: eo.dp_parse(wd, wm, wnvt), lambda: eo.dp_parse_ref(wd, wm, wnvt),
               timed=False)
    dp_wide = dp_timing(wd, wm, wnvt)
    del wd, wm
    wl, wv = eo._device_parse(wt, wnvt, (1 << ENC_HIST_BITS) - 1, (WN + 255) // 256 * 256,
                              "optimal")
    wcmds = (wl, wv, eo.repify(wl, wv))
    t0 = time.perf_counter()
    tally.hold("emit_model", lambda: eo.emit_model(*wcmds), lambda: eo.emit_model_ref(*wcmds),
               timed=False)
    check_s = time.perf_counter() - t0
    WT = wcmds[0].shape[0]
    ms = timed_mean(lambda: eo.emit_model(*wcmds), KERNEL_REPS)
    wide = dict(blocks=wcmds[0].shape[1], steps=WT, check_s=check_s, ms=ms,
                ns_per_step=ms * 1e6 / WT, max_cmds=int((wl >= 0).sum(0).max()))
    del wl, wv, wcmds

    fz = {k: (tuple(torch.as_tensor(a, device=device) for a in v) if k == "commands"
              else torch.as_tensor(v, device=device)) for k, v in fuzz_opt(7).items()}
    for costs_f in (None, fz["costs"]):
        tally.hold("dp_parse", lambda: eo.dp_parse(fz["delta"], fz["mlen"], fz["n_valid"], costs_f),
                   lambda: eo.dp_parse_ref(fz["delta"], fz["mlen"], fz["n_valid"], costs_f),
                   timed=False)
    fr = {k: torch.as_tensor(v, device=device) for k, v in fuzz_dp_runs(7).items()}
    for max_len in DP_RUNS_MAX_LENS:
        for costs_f in (None, fr["costs"]):
            args = (fr["delta"], fr["mlen"], fr["n_valid"], costs_f, max_len)
            tally.hold("dp_parse", lambda: eo.dp_parse(*args), lambda: eo.dp_parse_ref(*args),
                       timed=False)

    # long matches: most positions take the warp-wide relaxation
    larr, lnv = eo._blocks_arrays(long_match_data(11), N)  # a 1435-byte segment
    lt, lnvt = torch.as_tensor(larr, device=device), torch.as_tensor(lnv, device=device)
    ld, lm = eo.find_matches(lt, lnvt, (1 << V1_ENC_HIST_BITS) - 1, 3)
    tally.hold("dp_parse", lambda: eo.dp_parse(ld, lm, lnvt), lambda: eo.dp_parse_ref(ld, lm, lnvt),
               timed=False)
    dp_long = dp_timing(ld, lm, lnvt)
    fcov = (fz["data"], fz["delta"], fz["choice_len"], fz["choice_cand"], fz["n_valid"],
            fz["data"].shape[1] + 64)
    tally.hold("dp_cover", lambda: eo.dp_cover(*fcov), lambda: eo.dp_cover_ref(*fcov),
               timed=False)
    tally.hold("measure_costs", lambda: eo.measure_costs(*fz["commands"]),
               lambda: eo.measure_costs_ref(*fz["commands"]), timed=False)
    return {"blocks": B, "steps": T, "commands_round1": n_cmd,
            "big_cover": dict(blocks=bt.shape[0], **BIG_COVER), "emit_model_wide": wide,
            "dp_parse_8k": dp_8k, "dp_parse_wide": dp_wide, "dp_parse_long_match": dp_long,
            "measure_costs": mc_times,
            "repify_opt_round1": rep_opt, "rans_opt_final": rans_opt}


def mc_work(mc):
    """measure_costs' (bytes, ops): the spans and command arrays read once,
    the costs written; ~8 operations a row (loads, family tests), ~4 a
    span (table lookup, add)."""
    import torch

    spans, op_len = mc[0], mc[1]
    T, B = op_len.shape
    return nbytes(*mc) + 4 * 6 * B, 8 * T * B + 4 * int(torch.count_nonzero(spans))


def mc_round1(data: bytes, block_size: int, hist_bits: int, device):
    """measure_costs' input in an optimal parse's first round: (spans,
    op_len, op_val, op_rep) of the commands dp_parse (default costs) and
    dp_cover choose from three candidates a position, emit_model's spans."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    arr, nv = eo._blocks_arrays(data, block_size)
    dt, nvt = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    delta, mlen = eo.find_matches(dt, nvt, (1 << hist_bits) - 1, 3)
    op_len, op_val = eo.dp_cover(dt, delta, *eo.dp_parse(delta, mlen, nvt), nvt,
                                 (block_size + 255) // 256 * 256)
    op_rep = eo.repify(op_len, op_val)
    return eo.emit_model(op_len, op_val, op_rep)[0], op_len, op_val, op_rep


def mc_shape(T: int, B: int) -> dict:
    """csrc/measure_costs.cu's launch at T x B on this card
    (nlzm_measure_costs_shape, encode_ops.cost_split): the grid (block
    groups x step ranges), steps a range, registers a thread, resident
    CTAs an SM and waves."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops.encode_ops import cost_split

    out = (ctypes.c_int * 4)()
    st = _build.entry("measure_costs", "nlzm_measure_costs_shape", 1, 0)(
        ctypes.addressof(out), torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_measure_costs_shape: CUDA error {st}")
    regs, ctas, sms, threads = out
    groups, splits, rows = cost_split(T, B, sms)
    return dict(groups=groups, splits=splits, rows=rows, threads=threads, registers=regs,
                ctas_per_sm=ctas, waves=-(-groups * splits // (ctas * sms)) if ctas else None)


def mc_timing(mc) -> dict:
    """measure_costs on mc: ms (CUDA events, mean of KERNEL_REPS calls, the
    scratch's zeroing included), device ms (torch.profiler), the bound and
    the launch shape."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    fn = lambda: eo.measure_costs(*mc)
    T, B = mc[1].shape
    return dict(ms=timed_mean(fn, KERNEL_REPS), device_ms=kernel_device_ms(fn, "measure_costs"),
                bound_ms=bound(*mc_work(mc))[0], shape=mc_shape(T, B))


def cover_work(name: str, args, op_len, op_val):
    """The cover walk's (bytes, ops): the step inputs read once (greedy:
    data, delta, mlen, n_valid; dp: data, choice_len, choice_cand,
    n_valid), the two [T, B] outputs written once, and for dp one 32-byte
    sector of delta [B, N, C] a match start, where the chosen distance is
    read (the rest of delta is never needed); ~10 operations a command
    (mask bit, scan, command) and 2 a row written."""
    import torch

    T, B = op_len.shape
    n_cmd = int(torch.count_nonzero(op_len >= 0))
    if name == "greedy_cover":
        byts = nbytes(*args)
    else:
        data, _, choice_len, choice_cand, n_valid = args
        byts = nbytes(data, choice_len, choice_cand, n_valid) + 32 * int(
            torch.count_nonzero(op_len > 0))
    return byts + nbytes(op_len, op_val), 10 * n_cmd + 2 * T * B


def cover_ctas_per_sm(N: int, dp: bool) -> float:
    """CTAs of csrc/greedy_cover.cu's kernel resident on the card at block
    length N, as the CUDA occupancy calculator gives them (in clusters of
    8), over its SMs."""
    import torch

    from nlzm_tpu_torch import _build

    dev = torch.cuda.current_device()
    fn = _build.entry("greedy_cover", "nlzm_cover_ctas_resident", 0, 2)
    n = fn(N, int(dp), dev, None)
    if n < 0:
        raise RuntimeError(f"nlzm_cover_ctas_resident: CUDA error {-n}")
    return n / torch.cuda.get_device_properties(dev).multi_processor_count


def cover_timing(name: str, args, T: int, out) -> dict:
    """The cover kernel `name` ("greedy_cover" or "dp_cover") on args with
    T steps: CUDA-event mean, ns a command of the longest block's chain,
    resident CTAs an SM, and its bound (cover_work)."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    kernel = getattr(eo, name)
    ms = timed_mean(lambda: kernel(*args, T), KERNEL_REPS)
    live = out[0] >= 0
    n_cmd, longest = int(torch.count_nonzero(live)), int(live.sum(0).max())
    b_ms, b_by = bound(*cover_work(name, args, *out))
    return dict(blocks=out[0].shape[1], positions=args[0].shape[1], steps=T, commands=n_cmd,
                max_cmds=longest, ms=ms, ns_per_command=ms * 1e6 / max(longest, 1),
                ctas_per_sm=cover_ctas_per_sm(args[0].shape[1], name == "dp_cover"),
                bound_ms=b_ms, bound_by=b_by)


def rep_work(op_len):
    """repify's (bytes, ops): op_len read once, op_rep written once, and
    op_val only where a match needs it: one 32-byte sector (8 adjacent
    words of the [T, B] array) for each sector that holds a match; ~2
    operations a row (test, store) and ~12 a match (four compares, the
    slot, the push)."""
    import torch

    at = torch.nonzero(op_len.flatten() > 0).flatten()
    sectors = int(torch.unique_consecutive(at // 8).numel())
    return 2 * nbytes(op_len) + 32 * sectors, 2 * op_len.numel() + 12 * int(at.numel())


def rep_runs(op_len, op_val) -> dict:
    """rep_model's histogram on these commands, on the host: {runs: blocks},
    "fallback" for REP_R runs and then the fallback."""
    import numpy as np

    _, runs = rep_model(op_len.cpu().numpy(), op_val.cpu().numpy())
    hist = np.bincount(runs, minlength=REP_R + 2)
    out = {str(r): int(hist[r]) for r in range(1, REP_R + 1) if hist[r]}
    if hist[REP_R + 1]:
        out["fallback"] = int(hist[REP_R + 1])
    return out


def rep_timing(op_len, op_val) -> dict:
    """repify on these commands: CUDA-event mean, ns a match of the block
    with the most matches and ns a row, its bound (rep_work) and
    rep_model's runs."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    ms = timed_mean(lambda: eo.repify(op_len, op_val), KERNEL_REPS)
    T, B = op_len.shape
    matches = (op_len > 0).sum(0)
    longest = int(matches.max()) if B else 0
    b_ms, b_by = bound(*rep_work(op_len))
    return dict(blocks=B, rows=T, matches=int(matches.sum()), max_matches=longest, ms=ms,
                ns_per_match=ms * 1e6 / max(longest, 1), ns_per_row=ms * 1e6 / T,
                bound_ms=b_ms, bound_by=b_by, runs=rep_runs(op_len, op_val))


def rans_frame_cap(T: int) -> int:
    """encode_blocks_device's rANS cap for blocks of T rows (N = T)."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    return eo.frame_caps(T)[1]


def rans_shape(B: int) -> dict:
    """csrc/rans_backward.cu's launch at B blocks on this card
    (nlzm_rans_shape): blocks a CTA (G), threads, dynamic shared bytes,
    registers a thread (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the waves of its
    ceil(B / G) CTAs."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 7)()
    st = _build.entry("rans_backward", "nlzm_rans_shape", 1, 1)(
        ctypes.addressof(out), B, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_rans_shape: CUDA error {st}")
    G, threads, smem, regs, ctas, sms, R = out
    if R != RANS_R:
        raise AssertionError(f"csrc/rans_backward.cu's R {R} is not RANS_R {RANS_R}")
    grid = -(-B // G)
    return dict(G=G, threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                waves=-(-grid // (ctas * sms)) if ctas else None)


def rans_work(spans, cap: int):
    """rans_backward's (bytes, ops): the [T, B, 6] spans read once, the
    stream and rans_bytes written once; ~30 operations a span (its
    division, the renorm, its place in the stream)."""
    import torch

    B = spans.shape[1]
    return nbytes(spans) + B * (cap + 4), 30 * int(torch.count_nonzero(spans))


def kernel_device_ms(fn, key: str, reps: int = KERNEL_REPS):
    """Device ms a call of the kernels whose name holds `key`: each one's
    mean over its launches in reps calls of fn() under torch.profiler
    after one warm-up call, summed over those kernels (a call launching
    each once: lz_expand launches two on JAX's packed path): the kernels alone,
    without the wrapper's host time (which back-to-back CUDA-event means
    include once a call is shorter than it), over the launches traced: a
    profile may lose some of the tracer's records, and late in a long run
    all of them, so up to 3 profiles run until one traces any. None if
    none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        means = [(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
                 / e.count for e in prof.key_averages() if key in e.key and e.count]
        if means:
            return sum(means) / 1e3
    return None


def huff_shape(B: int) -> dict:
    """csrc/huff_scan.cu's launch at B blocks on this card (nlzm_huff_shape):
    K (bits a span), threads a CTA, dynamic shared bytes, registers a thread
    (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), bits a page, and the
    waves of B CTAs."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 7)()
    st = _build.entry("huff_scan", "nlzm_huff_shape", 1, 1)(
        ctypes.addressof(out), B, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_huff_shape: CUDA error {st}")
    kw, threads, smem, regs, ctas, sms, page = out
    return dict(threads=threads, K=f"32 x {kw}" if kw else "rule", smem_bytes=smem,
                registers=regs, ctas_per_sm=ctas, page_bits=page,
                waves=-(-B // (ctas * sms)) if ctas else None)


def huff_work(args):
    """huff_scan's (bytes, ops): streams and tables read once, [B, T] bytes
    written once; a table decode's operations: ~10 a symbol (two stream
    words, a funnel shift, one table read, the length's add, the symbol's
    store), every block T steps, and ~4 an entry of a block's 2^14-entry
    decode table (the index arithmetic, its clamp, the symbol's read, the
    store)."""
    B, T = args[0].shape[0], args[5]
    return nbytes(*args[:5]) + B * T, 10 * B * T + 4 * B * (1 << HUFF_LIMIT)


def huff_timing(args) -> dict:
    """huff_scan on these staged arrays: CUDA-event mean (ms), the kernel's
    device time (kernel_device_ms), ns a symbol of the [B, T] output, its
    bound (huff_work) and the launch shape (huff_shape)."""
    from nlzm_tpu_torch.research import huff0

    B, S = args[0].shape
    T = args[5]
    call = lambda: huff0._huff_scan(*args)
    ms = timed_mean(call, KERNEL_REPS)
    b_ms, b_by = bound(*huff_work(args))
    return dict(blocks=B, S=S, T=T, ms=ms, device_ms=kernel_device_ms(call, "huff"),
                ns_per_symbol=ms * 1e6 / max(B * T, 1), bound_ms=b_ms, bound_by=b_by,
                **huff_shape(B))


def nlzc_prior_container(data: bytes, block_size: int) -> bytes:
    """The huff0 container of the prior ppm_tpu.compress(data, block_size)
    ships (its v4 prior, 2 x 4096 x 16 bytes, huff0-coded at 32 KiB
    blocks)."""
    import numpy as np

    from nlzm_tpu_torch.research import huff0, ppm_tpu

    blocks = [data[b : b + block_size] for b in range(0, len(data), block_size)]
    sym, prev, prev2, act, _ = ppm_tpu._layout(blocks)
    prior = ppm_tpu.build_prior(sym, prev, prev2, act)
    return huff0.encode(prior.astype(np.uint8).tobytes())


def huff_inputs(corpus: bytes, prior_container: bytes, device, bench=True):
    """(label, staged huff_scan arguments on `device`) of every shape the
    kernel is held and timed at: the huff0 bench (8 MB at 32 KiB blocks,
    245 x 32768; bench=False leaves it out), the NLZC prior (4 x 32768), 8
    MB of random bytes, of 64 symbols and of 128 symbols drawn uniformly
    (fuzz_huff's "uniform64" / "uniform128") at 32 KiB blocks, 2 MiB at
    128 KiB blocks (16 x 131072), then every fuzz_huff(7) pattern at 16 x
    4096."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.research import huff0

    put = lambda st: tuple(torch.as_tensor(a, device=device) for a in st[:5]) + (st[5],)
    full = lambda data: put(huff_staged(huff0.encode(data, HUFF0["block_size"])))
    if bench:
        yield "huff0_245x32768", full(corpus[: HUFF0["bytes"]])
    yield "nlzc_prior_4x32768", put(huff_staged(prior_container))
    rng = np.random.default_rng(7)
    for k, label in ((256, "random"), (64, "uniform64"), (128, "uniform128")):
        yield f"{label}_245x32768", full(rng.integers(0, k, HUFF0["bytes"], np.uint8).tobytes())
    yield "big_16x131072", put(huff_staged(huff0.encode(corpus[: HUFF_BIG["bytes"]],
                                                         HUFF_BIG["block_size"])))
    for pat, st in fuzz_huff(7).items():
        yield pat, put(st)


def rans_timing(spans, cap: int) -> dict:
    """rans_backward on these spans: CUDA-event mean (ms) and the kernel's
    device time (device_ms, kernel_device_ms), ns a step of the longest
    chain (the most spans a block / 4, from ms), its bound (rans_work) and
    the launch shape (rans_shape)."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    call = lambda: eo.rans_backward(spans, cap)
    ms = timed_mean(call, KERNEL_REPS)
    T, B, _ = spans.shape
    per_block = (spans != 0).sum(dim=(0, 2))
    longest = int(per_block.max()) if B else 0
    b_ms, b_by = bound(*rans_work(spans, cap))
    return dict(blocks=B, rows=T, cap=cap, spans=int(per_block.sum()), max_spans=longest, ms=ms,
                device_ms=kernel_device_ms(call, "rans"),
                ns_per_step=ms * 1e6 / max(longest / 4, 1), bound_ms=b_ms, bound_by=b_by,
                **rans_shape(B))


def fm_work(dt, nvt, delta, mlen):
    """find_matches' (bytes, ops): the blocks and n_valid read once, delta
    and mlen written once; ~12 operations a position to hash and key it,
    log2 N to group it, 2 a byte compared (each candidate's length + 1)."""
    import torch

    B, N = dt.shape
    cands = int(torch.count_nonzero(delta))
    return (nbytes(dt, nvt, delta, mlen),
            B * N * (12 + (N - 1).bit_length()) + 2 * (int(mlen.long().sum()) + cands))


def fm_shape(B: int, N: int, C: int) -> dict:
    """csrc/find_matches.cu's launch at B blocks of N bytes, C candidates,
    on this card (nlzm_fm_shape): threads a CTA, dynamic shared bytes,
    registers a thread (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the waves of B
    CTAs."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 5)()
    st = _build.entry("find_matches", "nlzm_fm_shape", 1, 3)(
        ctypes.addressof(out), B, N, C, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_fm_shape: CUDA error {st}")
    threads, smem, regs, ctas, sms = out
    return dict(threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                waves=-(-B // (ctas * sms)) if ctas else None)


def fm_timing(dt, nvt, reach: int, C: int) -> dict:
    """find_matches on these blocks: CUDA-event mean (ms), the kernel's
    device time (device_ms, kernel_device_ms), ns a position, its bound
    (fm_work) and the launch shape (fm_shape)."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    call = lambda: eo.find_matches(dt, nvt, reach, C)
    b_ms, b_by = bound(*fm_work(dt, nvt, *call()))  # also the warm-up
    ms = timed_mean(call, KERNEL_REPS)
    B, N = dt.shape
    return dict(blocks=B, N=N, C=C, reach=reach, ms=ms,
                device_ms=kernel_device_ms(call, "find_matches"),
                ns_per_position=ms * 1e6 / max(B * N, 1), bound_ms=b_ms, bound_by=b_by,
                **fm_shape(B, N, C))


def fm_inputs(corpus: bytes, device, seed: int = 7):
    """(label, (data, n_valid, reach, C) on `device`) of every shape the
    kernel is held and timed at: the v1 encodes' 1024 x 8192 (reach 8191;
    one and three candidates), one 2 MiB file bucket (256 x 8192), the
    global path's 8 x 131072 (three candidates), every
    fuzz_matches(seed, card=True) pattern, runs_short at six candidates
    (the kernel's path for C > 4), and one block of 700 bytes."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    def blocks(data, N):
        arr, nv = eo._blocks_arrays(data, N)
        return torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)

    v1 = V1_ENC["block_size"]
    reach = (1 << V1_ENC_HIST_BITS) - 1
    dt, nvt = blocks(corpus[:V1_ENC_BYTES], v1)
    for C in (1, 3):
        yield f"v1_1024x{v1}_c{C}", (dt, nvt, reach, C)
    bt, bnv = dt[: STREAM_BUCKET // v1], nvt[: STREAM_BUCKET // v1]
    for C in (1, 3):
        yield f"bucket_256x{v1}_c{C}", (bt, bnv, reach, C)
    del dt, nvt, bt, bnv
    big = BIG_COVER["block_size"]
    yield f"big_8x{big}_c3", (*blocks(corpus[: BIG_COVER["bytes"]], big), big - 1, 3)
    for pat, (d, nv, r, C) in fuzz_matches(seed, card=True).items():
        yield pat, (torch.as_tensor(d, device=device), torch.as_tensor(nv, device=device), r, C)
        if pat == "runs_short":
            yield f"{pat}_c6", (torch.as_tensor(d, device=device),
                                torch.as_tensor(nv, device=device), r, 6)
    one = blocks(corpus[:700], 700)  # the smallest launch: one block of 700 bytes
    yield "one_1x700", (*one, 699, 3)


def ps_args(staged):
    """plane_scan_fused's arguments for a staged bucket, its windows from
    stage_windows_fused."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    return (staged["seeds_cat"], wd.stage_windows_of(staged), staged["n_sym"], staged["steps"],
            staged["priors"])


def ps_work(args):
    """plane_scan's (bytes, ops) on one bucket: seeds, n_sym and the windows
    read once, the five outputs written once; per live symbol a search of
    log2(alphabet) compares (what a binary search needs; the kernel's
    bitmap takes fewer) and ~10 state operations, per chunk, plane and
    block ~4 a table entry to rebuild (symbols past steps * L_p not
    counted)."""
    import torch

    seeds, wins, n_sym, steps, _ = args
    B, NC = seeds.shape[0], wins[0].shape[0]
    lanes = n_sym.new_tensor(PS_WIRE_LANES).long()
    live = torch.minimum(n_sym.long().clamp(min=0), steps * lanes).sum(0).tolist()
    out_elems = sum(B * steps * L for L in PS_WIRE_LANES)
    ops = (sum(n * ((a - 1).bit_length() + 10) for n, a in zip(live, PS_WIRE_ALPH))
           + NC * B * sum(PS_WIRE_ALPH) * 4)
    return nbytes(seeds, n_sym, *wins) + 4 * out_elems, ops


def ps_shape(B: int) -> dict:
    """csrc/plane_scan.cu's launch at B blocks on this card (nlzm_ps_shape):
    threads a CTA, shared bytes a CTA, registers a thread
    (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the waves of its B
    x 5 CTAs (one warp a plane and block)."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 5)()
    st = _build.entry("plane_scan", "nlzm_ps_shape", 1, 0)(
        ctypes.addressof(out), torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_ps_shape: CUDA error {st}")
    threads, smem, regs, ctas, sms = out
    return dict(threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                waves=-(-5 * B // (ctas * sms)) if ctas else None)


def ps_timing(args) -> dict:
    """plane_scan on these arguments through the main path's entry (no prior
    check, the priors staged in slot order once): CUDA-event mean (ms), the
    kernel's device time (device_ms, kernel_device_ms), ns a step of the
    bucket's steps from each, its bound (ps_work) and the launch shape
    (ps_shape); host_ms, the host's time to issue a call of that entry
    (the mean of KERNEL_REPS back-to-back calls, not waiting for the card);
    unstaged_ms, the CUDA-event mean when the entry orders the priors
    itself at each call; checked_ms, through plane_scan_fused, whose prior
    check copies back and so waits for the kernel before it."""
    import torch

    from nlzm_tpu_torch.ops import wide_decode as wd

    seeds, _, _, steps, priors = args
    sp = wd.slot_priors(priors)
    call = lambda: wd._plane_scan_fused(*args, sp)
    call()  # the warm-up
    ms = timed_mean(call, KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(KERNEL_REPS):
        call()
    host_ms = (time.perf_counter() - t0) * 1e3 / KERNEL_REPS
    torch.cuda.synchronize()
    unstaged_ms = timed_mean(lambda: wd._plane_scan_fused(*args), KERNEL_REPS)
    checked_ms = timed_mean(lambda: wd.plane_scan_fused(*args), KERNEL_REPS)
    dev_ms = kernel_device_ms(call, "plane_scan")
    b_ms, b_by = bound(*ps_work(args))
    B = seeds.shape[0]
    return dict(blocks=B, steps=steps, ms=ms, host_ms=host_ms, unstaged_ms=unstaged_ms,
                checked_ms=checked_ms, device_ms=dev_ms,
                ns_per_step=ms * 1e6 / max(steps, 1),
                device_ns_per_step=None if dev_ms is None else dev_ms * 1e6 / max(steps, 1),
                bound_ms=b_ms, bound_by=b_by, **ps_shape(B))


def file_buckets(container: bytes, device):
    """(block size, the two quantile buckets of the container's first 2 MiB
    file bucket, staged as decode_container_stream stages them)."""
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import block_payloads, parse_container

    info = parse_container(container)
    nb = STREAM_BUCKET // info.block_size
    return info.block_size, wd.stage_buckets(
        block_payloads(container, info)[:nb], info.wide_priors, info.total_reads[:nb],
        wd.dict_tensor(info.dictionary, device), device=device)


def wide_device_ms(block_size: int, buckets, tag: str) -> dict:
    """Each wide decode kernel's device ms a launch (kernel_device_ms) on
    each staged bucket, as decode_wide_staged runs it (assemble and
    lz_expand through the main path's entries, the commands as [B, TP]
    pairs), and lz_expand_cols: lz_expand_parallel on the same commands as
    [T, B] (its transpose kernel and the expansion): {tag_i: {kernel:
    ms}}."""
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    out = {}
    for i, (staged, _) in enumerate(buckets):
        sw = (staged["hw_cat"], staged["offs"], staged["ends"], staged["WHs"])
        ps = (staged["seeds_cat"], wd.stage_windows_fused(*sw), staged["n_sym"], staged["steps"],
              staged["priors"])
        ys = tuple(a[:, : min(a.shape[1], wd.CAP15)] for a in wd._plane_scan_fused(*ps))
        tok_y, lit_y, len_y, lex_y, slot_y = ys
        asm = (tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
               staged["n_sym"][:, 0].contiguous(), block_size > wd.CAP15,
               staged["dict_arr"] is not None)
        cmds = wd._assemble_rows(*asm)
        Tc = tok_y.shape[1]
        ex = (block_size, staged["rounds_hint"], staged["dict_arr"])
        cols = (cmds[:, :Tc, 0].t().contiguous(), cmds[:, :Tc, 1].t().contiguous(), *ex)
        calls = {"stage_windows": lambda: wd.stage_windows_fused(*sw),
                 "plane_scan": lambda: wd._plane_scan_fused(*ps, staged["slot_priors"]),
                 "assemble": lambda: wd._assemble_rows(*asm),
                 "lz_expand": lambda: xo._lz_expand_rows(cmds, Tc, *ex)}
        out[f"{tag}_{i}"] = {"blocks": staged["seeds_cat"].shape[0],
                             **{n: kernel_device_ms(f, n) for n, f in calls.items()},
                             "lz_expand_cols": kernel_device_ms(
                                 lambda: xo.lz_expand_parallel(*cols), "lz_expand")}
    return out


def ps_inputs(container: bytes, device, seed: int = 7):
    """(label, plane_scan_fused arguments on `device`) of the shapes the
    kernel is held and timed at beside the shipping and frontier buckets:
    the two quantile buckets of one 2 MiB file bucket (file_buckets) and
    every fuzz_scan(seed) pattern."""
    import numpy as np
    import torch

    _, buckets = file_buckets(container, device)
    for i, (staged, _) in enumerate(buckets):
        yield f"file_q{i}", ps_args(staged)
    del buckets
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    for pat, (sd, wins, ns, steps, pri) in fuzz_scan(seed).items():
        yield pat, (put(sd.view(np.int32)), tuple(put(w) for w in wins), put(ns), steps,
                    None if pri is None else tuple(put(a) for a in pri))


def check_scan(tally: Tally, container: bytes, device, timing: dict) -> dict:
    """Phase kernels_scan: plane_scan against its plain version, exact,
    untimed in the tally, at every ps_inputs shape; each timed (ps_timing)
    beside the shipping buckets (held in kernels) and the frontier ones
    (held in e2e_frontier, their timings given in `timing`); the four wide
    decode kernels' device ms a launch on the shipping buckets and on the
    file bucket's two (wide_device_ms). Returns the phase's fields."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    t0 = time.perf_counter()
    info, buckets = stage(container, device)
    ship = {f"ship_b{i}": ps_timing(ps_args(staged)) for i, (staged, _) in enumerate(buckets)}
    wide_ms = wide_device_ms(info.block_size, buckets, "ship")
    del buckets
    wide_ms.update(wide_device_ms(*file_buckets(container, device), "file"))
    timing = {**ship, **timing}
    for label, ps in ps_inputs(container, device):
        tally.hold("plane_scan", lambda: wd.plane_scan_fused(*ps),
                   lambda: wd.plane_scan_fused_ref(*ps), timed=False)
        timing[label] = ps_timing(ps)
    return {"ps_timing": timing, "ship_sum_ms": sum(t["ms"] for t in ship.values()),
            "ship_sum_device_ms": sum(t["device_ms"] or 0.0 for t in ship.values()),
            "wide_device_ms": wide_ms,
            "seconds": time.perf_counter() - t0}


def wide_commands(staged, block_size: int):
    """(op_len, op_val) of a staged wide bucket through the kernels, as
    decode_wide_staged makes them (here as [T, B])."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    return wd.assemble_ops(*asm_args(staged, block_size))


def ex_shape(T: int, B: int, N: int, D: int, rows: bool = False) -> dict:
    """csrc/lz_expand.cu's launch at this shape on this card
    (nlzm_lz_expand_shape): threads a CTA, dynamic shared bytes, registers
    a thread (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the waves of its B
    CTAs, whether it takes JAX's packed path, whether the masks are in
    shared memory and whether the commands are transposed first (never
    with rows: the main path's pairs); the scratch bytes, the wrapper's
    size checked against the C layout's (nlzm_lz_expand_scratch)."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import expand_ops as xo

    dev = torch.cuda.current_device()
    out = (ctypes.c_int * 9)()
    st = _build.entry("lz_expand", "nlzm_lz_expand_shape", 1, 5)(
        ctypes.addressof(out), T, B, N, D, int(rows), dev, None)
    words = ctypes.c_longlong()
    st = st or _build.entry("lz_expand", "nlzm_lz_expand_scratch", 1, 5)(
        ctypes.addressof(words), T, B, N, D, int(rows), dev, None)
    if st:
        raise RuntimeError(f"nlzm_lz_expand_shape: CUDA error {st}")
    want = xo.scratch_words(T, B, N, D, rows)
    if words.value != want:
        raise AssertionError(f"scratch words {want} != {words.value}")
    threads, smem, regs, ctas, sms, packed, in_smem, transposed, slot = out
    return dict(threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                waves=-(-B // (ctas * sms)) if ctas else None, packed_path=bool(packed),
                masks_in_smem=bool(in_smem), transposed=bool(transposed),
                scratch_bytes=4 * words.value)


def ex_timing(args) -> dict:
    """lz_expand on these arguments: CUDA-event mean of KERNEL_REPS
    back-to-back calls (ms), the call's device time (device_ms,
    kernel_device_ms: both kernels on JAX's packed path), ns a position
    from each, host_us (the host's time to issue a call, not waiting for
    the card), the bound (expand_work) and the launch shape (ex_shape)."""
    import torch

    from nlzm_tpu_torch.ops import expand_ops as xo

    op_len, op_val, N, hint, dict_arr = args
    call = lambda: xo.lz_expand_parallel(*args)
    call()
    ms = timed_mean(call, KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(KERNEL_REPS):
        call()
    host_us = (time.perf_counter() - t0) * 1e6 / KERNEL_REPS
    torch.cuda.synchronize()
    dev_ms = kernel_device_ms(call, "lz_expand")
    T, B = op_len.shape
    pos = max(B * N, 1)
    b_ms, b_by = bound(*expand_work(op_len, N, hint, dict_arr))
    return dict(blocks=B, T=T, N=N, D=0 if dict_arr is None else dict_arr.numel(),
                hint=hint, ms=ms, device_ms=dev_ms, host_us=host_us, ns_per_position=ms * 1e6 / pos,
                device_ns_per_position=None if dev_ms is None else dev_ms * 1e6 / pos,
                bound_ms=b_ms, bound_by=b_by, **ex_shape(T, B, N, 0 if dict_arr is None
                                                        else dict_arr.numel()))


# tests/test_torch_expand.py's RLE data (rle_deep_chains)
RLE = (b"\x00" * 5000) + (b"ab" * 4000) + (b"xyz" * 3000) + b"tail" * 500


def ex_inputs(wide_c: bytes, big_c: bytes, device, seed: int = 7):
    """(label, lz_expand arguments on `device`, timed) of the shapes the kernel is
    held at beside the main path's: the two quantile buckets of one 2 MiB
    file bucket (file_buckets), the e2e_v1_512k buckets (their commands
    from fsm_decode), tests/test_torch_expand.py's rle_deep_chains (8 KiB
    blocks, wide, optimal; commands through the kernels) with its hint and
    at hints 0 and 1, 2 x 1 MiB blocks of the fuzz draw (the masks in
    device memory), and every fuzz_expand(seed) pattern at its depth's
    hint (from expand_model; timed there), at none and at 0 and 1."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.ops.decode_v2 import fsm_decode_v2
    from nlzm_tpu_torch.parallel.blocks import encode_container, parse_container, stage_v1_buckets

    bs, buckets = file_buckets(wide_c, device)
    for i, (staged, _) in enumerate(buckets):
        yield f"file_q{i}", (*wide_commands(staged, bs), bs, staged["rounds_hint"],
                             staged["dict_arr"]), True
    del buckets
    info = parse_container(big_c)
    for i, (streams, steps, _) in enumerate(stage_v1_buckets(big_c, info, device=device)):
        yield f"v1_512k_{i}", (*fsm_decode_v2(streams, steps), info.block_size, None, None), True
    rle = encode_container(RLE, parser="optimal", profile="wide", block_size=8192)
    rinfo, rb = stage(rle, device)
    for i, (staged, _) in enumerate(rb):
        ops = wide_commands(staged, rinfo.block_size)
        for k, h in enumerate((staged["rounds_hint"], 0, 1)):
            yield (f"rle_deep_chains_{i}_h{h}", (*ops, rinfo.block_size, h, staged["dict_arr"]),
                   k == 0)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    rng = np.random.default_rng(seed)
    N = 1 << 20
    ol = rng.integers(1, 12, (N // 8, 2))
    lit = rng.random(ol.shape) < 0.5
    ol[lit] = 0
    ov = np.where(lit, rng.integers(0, 256, ol.shape), rng.integers(1, 64, ol.shape))
    yield "global_masks", (put(ol.astype(np.int32)), put(ov.astype(np.int32)), N, None, None), True
    for pat, (ol, ov, N, d) in fuzz_expand(seed).items():
        st = {}
        expand_model(ol, ov, N, None, d, st)
        depth = max([r for r in st["rounds"] if r is not None] or [0])
        for k, h in enumerate(dict.fromkeys((depth, None, 0, 1))):
            yield f"{pat}_h{h}", (put(ol), put(ov), N, h, None if d is None else put(d)), k == 0


def check_expand(tally: Tally, wide_c: bytes, v1_c: bytes, big_c: bytes, fcont: bytes,
                 device) -> dict:
    """Phase kernels_expand: lz_expand against its plain version, exact,
    untimed in the tally, at every ex_inputs shape; each input timed once
    (ex_timing) beside the main path's shapes (held in kernels,
    e2e_frontier and kernels_v1): the shipping and the frontier buckets
    at their hint and at 0 and 1, the v1 bench buckets. Returns the
    phase's fields."""
    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops.decode_v2 import fsm_decode_v2
    from nlzm_tpu_torch.parallel.blocks import parse_container, stage_v1_buckets

    t0 = time.perf_counter()
    timing = {}
    for tag, cont in (("ship", wide_c), ("frontier", fcont)):
        info, buckets = stage(cont, device)
        for i, (staged, _) in enumerate(buckets):
            ops = wide_commands(staged, info.block_size)
            for h in (staged["rounds_hint"], 0, 1):
                label = f"{tag}_b{i}" + ("" if h == staged["rounds_hint"] else f"_h{h}")
                timing[label] = ex_timing((*ops, info.block_size, h, staged["dict_arr"]))
        del buckets
    info = parse_container(v1_c)
    for i, (streams, steps, _) in enumerate(stage_v1_buckets(v1_c, info, device=device)):
        timing[f"v1_bench_b{i}"] = ex_timing((*fsm_decode_v2(streams, steps), info.block_size,
                                              None, None))
    hold_s = 0.0
    for label, ex, timed in ex_inputs(wide_c, big_c, device):
        h0 = time.perf_counter()
        tally.hold("lz_expand", lambda: xo.lz_expand_parallel(*ex),
                   lambda: xo.lz_expand_parallel_ref(*ex), timed=False)
        hold_s += time.perf_counter() - h0
        if timed:
            timing[label] = ex_timing(ex)
    return {"ex_timing": timing, "holds_seconds": hold_s, "seconds": time.perf_counter() - t0}


def asm_args(staged, block_size: int):
    """assemble's arguments on a staged wide bucket, as decode_wide_staged
    makes them: the planes through the kernels (cut to 2^15 columns on the
    packed path), raw bits, symbol counts, big, wide_delta."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    ys = wd._plane_scan_fused(staged["seeds_cat"], wd.stage_windows_of(staged), staged["n_sym"],
                              staged["steps"], staged["priors"], staged["slot_priors"])
    big = block_size > wd.CAP15
    if not big:
        ys = tuple(a[:, : min(a.shape[1], wd.CAP15)] for a in ys)
    tok_y, lit_y, len_y, lex_y, slot_y = ys
    return (tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
            staged["n_sym"][:, 0].contiguous(), big, staged["dict_arr"] is not None)


def asm_work(asm):
    """assemble's (bytes, ops) on this input's data: what a block needs
    read once and its [B, TP] pairs written. Read: tok over the block's
    live slots, len to its matches, lit to its literals, slot to its dicts
    and lex to its escapes (each at most the plane's width, the rest of a
    plane is padding), the raw-bit halfwords that hold its fields (at most
    hb), and its count; ~40 operations a slot."""
    import torch

    tok, len_, lex, lit, slot, bits, n_cmds = asm[:7]
    B, Tc = tok.shape
    head = lambda a, n: torch.arange(a.shape[1], device=a.device) < n[:, None]
    live = head(tok, n_cmds.long())
    n_lit, n_dict, n_rep = (((tok == v) & live).sum(1) for v in (0, 1, 2))
    n_match = n_dict + n_rep
    n_esc = ((len_ == 7) & head(len_, n_match)).sum(1)
    ab = torch.where(slot >= 4, ((slot >> 1) - 1).clamp(0, 16), 0)
    n_bits = (ab * head(slot, n_dict)).sum(1) + 2 * n_rep
    words = sum(int(n.clamp(max=a.shape[1]).sum())
                for a, n in ((len_, n_match), (lit, n_lit), (slot, n_dict), (lex, n_esc)))
    halves = int(((n_bits + 15) // 16).clamp(max=bits.shape[1]).sum())
    read = 4 * (int(live.sum()) + words + B) + 2 * halves
    return read + 8 * ((Tc + 1) & ~1) * B, 40 * Tc * B


def asm_shape(Tc: int, hb: int, B: int) -> dict:
    """csrc/assemble.cu's launch at this shape on this card
    (nlzm_assemble_shape): threads a CTA, slots a thread, dynamic shared
    bytes, registers a thread (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the waves of its B
    CTAs, whether the raw-bit row sits in shared memory, chunks a block."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 8)()
    st = _build.entry("assemble", "nlzm_assemble_shape", 1, 2)(
        ctypes.addressof(out), Tc, hb, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_assemble_shape: CUDA error {st}")
    threads, spt, smem, regs, ctas, sms, in_smem, chunks = out
    return dict(threads=threads, slots_per_thread=spt, smem_bytes=smem, registers=regs,
                ctas_per_sm=ctas, waves=-(-B // (ctas * sms)) if ctas else None,
                bits_in_smem=bool(in_smem), chunks=chunks)


def asm_timing(asm) -> dict:
    """_assemble_rows on these arguments: CUDA-event mean of KERNEL_REPS
    back-to-back calls (ms), its device time (device_ms, kernel_device_ms),
    ns a slot from each, the bound (asm_work) and the launch shape
    (asm_shape)."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    call = lambda: wd._assemble_rows(*asm)
    call()
    ms = timed_mean(call, KERNEL_REPS)
    dev_ms = kernel_device_ms(call, "assemble")
    B, Tc = asm[0].shape
    slots = max(B * Tc, 1)
    b_ms, b_by = bound(*asm_work(asm))
    return dict(blocks=B, Tc=Tc, big=asm[7], wide_delta=asm[8], ms=ms, device_ms=dev_ms,
                ns_per_slot=ms * 1e6 / slots,
                device_ns_per_slot=None if dev_ms is None else dev_ms * 1e6 / slots,
                bound_ms=b_ms, bound_by=b_by, **asm_shape(Tc, asm[5].shape[1], B))


def put_strided(a, device):
    """A numpy plane on `device` with its row stride: a column slice of a
    wider array stays a column slice."""
    import numpy as np
    import torch

    row = a.strides[0] // a.itemsize
    if row == a.shape[1]:
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    full = np.lib.stride_tricks.as_strided(a, (a.shape[0], row), a.strides)
    return torch.as_tensor(np.array(full), device=device)[:, : a.shape[1]]


ASM_TIMED_FUZZ = ("valid", "only_reps", "tc4096_b1", "spill_tc32768", "big_tc40000")


def asm_inputs(ship_c: bytes, front_c: bytes, device, seed: int = 7):
    """(label, assemble arguments on `device`, expansion arguments (block
    size, hint, dictionary) or None, timed) of the shapes the kernel is held
    at: the shipping buckets, the two quantile buckets of one 2 MiB file
    bucket (file_buckets), the frontier buckets (big) and every
    fuzz_assemble(seed, card=True) pattern at wide_delta false and true
    (big_tc40000 at big); ASM_TIMED_FUZZ timed at wide_delta true."""
    import numpy as np
    import torch

    for tag, make in (("ship", lambda: stage(ship_c, device)),
                      ("file", lambda: file_buckets(ship_c, device)),
                      ("frontier", lambda: stage(front_c, device))):
        bs, buckets = make()
        bs = getattr(bs, "block_size", bs)
        for i, (staged, _) in enumerate(buckets):
            yield (f"{tag}_b{i}", asm_args(staged, bs),
                   (bs, staged["rounds_hint"], staged["dict_arr"]), True)
        del buckets
    for pat, a in fuzz_assemble(seed, card=True).items():
        planes = tuple(put_strided(x, device) for x in a[:5])
        rest = (torch.as_tensor(a[5].view(np.int16), device=device),
                torch.as_tensor(a[6], device=device))
        for wide_delta in (False, True):
            big = pat.startswith("big")
            yield (f"{pat}_w{int(wide_delta)}", (*planes, *rest, big, wide_delta), None,
                   wide_delta and pat in ASM_TIMED_FUZZ)


def main_path_kernels(block_size: int, buckets) -> dict:
    """{kernel: launches} of one decode_wide_staged over each bucket under
    torch.profiler: the first of up to 5 profiles that traced
    stage_windows_kernel, assemble_kernel and lz_expand_kernel once a
    bucket each; raises when none did, so a lost trace never reads as a
    main path without a transpose."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nlzm_tpu_torch.ops import wide_decode as wd

    run = lambda: [wd.decode_wide_staged(staged, block_size) for staged, _ in buckets]
    run()
    torch.cuda.synchronize()
    want = {"stage_windows_kernel": len(buckets), "assemble_kernel": len(buckets),
            "lz_expand_kernel": len(buckets)}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages() if e.count}
        seen = {k: sum(c for n, c in names.items() if k in n) for k in want}
        if seen == want:
            return names
    raise AssertionError(f"no profile of the main path traced {want} (last: {seen})")


def check_assemble(tally: Tally, ship_c: bytes, front_c: bytes, device) -> dict:
    """Phase kernels_assemble: _assemble_rows and assemble_ops against their
    plain versions, exact, untimed in the tally, at every asm_inputs shape;
    on the shipping, file and frontier buckets _lz_expand_rows on those
    pairs against lz_expand_parallel_ref on them as [T, B] (ship and file
    at the bucket's hint and at 0 and 1), and both entries' device ms
    (rows_vs_cols); _lz_expand_rows on fuzz_expand's four fault classes
    (both shapes) given as rows, at no hint and 1; the main path's kernels
    under torch.profiler on the shipping and file buckets
    (main_path_kernels): a trace that holds assemble_kernel and
    lz_expand_kernel once a bucket and no lz_expand_transpose_kernel.
    Returns the phase's fields."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.ops import expand_ops as xo
    from nlzm_tpu_torch.ops import wide_decode as wd

    t0 = time.perf_counter()
    timing, rows_vs_cols = {}, {}
    for label, asm, ex, timed in asm_inputs(ship_c, front_c, device):
        cmds = tally.hold("assemble", lambda: wd._assemble_rows(*asm),
                          lambda: wd._rows_of(*wd.assemble_ops_ref(*asm)), timed=False)
        tally.hold("assemble", lambda: wd.assemble_ops(*asm), lambda: wd.assemble_ops_ref(*asm),
                   timed=False)
        if timed:
            timing[label] = asm_timing(asm)
        if ex is None:
            continue
        N, hint, dict_arr = ex
        B, Tc = asm[0].shape
        cols = (cmds[:, :Tc, 0].t().contiguous(), cmds[:, :Tc, 1].t().contiguous())
        hints = (hint,) if label.startswith("frontier") else tuple(dict.fromkeys((hint, 0, 1)))
        for h in hints:
            tally.hold("lz_expand", lambda: xo._lz_expand_rows(cmds, Tc, N, h, dict_arr),
                       lambda: xo.lz_expand_parallel_ref(*cols, N, h, dict_arr), timed=False)
        D = 0 if dict_arr is None else dict_arr.numel()
        rows_vs_cols[label] = {
            "rows_device_ms": kernel_device_ms(
                lambda: xo._lz_expand_rows(cmds, Tc, N, hint, dict_arr), "lz_expand"),
            "cols_device_ms": kernel_device_ms(
                lambda: xo.lz_expand_parallel(*cols, N, hint, dict_arr), "lz_expand"),
            "rows_shape": ex_shape(Tc, B, N, D, rows=True)}
        del cmds, cols, asm
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    faults = [f"{c}_{s}" for c in ("delta_big", "delta_neg", "lit_big", "past_end")
              for s in ("4k", "ship")]
    for pat, (ol, ov, N, d) in fuzz_expand(7, faults).items():
        dd = None if d is None else put(d)
        rows = wd._rows_of(put(ol), put(ov))
        for h in (None, 1):
            tally.hold("lz_expand", lambda: xo._lz_expand_rows(rows, ol.shape[0], N, h, dd),
                       lambda: xo.lz_expand_parallel_ref(put(ol), put(ov), N, h, dd),
                       timed=False)
    kernels = {}
    for tag, make in (("ship", lambda: stage(ship_c, device)),
                      ("file", lambda: file_buckets(ship_c, device))):
        bs, buckets = make()
        kernels[tag] = main_path_kernels(getattr(bs, "block_size", bs), buckets)
        del buckets
    if any("transpose" in n for k in kernels.values() for n in k):
        raise AssertionError(f"the main path transposes its commands: {kernels}")
    return {"asm_timing": timing, "rows_vs_cols": rows_vs_cols, "main_path_kernels": kernels,
            "seconds": time.perf_counter() - t0}


def sw_work(sw):
    """stage_windows' (bytes, ops): hw_cat, offs and ends read once, the
    windows written once; ~2 operations a cell."""
    hw, offs, ends, WHs = sw
    cells = sum(offs.shape[2] * hw.shape[0] * w for w in WHs)
    return nbytes(hw, offs, ends) + 4 * cells, 2 * cells


def sw_shape(B: int, NC: int) -> dict:
    """csrc/stage_windows.cu's launch at (B, NC) on this card
    (nlzm_stage_windows_shape): threads a CTA, CTAs, registers a thread,
    resident CTAs an SM, waves, chunk groups a block."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 6)()
    st = _build.entry("stage_windows", "nlzm_stage_windows_shape", 1, 2)(
        ctypes.addressof(out), B, NC, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_stage_windows_shape: CUDA error {st}")
    threads, ctas, regs, per_sm, sms, groups = out
    return dict(threads=threads, ctas=ctas, registers=regs, ctas_per_sm=per_sm,
                waves=-(-ctas // (per_sm * sms)) if per_sm else None, chunk_groups=groups)


def sw_timing(sw) -> dict:
    """stage_windows_fused on these arguments: CUDA-event mean of
    KERNEL_REPS back-to-back calls (ms), its device time (device_ms,
    kernel_device_ms), the bound (sw_work) and the launch shape (sw_shape)."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    call = lambda: wd.stage_windows_fused(*sw)
    call()
    ms = timed_mean(call, KERNEL_REPS)
    b_ms, b_by = bound(*sw_work(sw))
    B, NC = sw[0].shape[0], sw[1].shape[2]
    return dict(blocks=B, chunks=NC, H=sw[0].shape[1], WHs=list(sw[3]), ms=ms,
                device_ms=kernel_device_ms(call, "stage_windows"), bound_ms=b_ms, bound_by=b_by,
                **sw_shape(B, NC))


def sw_inputs(ship_c: bytes, front_c: bytes, device, seed: int = 7):
    """(label, stage_windows_fused arguments on `device`, timed) of the
    shapes the kernel is held at: the shipping buckets, the two quantile
    buckets of one 2 MiB file bucket, the frontier buckets (timed), and
    every fuzz_windows(seed) pattern."""
    import numpy as np
    import torch

    for tag, make in (("ship", lambda: stage(ship_c, device)),
                      ("file", lambda: file_buckets(ship_c, device)),
                      ("frontier", lambda: stage(front_c, device))):
        _, buckets = make()
        for i, (st, _) in enumerate(buckets):
            yield f"{tag}_{i}", (st["hw_cat"], st["offs"], st["ends"], st["WHs"]), True
        del buckets
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    for pat, (hw, offs, ends, WHs) in fuzz_windows(seed).items():
        yield pat, (put(hw.view(np.int16)), put(offs), put(ends), WHs), False


def bits_work(fields, cap: int):
    """bits_forward's (bytes, ops): the four fields read once, the sections
    and counts written once; ~20 operations a step (masks, scan, two
    fields packed)."""
    T, B = fields[1].shape
    return nbytes(*fields) + B * (cap + 4), 20 * T * B


def bits_group(B: int, cap: int) -> int:
    """csrc/bits_forward.cu's blocks a CTA (group_of): 8, halved while the
    grid would have fewer than 16 G CTAs or G sections would pass
    BITS_SMEM_MAX."""
    sec = 4 * ((((cap + 3) // 4) + 1) | 1)
    G = 8
    while G > 1 and (G * sec > BITS_SMEM_MAX or -(-B // G) < 16 * G):
        G //= 2
    return G


def bits_shape(B: int, cap: int) -> dict:
    """csrc/bits_forward.cu's launch at (B, cap) on this card
    (nlzm_bits_shape): blocks a CTA, threads a CTA, dynamic shared bytes,
    registers a thread, resident CTAs an SM, waves, steps a tile."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build

    out = (ctypes.c_int * 7)()
    st = _build.entry("bits_forward", "nlzm_bits_shape", 1, 2)(
        ctypes.addressof(out), B, cap, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_bits_shape: CUDA error {st}")
    G, threads, smem, regs, per_sm, sms, tile = out
    ctas = -(-B // G)
    return dict(blocks_per_cta=G, threads=threads, smem_bytes=smem, registers=regs,
                ctas=ctas, ctas_per_sm=per_sm,
                waves=-(-ctas // (per_sm * sms)) if per_sm else None, tile_steps=tile)


def bits_timing(fields, cap: int) -> dict:
    """bits_forward on these fields: CUDA-event mean of KERNEL_REPS
    back-to-back calls (ms), its device time (device_ms), the bound
    (bits_work) and the launch shape (bits_shape)."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    call = lambda: eo.bits_forward(fields, cap)
    call()
    ms = timed_mean(call, KERNEL_REPS)
    b_ms, b_by = bound(*bits_work(fields, cap))
    T, B = fields[1].shape
    return dict(steps=T, blocks=B, cap=cap, ms=ms,
                device_ms=kernel_device_ms(call, "bits_forward"), bound_ms=b_ms, bound_by=b_by,
                **bits_shape(B, cap))


def v1_commands(data: bytes, device):
    """The v1 device encode's greedy commands of `data` at V1_ENC's blocks
    (find_matches, greedy_cover): (op_len, op_val), [T, B] on `device`."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    N = V1_ENC["block_size"]
    arr, nv = eo._blocks_arrays(data, N)
    dt, nvt = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    delta, mlen = eo.find_matches(dt, nvt, (1 << V1_ENC_HIST_BITS) - 1)
    return eo.greedy_cover(dt, delta, mlen, nvt, eo.frame_caps(N)[0])


def v1_fields(data: bytes, device):
    """The v1 device encode's raw-bit fields of `data` at V1_ENC's blocks
    (v1_commands, repify, emit_model) and its bits cap."""
    from nlzm_tpu_torch.ops import encode_ops as eo

    op_len, op_val = v1_commands(data, device)
    _, fields, _ = eo.emit_model(op_len, op_val, eo.repify(op_len, op_val))
    return fields, eo.frame_caps(V1_ENC["block_size"])[2]


# blocks of the v1 fields bits_forward is timed at: the v1 bench (8 MiB at
# 8 KiB blocks), a 2 MiB file bucket and a 64 KiB file
BITS_BLOCKS = (1024, STREAM_BUCKET // V1_ENC["block_size"], 8)


def bits_inputs(data: bytes, device, seed: int = 7, blocks=BITS_BLOCKS):
    """(label, (fields on `device`, cap), timed) of the shapes bits_forward
    is held at: the v1 fields of `data` (the v1 bench's, 1024 x 8192) and of
    each of its first `blocks` blocks (a block's fields are those of its own
    bytes: 256 blocks are a 2 MiB file bucket's, 8 a 64 KiB file's), timed,
    and every fuzz_bits(seed, card=True) pattern."""
    import numpy as np
    import torch

    fields, cap = v1_fields(data, device)
    T, B = fields[0].shape
    for nb in blocks:
        nb = min(nb, B)
        yield f"v1_{nb}x{T}", (tuple(f[:, :nb].contiguous() for f in fields), cap), True
    del fields
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    for pat, (f, cap) in fuzz_bits(seed, card=True).items():
        yield pat, (tuple(put(a) for a in f), cap), False


def v1_encode_kernels(data: bytes, device) -> dict:
    """{kernel: launches} of one v1 device encode (V1_ENC) under
    torch.profiler: the first of up to 3 profiles that traced one
    bits_forward_kernel; raises when none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nlzm_tpu_torch.parallel.blocks import encode_container

    run = lambda: encode_container(data, device=device, engine="device", **V1_ENC)
    run()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages() if e.count}
        if sum(c for n, c in names.items() if "bits_forward_kernel" in n) == 1:
            return names
    raise AssertionError(f"no profile of the v1 encode traced one bits_forward_kernel: {names}")


def check_pack(tally: Tally, ship_c: bytes, front_c: bytes, data: bytes, device) -> dict:
    """Phase kernels_pack: stage_windows at every sw_inputs shape and
    bits_forward at every bits_inputs shape against their plain versions,
    exact, untimed in the tally (and bits_forward's blocks a CTA against
    bits_group's); the buckets and the v1 fields timed
    (sw_timing, bits_timing); the v1 encode's kernels under torch.profiler
    (v1_encode_kernels). Returns the phase's fields."""
    from nlzm_tpu_torch.ops import encode_ops as eo
    from nlzm_tpu_torch.ops import wide_decode as wd

    t0 = time.perf_counter()
    windows, bits = {}, {}
    for label, sw, timed in sw_inputs(ship_c, front_c, device):
        tally.hold("stage_windows", lambda: wd.stage_windows_fused(*sw),
                   lambda: wd.stage_windows_fused_ref(*sw), timed=False)
        if timed:
            windows[label] = sw_timing(sw)
        del sw
    for label, (fields, cap), timed in bits_inputs(data, device):
        tally.hold("bits_forward", lambda: eo.bits_forward(fields, cap),
                   lambda: eo.bits_forward_ref(fields, cap), timed=False)
        B = fields[0].shape[1]
        if bits_shape(B, cap)["blocks_per_cta"] != bits_group(B, cap):
            raise AssertionError(f"bits_forward at {label}: the kernel's G differs from "
                                 f"bits_group's {bits_group(B, cap)}")
        if timed:
            bits[label] = bits_timing(fields, cap)
        del fields
    return {"sw_timing": windows, "bits_timing": bits,
            "v1_encode_kernels": v1_encode_kernels(data, device),
            "seconds": time.perf_counter() - t0}


def check_fm(tally: Tally, corpus: bytes, device) -> dict:
    """Phase kernels_fm: find_matches against its plain version, exact,
    untimed in the tally, at every fm_inputs shape; each timed
    (fm_timing), and the wide encodes' 245 x 32768 (one and three
    candidates, held in kernels_enc) timed beside them. Returns the
    phase's fields."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    timing = {}
    arr, nv = eo._blocks_arrays(corpus[:SHIP_BYTES], ENC_GREEDY["block_size"])
    wt, wnvt = torch.as_tensor(arr, device=device), torch.as_tensor(nv, device=device)
    for C in (1, 3):
        timing[f"wide_245x32768_c{C}"] = fm_timing(wt, wnvt, (1 << ENC_HIST_BITS) - 1, C)
    del wt, wnvt
    for label, (dt, nvt, reach, C) in fm_inputs(corpus, device):
        tally.hold("find_matches", lambda: eo.find_matches(dt, nvt, reach, C),
                   lambda: eo.find_matches_ref(dt, nvt, reach, C), timed=False)
        timing[label] = fm_timing(dt, nvt, reach, C)
    return {"fm_timing": timing}


def check_rans(tally: Tally, device) -> dict:
    """Phase kernels_rans: the kernel's span records (nlzm_rans_records: a
    and the magic) for every f in 1..65535 against rans_magic's, exact;
    rans_backward against its plain version, exact, on every fuzz_spans
    pattern at 16 x 4096 at its frame cap (timed: rans_timing) and at
    caps 1024, 101 and 37, and on dense spans at 1024 x 8192 (timed).
    Returns the phase's fields."""
    import numpy as np
    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    dev = torch.device(device)
    rec = torch.empty(1 << 16, 3, dtype=torch.int32, device=dev)
    st = _build.entry("rans_backward", "nlzm_rans_records", 1, 1)(
        rec.data_ptr(), 1 << 16, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if st:
        raise RuntimeError(f"nlzm_rans_records: CUDA error {st}")
    f = np.arange(1, 1 << 16)
    want = np.stack([np.where(f == 1, 1 << 14, 1), *rans_magic(f)], 1)
    if not (rec.cpu().numpy().view(np.uint32)[1:] == want).all():
        raise AssertionError("nlzm_rans_records differs from rans_magic")
    worst = {}
    for B, T, names in ((16, 4096, None), (1024, V1_ENC["block_size"], ("dense",))):
        for pat, arr in fuzz_spans(7, T, B, names).items():
            sp = torch.as_tensor(arr, device=dev)
            cap = rans_frame_cap(sp.shape[0])
            for c in (cap, 1024, 101, 37) if B == 16 else (cap,):
                tally.hold("rans_backward", lambda: eo.rans_backward(sp, c),
                           lambda: eo.rans_backward_ref(sp, c), timed=False)
            worst[pat if B == 16 else f"{pat}_1024x8192"] = rans_timing(sp, cap)
            del sp
    return {"records_checked": (1 << 16) - 1, "worst_cases": worst,
            "worst_cases_shape": "fuzz_spans(7) patterns at 16 x 4096 (ragged 4059 x 13, "
            "one_row 1 x 15) and dense at 1024 x 8192, each at its frame cap"}


def check_rep(tally: Tally, device) -> dict:
    """Phase kernels_rep: REP_S, REP_R and REP_GUESS held to the kernel's
    own (nlzm_repify_scheme); repify (csrc/repify.cu) against its plain
    version, exact, on every fuzz_rep pattern at 16 x 4096 and at 1024 x
    8192, the second timed (rep_timing); then, untimed, hostile and
    random6 with segments longer than the kernel's match masks reach, at
    each of its CTA widths (16 x 70000: 4 blocks a CTA, 1094 rows a
    segment; 528 x 33000: 8 blocks a CTA, 516 rows). Returns the phase's
    fields."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.ops import encode_ops as eo

    scheme = (ctypes.c_int * 6)()
    _build.entry("repify", "nlzm_repify_scheme", 1, 0)(ctypes.addressof(scheme), 0, None)
    if tuple(scheme) != (REP_S, REP_R, *REP_GUESS):
        raise AssertionError(f"csrc/repify.cu's S, R, guess {tuple(scheme)} are not "
                             f"REP_S, REP_R, REP_GUESS {(REP_S, REP_R, *REP_GUESS)}")
    worst = {}
    for B, T, timed, names in ((16, 4096, False, None), (1024, V1_ENC["block_size"], True, None),
                               (16, 70000, False, ("hostile", "random6")),
                               (528, 33000, False, ("hostile", "random6"))):
        for pat, cmds in fuzz_rep(7, B, T, names).items():
            ol, ov = (torch.as_tensor(a, device=device) for a in cmds)
            tally.hold("repify", lambda: eo.repify(ol, ov), lambda: eo.repify_ref(ol, ov),
                       timed=False)
            if timed:
                worst[pat] = rep_timing(ol, ov)
            del ol, ov
    return {"worst_cases": worst, "worst_cases_shape": "fuzz_rep(7) patterns at 1024 x 8192 "
            "(ragged 8165 x 1021, one_row 1 x 1023); also held at 16 x 4096"}


def check_cover(tally: Tally, corpus: bytes, device) -> dict:
    """Phase kernels_cover: greedy_cover and dp_cover (csrc/greedy_cover.cu)
    against their plain versions, exact, at every shape they run: the v1
    encodes' 1024 x 8192 and the wide encodes' 245 x 32768 (dp on the
    first round's choices, C = 3), the global-scratch path at 128 KiB
    blocks (1 MiB), 1 MiB of long matches at 8 KiB blocks, fuzz_opt, and
    every fuzz_cover pattern at 16 x 4096, at 1024 x 8192 and at 4 x
    131072; each timed but fuzz_opt's and the small fuzz_cover's
    (cover_timing). Returns the phase's fields."""
    import torch

    from nlzm_tpu_torch.ops import encode_ops as eo

    put = lambda a: torch.as_tensor(a, device=device)

    def hold(name, args, T, into=None, key=None):
        kernel, plain = getattr(eo, name), getattr(eo, f"{name}_ref")
        out = tally.hold(name, lambda: kernel(*args, T), lambda: plain(*args, T), timed=False)
        if into is not None:
            into.setdefault(key, {})[name] = cover_timing(name, args, T, out)

    def parsed(data: bytes, N: int, reach: int, into, key):
        arr, nv = eo._blocks_arrays(data, N)
        dt, nvt = put(arr), put(nv)
        T = (N + 255) // 256 * 256
        hold("greedy_cover", (dt, *eo.find_matches(dt, nvt, reach), nvt), T, into, key)
        d3, m3 = eo.find_matches(dt, nvt, reach, 3)
        hold("dp_cover", (dt, d3, *eo.dp_parse(d3, m3, nvt), nvt), T, into, key)

    def patterns(seed, B, N, into=None):
        for pat, f in fuzz_cover(seed, B, N).items():
            g = tuple(put(f[k]) for k in ("data", "delta", "mlen", "n_valid"))
            hold("greedy_cover", g, f["num_steps"], into, pat)
            d = tuple(put(f[k]) for k in ("data", "delta3", "choice_len", "choice_cand", "n_valid"))
            hold("dp_cover", d, f["num_steps"], into, pat)
            del g, d

    shapes, worst = {}, {}
    v1, wide = V1_ENC["block_size"], WIDE_OPT["block_size"]
    parsed(corpus[:V1_ENC_BYTES], v1, (1 << V1_ENC_HIST_BITS) - 1, shapes, "v1_1024x8192")
    parsed(corpus[:SHIP_BYTES], wide, (1 << ENC_HIST_BITS) - 1, shapes, "wide_245x32768")
    big = BIG_COVER["block_size"]
    parsed(corpus[:BIG_COVER["bytes"]], big, big - 1, shapes, "global_8x131072")
    parsed(long_match_data(11), v1, (1 << V1_ENC_HIST_BITS) - 1, worst, "long_match_128x8192")
    fz = fuzz_opt(7)
    T = fz["data"].shape[1] + 64
    hold("greedy_cover", tuple(put(a) for a in (fz["data"], fz["delta"][..., 0],
                                                fz["mlen"][..., 0], fz["n_valid"])), T)
    hold("dp_cover", tuple(put(fz[k]) for k in ("data", "delta", "choice_len", "choice_cand",
                                                "n_valid")), T)
    patterns(7, 16, 4096)
    patterns(7, 1024, v1, worst)
    patterns(7, 4, big)
    return {"shapes": shapes, "worst_cases": worst,
            "worst_cases_shape": "fuzz_cover(7) patterns at 1024 x 8192; long_match_data(11)"}


def exact_launches(label: str, launches: dict, per_run: dict, runs: int = 1) -> None:
    """Fail unless the kernels launched are those of per_run, each per_run
    times runs (the table of one optimal-parse encode; a file encode runs it
    once per bucket)."""
    want = {n: c * runs for n, c in per_run.items()}
    got = {n: c for n, c in launches.items() if c}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def run_opt_encode(tally: Tally, data: bytes, device, card: str, greedy: dict):
    """Phases kernels_opt, e2e_enc_v1_opt, e2e_enc_wide_opt and
    stream_enc_v1_opt; greedy = {phase: ratio} of the greedy encodes.
    Returns {path: main-path launches}."""
    from nlzm_tpu_torch import encode_container_stream, native
    from nlzm_tpu_torch.ops.encode_ops import parse_blocks_device
    from nlzm_tpu_torch.ops.wide_encode_dev import encode_wide_blocks_device
    from nlzm_tpu_torch.parallel.blocks import (
        block_payloads, decode_container, encode_container, parse_container)

    shape = check_kernels_opt(tally, data, device)
    emit({"phase": "kernels_opt", "ok": True, **shape, "kernels": tally.summary(OPT_KERNELS),
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls (dp_parse: summed "
                    f"over its two cost rows); plain: 1 call (its comparison call past 1 s; "
                    f"measure_costs {KERNEL_REPS})", "card": card})

    N = V1_OPT["block_size"]
    by_path = {}
    enc = lambda: encode_container(data, device=device, engine="device", **V1_OPT)
    container, by_path["e2e_enc_v1_opt"] = launched("e2e_enc_v1_opt", V1OPT_KERNELS, enc)
    exact_launches("e2e_enc_v1_opt", by_path["e2e_enc_v1_opt"], V1_OPT_LAUNCHES)
    info = parse_container(container)
    for b, p in enumerate(block_payloads(container, info)):
        if native.decode_block(p, info.hist_bits, N) != data[b * N : (b + 1) * N]:
            raise AssertionError(f"e2e_enc_v1_opt: native.decode_block differs on block {b}")
    if decode_container(container, device=device) != data:
        raise AssertionError("e2e_enc_v1_opt: the card's decode differs from the input")
    e2e = best_ms(enc, REPS)
    emit({"phase": "e2e_enc_v1_opt", "ok": True, "bytes": len(data),
          "container_bytes": len(container), "ratio": len(container) / len(data),
          "greedy_ratio": greedy["e2e_enc_v1"], "blocks": len(info.comp_sizes),
          "launches": by_path["e2e_enc_v1_opt"], "e2e_ms": e2e, "e2e_MBps": len(data) / e2e / 1e3,
          "timing": f"CUDA events around encode_container, best of {REPS}", "card": card})

    wdata = data[:SHIP_BYTES]
    wenc = lambda: encode_container(wdata, device=device, engine="device", **WIDE_OPT)
    wcont, by_path["e2e_enc_wide_opt"] = launched("e2e_enc_wide_opt", WIDEOPT_KERNELS, wenc)
    exact_launches("e2e_enc_wide_opt", by_path["e2e_enc_wide_opt"], WIDE_OPT_LAUNCHES)
    op_len, op_val, op_rep, _ = parse_blocks_device(
        wdata, WIDE_OPT["block_size"], ENC_HIST_BITS, parser="optimal", device=device)
    pd, bd = encode_wide_blocks_device(op_len, op_val, op_rep, device=device)
    if (pd, bd) != native.wide_encode(op_len, op_val, op_rep):
        raise AssertionError("e2e_enc_wide_opt: device payloads differ from native.wide_encode")
    winfo = parse_container(wcont)
    if block_payloads(wcont, winfo) != pd or winfo.wide_priors != bd:
        raise AssertionError("e2e_enc_wide_opt: the container does not hold these payloads")
    if decode_container(wcont, device=device) != wdata:
        raise AssertionError("e2e_enc_wide_opt: the card's decode differs from the input")
    e2e = best_ms(wenc, WIDE_OPT_REPS)
    emit({"phase": "e2e_enc_wide_opt", "ok": True, "bytes": len(wdata),
          "container_bytes": len(wcont), "ratio": len(wcont) / len(wdata),
          "greedy_ratio": greedy["e2e_enc_greedy"], "blocks": len(winfo.comp_sizes),
          "commands": int((op_len >= 0).sum()), "launches": by_path["e2e_enc_wide_opt"],
          "e2e_ms": e2e, "e2e_MBps": len(wdata) / e2e / 1e3,
          "timing": f"CUDA events around encode_container, best of {WIDE_OPT_REPS}",
          "card": card})

    build = Path(__file__).resolve().parent / ".build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.nlzp"
        src.write_bytes(data)
        t0 = time.perf_counter()
        r, by_path["stream_enc_v1_opt"] = launched(  # at the default parser, "optimal"
            "stream_enc_v1_opt", V1OPT_KERNELS, lambda: encode_container_stream(
                str(src), str(dst), N, device=device, engine="device",
                bucket_bytes=STREAM_BUCKET))
        secs = time.perf_counter() - t0
        buckets = -(-len(data) // STREAM_BUCKET)
        exact_launches("stream_enc_v1_opt", by_path["stream_enc_v1_opt"], V1_OPT_LAUNCHES,
                       buckets)
        if dst.read_bytes() != container:
            raise AssertionError("stream_enc_v1_opt: the file differs from e2e_enc_v1_opt's")
        # a block above the one-frame limit raises before anything is written
        bad = Path(tmp) / "bad.nlzp"
        try:
            encode_container_stream(str(src), str(bad), 2 * N, device=device, engine="device")
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("stream_enc_v1_opt: a block above one frame did not raise")
        if bad.exists() or sorted(p.name for p in Path(tmp).iterdir()) != ["in.bin", "out.nlzp"]:
            raise AssertionError("stream_enc_v1_opt: the failed encode left a file behind")
    if r != {"in": len(data), "out": len(container), "crc32": zlib.crc32(data)}:
        raise AssertionError(f"stream_enc_v1_opt: result {r}")
    emit({"phase": "stream_enc_v1_opt", "ok": True, "bytes": len(data),
          "bucket_bytes": STREAM_BUCKET, "buckets": buckets,
          "launches": by_path["stream_enc_v1_opt"], "seconds": secs,
          "MBps": len(data) / secs / 1e6, "refused": refused,
          "timing": "host clock, one call, file to file", "card": card})
    return by_path


def synth_plane(fields, seed: int, blocks: int = SYNTH_BLOCKS, max_count: int = 4000):
    """A synthetic dst spec's plane over `blocks` blocks of up to
    `max_count` symbols, from a seed: (spec, counts [B], per-read symbols,
    per-read rows (None for one row), ctx, steps, per-read prior), numpy
    int32; read r > 0 is keyed by row0 * 8 + the previous read's symbol,
    as the decoder keys it."""
    import numpy as np

    from nlzm_tpu_torch.format import wide

    spec = wide.PlaneSpec(*fields)
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count + 1, blocks).astype(np.int32)
    steps = wide.padded_steps(int(counts.max()), spec.lanes)
    shape = (blocks, steps * spec.lanes)
    live = np.arange(shape[1])[None, :] < counts[:, None]
    ctx = np.where(live, rng.integers(0, spec.rows[0], shape), 0).astype(np.int32)
    syms, rows = [], []
    for r in range(spec.reads):
        row = ctx if r == 0 else ctx * 8 + syms[-1]
        rows.append(None if spec.rows[r] == 1 else row.astype(np.int32))
        syms.append(np.where(live, rng.integers(0, spec.alphabets[r], shape), 0).astype(np.int32))
    prior = [rng.integers(0, 300, (spec.rows[r], spec.alphabets[r])).astype(np.int32)
             for r in range(spec.reads)]
    return spec, counts, syms, rows, ctx, steps, prior


def plane_decode_work(args):
    """plane_scan's (bytes, ops) for one plane: seeds, windows, counts,
    priors and (where a multi-row read keys on them) context rows in,
    symbols out; per live symbol and read log2(alph) compares (the least
    a search takes) and ~10 operations of rANS state, per chunk, block
    and table entry ~4 to rebuild."""
    from nlzm_tpu_torch.format.wide import PLANES, chunk_schedule

    seeds, wins, n_sym, ctx, idx, steps, prior = args
    spec = PLANES[idx]
    B = n_sym.shape[0]
    live = int(n_sym.long().sum())
    table = sum(spec.rows[r] * spec.alphabets[r] for r in range(spec.reads))
    keyed = spec.rows[0] > 1 or (spec.name == "dst" and max(spec.rows[1:], default=1) > 1)
    return (nbytes(seeds, wins, n_sym, ctx if keyed else None, *(prior or ()))
            + 4 * B * steps * spec.lanes * spec.reads,
            live * sum(a.bit_length() + 10 for a in spec.alphabets)
            + len(chunk_schedule(steps)) * B * table * 4)


def pd_ship_jobs(container: bytes, device):
    """The ten wire planes of the container's buckets as plane_scan
    arguments (each plane at its own step count, with the container's
    priors), each beside plane_scan_fused's symbols of the plane."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.format import wide
    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.parallel.blocks import block_payloads

    put = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    info, buckets = stage(container, device)
    payloads = block_payloads(container, info)
    priors = wide.parse_priors(info.wide_priors)
    jobs = []
    for staged, idx in buckets:
        fused = wd.plane_scan_fused(staged["seeds_cat"], wd.stage_windows_of(staged),
                                    staged["n_sym"], staged["steps"], staged["priors"])
        parsed = [wide.parse_payload(payloads[b]) for b in idx]
        for p, spec in enumerate(wide.PLANES):
            counts = [c[0][p] for c in parsed]
            steps = wide.padded_steps(max(counts), spec.lanes)
            seeds, wins = wd.stage_plane([c[1][p] for c in parsed], [c[2][p] for c in parsed],
                                         p, steps, device=device)
            ctx = torch.zeros(len(idx), steps * spec.lanes, dtype=torch.int32, device=device)
            jobs.append(((seeds, wins, put(counts), ctx, p, steps,
                          tuple(put(a) for a in priors[spec.name])), fused[p]))
    return jobs


@contextmanager
def dst_spec(spec):
    """wide.PLANES with `spec` in place of dst (plane 4) inside the block."""
    from nlzm_tpu_torch.format import wide

    planes = wide.PLANES
    wide.PLANES = planes[:4] + (spec,)
    try:
        yield
    finally:
        wide.PLANES = planes


def pd_round_trip(fields, seed: int, device):
    """A synthetic spec's symbols (synth_plane) through plane_encode,
    plane_streams, stage_plane and plane_scan, inside dst_spec: (spec,
    plane_scan's arguments, its symbols, the encoded symbols)."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.ops import wide_decode as wd
    from nlzm_tpu_torch.ops import wide_encode_dev as we

    put = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    spec, counts, syms, rows, ctx, steps, prior = synth_plane(fields, seed)
    pr = tuple(put(a) for a in prior)
    with dst_spec(spec):
        enc = we.plane_encode(tuple(put(a) for a in syms),
                              tuple(None if r is None else put(r) for r in rows),
                              put(counts), 4, steps, pr)
        streams, offsets = we.plane_streams(spec, steps, *enc)
        seeds, wins = wd.stage_plane(streams, list(offsets), 4, steps, device=device)
        args = (seeds, wins, put(counts), put(ctx), 4, steps, pr)
        return spec, args, wd.plane_scan(*args), syms


PD_HOSTILE = (-1, -7, 4, 31, 32, 1 << 29, (1 << 29) + 3, 1 << 28, -(1 << 31))


def hostile_rows(args, seed: int):
    """plane_scan's arguments with ~30% of the context rows replaced by
    PD_HOSTILE values (negative, past the table, large enough that row0 *
    8 wraps in i32)."""
    import numpy as np
    import torch

    ctx = args[3].cpu().numpy().copy()
    rng = np.random.default_rng(seed)
    hit = rng.random(ctx.shape) < 0.3
    ctx[hit] = rng.choice(np.array(PD_HOSTILE), int(hit.sum()))
    return args[:3] + (torch.as_tensor(ctx, device=args[3].device),) + args[4:]


def pd_shape(args) -> dict:
    """csrc/plane_decode.cu's launch for plane_scan's arguments on this card
    (nlzm_pd_shape): the path and kernel variant, CTAs, threads, shared
    bytes (dynamic and static), registers a thread, resident CTAs an SM,
    waves, each read's table kind."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.format.wide import PLANES
    from nlzm_tpu_torch.ops import wide_decode as wd

    seeds, wins, n_sym, ctx, idx, steps, prior = args
    spec = PLANES[idx]
    prior = (None,) * spec.reads if prior is None else prior
    outs = [torch.empty(1, 16, dtype=torch.int32, device=seeds.device) for _ in prior]
    fields = wd._pd_fields(seeds, wins, n_sym, ctx, spec, steps, prior, outs)
    lay = wd.plane_decode_layout(spec, int(wins.shape[2]))
    out = (ctypes.c_int * 6)()
    st = _build.entry("plane_decode", "nlzm_pd_shape", 2, 0)(
        fields.ctypes.data, ctypes.addressof(out), torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_pd_shape: CUDA error {st}")
    variant, threads, static, regs, ctas, sms = out
    B = seeds.shape[0]
    kinds = {wd.PD_REG: "reg", wd.PD_BITMAP: "bitmap", wd.PD_SEARCH: "search"}
    return dict(path="warp" if lay.warp else "general", variant=variant, ctas=B,
                threads=threads, smem_bytes=lay.smem + static, registers=regs,
                ctas_per_sm=ctas, waves=-(-B // (ctas * sms)) if ctas else None,
                tables=[kinds[k] for k in lay.kinds])


def calls_device_ms(fn, key: str, reps: int = KERNEL_REPS):
    """Device ms a call of fn(): every launch of the kernels whose name
    holds `key` in reps calls, summed, over reps (torch.profiler, one
    session after one warm-up call; up to 3 sessions until one traces
    any). None if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        tot = sum((getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
                  for e in prof.key_averages() if key in e.key and e.count)
        if tot:
            return tot / reps / 1e3
    return None


def check_plane_decode(tally: Tally, container: bytes, device):
    """Phase 23: the unfused plane decode on the five wire planes of the
    container's buckets (each plane at its own step count, with the
    container's priors, through the entry without the prior check) against
    its plain version, and their symbols against plane_scan_fused's; the
    ten planes' device ms from one profiler session; then the synthetic
    specs' round trips, and the kernel against its plain version on them,
    also under hostile context rows (untimed). Returns ({path: launches},
    shape info)."""
    import numpy as np
    import torch

    from nlzm_tpu_torch.ops import wide_decode as wd

    jobs = pd_ship_jobs(container, device)
    for args, _ in jobs:
        tally.hold("plane_decode", lambda: wd._plane_scan(*args),
                   lambda: wd.plane_scan_ref(*args), reps_plain=1, work=plane_decode_work(args))
    paths = {}
    ys, paths["plane_decode_ship"] = launched(
        "plane_decode_ship", ("plane_decode",), lambda: [wd.plane_scan(*a) for a, _ in jobs])
    for (args, fused_p), (y,) in zip(jobs, ys):
        live = torch.arange(y.shape[1], device=device)[None, :] < args[2][:, None]
        if not torch.equal(torch.where(live, y, 0), torch.where(live, fused_p[:, : y.shape[1]], 0)):
            raise AssertionError(f"kernels_plane_decode: plane {args[4]} differs from "
                                 f"plane_scan_fused's symbols")
    ship_dev = calls_device_ms(lambda: [wd._plane_scan(*a) for a, _ in jobs], "plane_decode")

    synth = {}
    for seed, (name, fields) in enumerate(SYNTH_PLANES.items()):
        (spec, args, ys, syms), paths[f"plane_roundtrip_{name}"] = launched(
            f"plane_roundtrip {name}", ("plane_encode", "plane_decode"),
            lambda: pd_round_trip(fields, seed, device))
        if any(not np.array_equal(y.cpu().numpy(), a) for y, a in zip(ys, syms, strict=True)):
            raise AssertionError(f"kernels_plane_decode: {name} did not round-trip")
        hargs = hostile_rows(args, seed)
        with dst_spec(spec):
            tally.hold("plane_decode", lambda: wd.plane_scan(*args),
                       lambda: wd.plane_scan_ref(*args), timed=False)
            tally.hold("plane_decode", lambda: wd.plane_scan(*hargs),
                       lambda: wd.plane_scan_ref(*hargs), timed=False)
            synth[name] = {"spec": fields, "blocks": SYNTH_BLOCKS, "steps": args[5],
                           "symbols": int(args[2].long().sum()), "shape": pd_shape(args)}
    return paths, {"buckets": [a[0].shape[0] for a, _ in jobs[::5]],
                   "plane_steps": [a[5] for a, _ in jobs], "ship_device_ms": ship_dev,
                   "ship_shapes": [pd_shape(a) for a, _ in jobs[:5]], "synthetic": synth}


def ppm_rows(args, out):
    """(rows, groups): the (table, row) pairs and the (table, 16-row
    group) pairs each chunk of each block reads at a live step, summed
    over chunks and blocks, from _decode_blocks' arguments and output."""
    import torch

    from nlzm_tpu_torch.research import ppm_tpu

    words, seg_lens, prior, steps = args
    B, L = seg_lens.shape
    dev = out.device
    y = out.long()  # [B, steps, L]; a lane decodes a prefix of its steps
    prev = torch.nn.functional.pad(y, (0, 0, 1, 0))[:, :-1]
    prev2 = torch.nn.functional.pad(y, (0, 0, 2, 0))[:, :-2]
    live = torch.arange(steps, device=dev)[None, :, None] < seg_lens.long()[:, None, :]
    sched = ppm_tpu.chunk_schedule(steps)
    chunk = torch.repeat_interleave(torch.arange(len(sched), device=dev),
                                    torch.tensor(sched, device=dev))
    key = (chunk[None, :, None] * B + torch.arange(B, device=dev)[:, None, None]) * 2
    rows = rgroups = 0
    for t, row in enumerate(((prev << 4) | (prev2 >> 4), ((y >> 4) << 8) | prev)):
        k = ((key + t) * ppm_tpu.ROWS + row)[live]
        rows += int(torch.unique(k).numel())
        rgroups += int(torch.unique(k // ppm_tpu.GROUP).numel())
    return rows, rgroups


def ppm_decode_work(args, out):
    """_decode_blocks' (bytes, ops) on this run's data: words, segment
    lengths and prior in, bytes out; per live byte 2 reads of ~40
    operations (17 fence compares, selects, rANS state, rank, count).
    A table row's fences matter only in a chunk that reads the row, and
    a carry no chunk added to only halves (a shift, deferred until the
    row is read), so the rebuild counts, per chunk and table, each row
    the chunk reads (~10 operations for each of its 16 entries) and each
    16-row group it reads from (the group sum: ~2 for each of 256):
    ppm_rows."""
    words, seg_lens, prior, steps = args
    B, L = seg_lens.shape
    rows, rgroups = ppm_rows(args, out)
    live_n = int(seg_lens.long().clamp(0, steps).sum())
    return (nbytes(words, seg_lens, prior) + B * steps * L,
            2 * live_n * 40 + rows * 16 * 10 + rgroups * 16 * 16 * 2)


def ppm_shape(B: int, W: int) -> dict:
    """csrc/ppm_decode.cu's launch at B blocks of W words on this card
    (nlzm_ppm_shape): threads a CTA, dynamic shared bytes, registers a
    thread (cudaFuncGetAttributes), resident CTAs an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), cache slots, whether
    the stream is read from shared memory, and the waves of B CTAs."""
    import ctypes

    import torch

    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.research import ppm_tpu

    out = (ctypes.c_int * 9)()
    st = _build.entry("ppm_decode", "nlzm_ppm_shape", 1, 2)(
        ctypes.addressof(out), B, W, torch.cuda.current_device(), None)
    if st:
        raise RuntimeError(f"nlzm_ppm_shape: CUDA error {st}")
    threads, smem, regs, ctas, sms, sw_max, cache, tables, in_smem = out
    if (sw_max, cache, tables) != (PPM_SW_MAX, PPM_CACHE, ppm_tpu.TABLES_INTS):
        raise AssertionError(f"csrc/ppm_decode.cu's stream words, cache slots and tables ints "
                             f"{(sw_max, cache, tables)} are not chip_smoke's")
    return dict(threads=threads, smem_bytes=smem, registers=regs, ctas_per_sm=ctas,
                cache_slots=cache, stream_in_smem=bool(in_smem),
                waves=-(-B // (ctas * sms)) if ctas else None)


def ppm_random(args, B: int, steps: int, W: int, seed: int):
    """_decode_blocks arguments of random words: B blocks of W random words,
    every lane's segment steps long (full blocks), args' prior."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    words = torch.randint(-(1 << 31), 1 << 31, (B, W), generator=g, dtype=torch.int64)
    dev = args[0].device
    return (words.to(torch.int32).to(dev), torch.full((B, 32), steps, dtype=torch.int32,
                                                      device=dev), args[2], steps)


def ppm_timing(args) -> dict:
    """ppm_decode on these staged arrays: CUDA-event mean (ms), the kernel's
    device time (kernel_device_ms), ns a read of one block's chain (steps x
    2 reads), the rows and groups it built (its counters) beside the
    bound's (ppm_rows), the rows built into device memory, the batches
    (reads that built rows), its bound (ppm_decode_work) and the launch
    shape (ppm_shape)."""
    from nlzm_tpu_torch.research import ppm_tpu

    B, W = args[0].shape
    steps = args[3]
    call = lambda: ppm_tpu._decode_blocks(*args)
    out, built = ppm_tpu._decode_blocks_cuda(*args)
    n = dict(zip(ppm_tpu.BUILT, built.sum(0).tolist()))
    rows, groups = ppm_rows(args, out)
    ms = timed_mean(call, KERNEL_REPS)
    b_ms, b_by = bound(*ppm_decode_work(args, out))
    return dict(blocks=B, W=W, steps=steps, ms=ms, device_ms=kernel_device_ms(call, "ppm"),
                ns_per_read=ms * 1e6 / max(2 * steps, 1), rows_built=n["rows"],
                groups_built=n["groups"], bound_rows=rows, bound_groups=groups,
                group_sums=n["group_sums"], spilled_rows=n["spilled_rows"],
                batches=n["batches"], bound_ms=b_ms,
                bound_by=b_by, **ppm_shape(B, W))


def ppm_inputs(pd, device):
    """(label, _decode_blocks arguments on `device`) of every shape ppm_decode
    is held and timed at beyond the bench pd: random words at PPM_RANDOM's
    shapes (the bench's prior; at 256 x 512 its W, at 128 x 1024 PPM_W_32K,
    past the shared-memory stream), then every fuzz_ppm(7) pattern, and
    steps2's first block alone (1 x 2, the smallest launch)."""
    import torch

    for (B, steps), W in zip(PPM_RANDOM, (pd[0].shape[1], PPM_W_32K)):
        yield f"random_{B}x{steps}", ppm_random(pd, B, steps, W, B)
    for pat, st in fuzz_ppm(7).items():
        yield pat, tuple(torch.as_tensor(a, device=device) for a in st[:3]) + (st[3],)
        if pat == "steps2":  # the smallest launch: one block, two steps
            yield "steps2_1x2", tuple(torch.as_tensor(a[:1], device=device)
                                      for a in st[:2]) + (torch.as_tensor(st[2], device=device),
                                                          st[3])


def check_research(tally: Tally, data: bytes, hc: bytes, blob: bytes, device):
    """Phase 24: huff_scan on the huff0 container hc (the tally's time),
    on a short one with a truncated payload, and on every huff_inputs
    shape (the NLZC prior of blob, random bytes, 128 KiB blocks, every
    fuzz_huff pattern), each timed (huff_timing); ppm_decode on the NLZC
    container blob (the tally's time), on every ppm_inputs shape (random
    words at 256 x 512 and 128 x 1024, every fuzz_ppm pattern), each timed
    (ppm_timing, the bench too), on its streams cut to 40 words (the
    clamped window reads the last word, which holds data) and on the blob
    cut short; each against its plain version, exact. Returns shape info,
    the timings and ppm_decode's seconds."""
    from nlzm_tpu_torch.research import huff0, ppm_tpu

    st = huff0.stage_blocks(hc, *huff0._parse(hc), device)
    hs = st[:5] + st[6:]
    B, T = st[0].shape[0], st[6]
    tally.hold("huff_scan", lambda: huff0._huff_scan(*hs), lambda: huff0._huff_scan_ref(*hs),
               reps_plain=0, work=huff_work(hs))
    huff = {"huff0_245x32768": huff_timing(hs)}
    small = huff0._truncated(huff0.encode(data[: HUFF0_TRUNC["bytes"]], HUFF0_TRUNC["block_size"]))
    ts = huff0.stage_blocks(small, *huff0._parse(small), device)
    ts = ts[:5] + ts[6:]
    tally.hold("huff_scan", lambda: huff0._huff_scan(*ts), lambda: huff0._huff_scan_ref(*ts),
               timed=False)
    prior = ppm_tpu.parse_container(blob)[2]
    for label, args in huff_inputs(data, prior, device, bench=False):
        tally.hold("huff_scan", lambda: huff0._huff_scan(*args),
                   lambda: huff0._huff_scan_ref(*args), timed=False)
        huff[label] = huff_timing(args)
        del args

    t0 = time.perf_counter()
    pd, _ = ppm_tpu.stage_container(blob, device)
    words, steps, nb = pd[0], pd[3], pd[0].shape[0]
    chunks = len(ppm_tpu.chunk_schedule(steps))
    work = ppm_decode_work(pd, ppm_tpu._decode_blocks(*pd))  # the decoded bytes, for the count
    tally.hold("ppm_decode", lambda: ppm_tpu._decode_blocks(*pd),
               lambda: ppm_tpu._decode_blocks_ref(*pd), reps_plain=0, work=work)
    ppm = {"nlzc_256x512": ppm_timing(pd)}
    for label, args in ppm_inputs(pd, device):
        tally.hold("ppm_decode", lambda: ppm_tpu._decode_blocks(*args),
                   lambda: ppm_tpu._decode_blocks_ref(*args), timed=False)
        ppm[label] = ppm_timing(args)
        del args
    cut = (words[:, :40].contiguous(),) + pd[1:]
    tally.hold("ppm_decode", lambda: ppm_tpu._decode_blocks(*cut),
               lambda: ppm_tpu._decode_blocks_ref(*cut), timed=False)
    tw, _ = ppm_tpu.stage_container(blob[:-3001], device)
    tally.hold("ppm_decode", lambda: ppm_tpu._decode_blocks(*tw),
               lambda: ppm_tpu._decode_blocks_ref(*tw), timed=False)
    return {"huff0": {"blocks": B, "steps": T}, "huff0_truncated": {"blocks": ts[0].shape[0]},
            "nlzc": {"blocks": nb, "steps": steps, "chunks": chunks, "words": words.shape[1]},
            "huff_scan_timing": huff, "ppm_decode_timing": ppm,
            "ppm_decode_seconds": time.perf_counter() - t0}


def run_research(tally: Tally, data: bytes, device, card: str):
    """Phases 24-26; returns ({path: main-path launches}, the NLZC container)."""
    from nlzm_tpu_torch.research import huff0, ppm_tpu

    ndata, hdata = data[: NLZC["bytes"]], data[: HUFF0["bytes"]]
    t0 = time.perf_counter()
    blob = ppm_tpu.compress(ndata, NLZC["block_size"])
    nlzc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hc = huff0.encode(hdata, HUFF0["block_size"])
    huff0_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shape = check_research(tally, data, hc, blob, device)
    emit({"phase": "kernels_research", "ok": True, **shape,
          "kernels": tally.summary(RESEARCH_KERNELS), "seconds": time.perf_counter() - t0,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; plain: 1 call "
                    f"(its comparison call past 1 s); huff_scan_timing, ppm_decode_timing: device "
                    f"ms from torch.profiler, ns a symbol of the [B, T] output (huff_scan) or "
                    f"a read of a block's chain (ppm_decode), rows and groups built from the "
                    f"kernel's counters beside the bound's (ppm_rows), registers, CTAs an SM "
                    f"and waves from the CUDA runtime", "card": card})

    by_path = {}
    out, by_path["e2e_nlzc"] = launched(
        "e2e_nlzc", RESEARCH_KERNELS, lambda: ppm_tpu.decompress(blob, device=device))
    exact_launches("e2e_nlzc", by_path["e2e_nlzc"], NLZC_LAUNCHES)
    if out != ndata:
        raise AssertionError("e2e_nlzc: decoded bytes differ from the input")
    e2e = best_ms(lambda: ppm_tpu.decompress(blob, device=device), REPS)
    pd, _ = ppm_tpu.stage_container(blob, device)
    staged = best_ms(lambda: ppm_tpu._decode_blocks(*pd), REPS)
    emit({"phase": "e2e_nlzc", "ok": True, "bytes": len(ndata), "container_bytes": len(blob),
          "ratio": len(blob) / len(ndata), "block_size": NLZC["block_size"],
          "blocks": pd[0].shape[0], "steps": pd[3], "encode_host_s": nlzc_s,
          "launches": by_path["e2e_nlzc"], "e2e_ms": e2e, "e2e_MBps": len(ndata) / e2e / 1e3,
          "staged_ms": staged, "staged_MBps": len(ndata) / staged / 1e3,
          "timing": f"CUDA events around decompress and around _decode_blocks on the staged "
                    f"container, best of {REPS}", "card": card})

    out, by_path["e2e_huff0"] = launched(
        "e2e_huff0", ("huff_scan",), lambda: huff0.decode(hc, device=device))
    exact_launches("e2e_huff0", by_path["e2e_huff0"], {"huff_scan": 1})
    if out != hdata:
        raise AssertionError("e2e_huff0: decoded bytes differ from the input")
    e2e = best_ms(lambda: huff0.decode(hc, device=device), REPS)
    emit({"phase": "e2e_huff0", "ok": True, "bytes": len(hdata), "container_bytes": len(hc),
          "ratio": len(hc) / len(hdata), "block_size": HUFF0["block_size"],
          "encode_host_s": huff0_s, "launches": by_path["e2e_huff0"], "e2e_ms": e2e,
          "e2e_MBps": len(hdata) / e2e / 1e3,
          "timing": f"CUDA events around decode, best of {REPS}", "card": card})
    return by_path, blob


def host_best(fn, reps: int) -> float:
    """Best of `reps` host-clock seconds of fn() (which synchronises)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_stream(files, device, card: str) -> dict:
    """Phase 12: each (label, data, container, kernels it must launch)
    through the file decoder, to a file and in test mode, each call
    through launched(). Returns {label: the to-file call's counts}."""
    from nlzm_tpu_torch import decode_container_stream

    build = Path(__file__).resolve().parent / ".build"
    build.mkdir(exist_ok=True)
    res, by_file = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for label, data, container, need in files:
            src, dst = Path(tmp) / f"{label}.nlzp", Path(tmp) / f"{label}.out"
            src.write_bytes(container)
            t0 = time.perf_counter()
            r, by_file[label] = launched(
                f"stream {label}", need, lambda: decode_container_stream(
                    str(src), str(dst), device=device, bucket_bytes=STREAM_BUCKET))
            secs = time.perf_counter() - t0
            want_crc = zlib.crc32(data)
            if dst.read_bytes() != data or r["crc32"] != want_crc or r["out"] != len(data):
                raise AssertionError(f"stream {label}: output or CRC differs from the input")
            t, test_counts = launched(
                f"stream {label} test mode", need, lambda: decode_container_stream(
                    str(src), None, device=device, bucket_bytes=STREAM_BUCKET))
            if t["crc32"] != want_crc or t["out"] != len(data):
                raise AssertionError(f"stream {label}: test mode CRC differs")
            res[label] = {"seconds": secs, "MBps": len(data) / secs / 1e6,
                          "buckets": -(-len(data) // STREAM_BUCKET),
                          "launches": by_file[label], "launches_test_mode": test_counts}
    emit({"phase": "stream", "ok": True, "bucket_bytes": STREAM_BUCKET, "files": res,
          "timing": "host clock, one call to file", "card": card})
    return by_file


CLI_NATIVE_BYTES = 1 << 20  # the native engine's wide decode: a Python plane decoder


def run_cli(data: bytes, device: str, card: str) -> dict:
    """Phase 27: the command line in this process, each call through
    launched() with the kernels it must launch (None: it must launch
    none); every output file against the input, every printed CRC against
    zlib.crc32. Returns {cli_<call>: its counts}."""
    import contextlib
    import io

    from nlzm_tpu_torch.cli import main as cli

    build = Path(__file__).resolve().parent / ".build"
    build.mkdir(exist_ok=True)
    paths, calls = {}, {}
    dev = f"-device:{device}"

    def run(name, args, need, out=None, want=data):
        """cli(args) must exit 0, print want's CRC, launch every kernel of
        `need` (None: none at all) and write `want` to `out`."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, launches = launched(f"cli {name}", need or (), lambda: cli(args))
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {name}: exit {rc}: {text[-400:]}")
        if need is None and any(launches.values()):
            raise AssertionError(f"cli {name}: a host-engine call launched kernels: {launches}")
        crc = f"{zlib.crc32(want):X}"
        if not re.search(rf"(?<![0-9A-F]){crc}(?![0-9A-F])", text):
            raise AssertionError(f"cli {name}: no {crc} in its output: {text[-400:]}")
        if out is not None and Path(out).read_bytes() != want:
            raise AssertionError(f"cli {name}: the output differs from the input")
        paths[f"cli_{name}"] = launches
        calls[name] = {"seconds": secs, "launched": {k: v for k, v in launches.items() if v}}
        peak = re.search(r"device peak: +(\d+) KB", text)
        if peak:
            calls[name]["device_peak_kb"] = int(peak.group(1))
        return text

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t = Path(tmp)
        src = t / "in.bin"
        src.write_bytes(data)
        run("h", ["h", str(src)], None)
        ship = t / "ship.nlzp"
        run("ship_c", ["-profile:wide", "-blocks:32768", "-dict:32768", "c", str(src),
                       str(ship)], None)
        run("ship_d", [dev, "d", str(ship), str(t / "ship.out")], WIDE_KERNELS,
            t / "ship.out")
        run("ship_t", [dev, "t", str(ship)], WIDE_KERNELS)
        for parser, need in (("optimal", V1OPT_KERNELS), ("greedy", V1ENC_KERNELS)):
            z = t / f"v1_{parser}.nlzp"
            run(f"v1_{parser}_c", [dev, "-blocks:8192", "-engine:device", f"-parser:{parser}",
                                   "c", str(src), str(z)], need)
            run(f"v1_{parser}_d", [dev, "d", str(z), str(t / f"v1_{parser}.out")], V1_KERNELS,
                t / f"v1_{parser}.out")
        for name, extra in (("wide_greedy", []), ("wide_greedy_dev", ["-engine:device", "-v"])):
            z = t / f"{name}.nlzp"
            text = run(f"{name}_c", [dev, "-profile:wide", "-blocks", "-parser:greedy", *extra,
                                     "c", str(src), str(z)], ENC_KERNELS)
            one_plane_launch(f"cli {name}_c", paths[f"cli_{name}_c"])
            if extra and device.startswith("cuda") and "device peak" not in text:
                raise AssertionError("cli wide_greedy_dev_c: -v printed no measured device peak")
            run(f"{name}_d", [dev, "d", str(z), str(t / f"{name}.out")], WIDE_KERNELS,
                t / f"{name}.out")
        single = t / "single.nlzm"
        run("single_c", ["c", str(src), str(single)], None)
        run("single_d", ["d", str(single), str(t / "single.out")], None, t / "single.out")

        small = data[:CLI_NATIVE_BYTES]
        (t / "small.bin").write_bytes(small)
        small_c = t / "small.nlzp"
        run("small_c", ["-profile:wide", "-blocks:32768", "-dict:32768", "c",
                        str(t / "small.bin"), str(small_c)], None, want=small)
        run("native_d", ["-engine:native", "d", str(small_c), str(t / "small.out")], None,
            t / "small.out", small)

        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "nlzm_tpu_torch.cli", dev, "t", str(ship)],
                           cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0 or f"{zlib.crc32(data):X}" not in r.stdout:
            raise AssertionError(f"cli subprocess t: exit {r.returncode}: {r.stdout[-400:]} "
                                 f"{r.stderr[-400:]}")
        calls["subprocess_t"] = {"seconds": time.perf_counter() - t0}
    emit({"phase": "cli", "ok": True, "bytes": len(data), "native_bytes": len(small),
          "calls": calls, "timing": "host clock, one call each", "card": card})
    return paths


def wide_buckets(rows: int) -> int:
    """Buckets of a wide decode of `rows` blocks (ops/wide_decode.py
    prepare_wide_bucketed): one up to 8 a bucket, else N_BUCKETS."""
    from nlzm_tpu_torch.ops import wide_decode as wd

    return 1 if rows <= 8 * wd.N_BUCKETS else wd.N_BUCKETS


def run_mesh(corpus: bytes, wide_c: bytes, v1_c: bytes, nlzc_blob: bytes, device: str,
             card: str) -> dict:
    """Phase 28: block sharding (parallel/mesh.py, parallel/mp_dryrun.py),
    every shard on `device` ("cuda": cuda:0; one card, so the k shards of
    a call run one after another and its time is no scaling). Every
    output is checked, every call's launches are exact; the multi-process
    runs: JAX's corpus as two ranks on gloo sharing the device and, on a
    card, one on nccl; the 8 MB at the shipping config as two ranks on
    gloo. Returns {mesh_*: launches}."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from nlzm_tpu_torch.ops.encode_ops import encode_blocks_device
    from nlzm_tpu_torch.parallel import mesh, mp_dryrun
    from nlzm_tpu_torch.parallel.blocks import IntegrityError, encode_container, parse_container
    from nlzm_tpu_torch.research import ppm_tpu

    cuda = device.startswith("cuda")
    before = torch.cuda.current_device() if cuda else None
    paths, equal = {}, {}

    def on_card(k):
        return mesh.make_mesh([device] * k)

    def run(label, fn, want, per_run, runs=1):
        """fn() through launched(): its output must equal want and its
        launches be per_run's, runs times."""
        out, paths[label] = launched(label, tuple(per_run), fn)
        exact_launches(label, paths[label], per_run, runs)
        if out != want:
            raise AssertionError(f"{label}: the output differs")
        equal[label] = True
        return out

    data = corpus[:SHIP_BYTES]
    n_wide = len(parse_container(wide_c).comp_sizes)
    wide, v1 = {}, {}
    for k in MESH_WIDE_KS:
        m = on_card(k)
        run(f"mesh_wide_k{k}", lambda: mesh.decode_wide_sharded(wide_c, m), data,
            dict.fromkeys(WIDE_KERNELS, wide_buckets(-(-n_wide // k))), k)
        ms = host_best(lambda: mesh.decode_wide_sharded(wide_c, m), MESH_REPS) * 1e3
        wide[f"k{k}"] = {"rows": -(-n_wide // k) * k, "ms": ms, "MBps": len(data) / ms / 1e3}
    for k in MESH_V1_KS:
        m = on_card(k)
        run(f"mesh_v1_k{k}", lambda: mesh.decode_container_sharded(v1_c, m), data,
            dict.fromkeys(V1_KERNELS, 1), k)
        ms = host_best(lambda: mesh.decode_container_sharded(v1_c, m), MESH_REPS) * 1e3
        v1[f"k{k}"] = {"ms": ms, "MBps": len(data) / ms / 1e3}

    k = MESH_ENC_K
    m = on_card(k)
    enc_data, bs, hb = corpus[:V1_ENC_BYTES], V1_ENC["block_size"], V1_ENC_HIST_BITS
    single = encode_blocks_device(enc_data, bs, hb, "greedy", device=device)
    t0 = time.perf_counter()
    sharded = run(f"mesh_enc_k{k}", lambda: encode_blocks_device(enc_data, bs, hb, "greedy",
                                                                 mesh=m),
                  single, dict.fromkeys(V1ENC_KERNELS, 1), k)
    enc = {"blocks": len(single[0]), "rows": -(-len(single[0]) // k) * k,
           "seconds": time.perf_counter() - t0}
    container = encode_container(enc_data, engine="device", device=device, **V1_ENC)
    if not container.endswith(b"".join(sharded[0])):
        raise AssertionError("mesh: the device encode's container does not hold the payloads")
    run(f"mesh_enc_decode_k{k}", lambda: mesh.decode_container_sharded(container, m), enc_data,
        dict.fromkeys(V1_KERNELS, 1), k)
    opt_data = corpus[:MESH_OPT_BYTES]
    t0 = time.perf_counter()
    run(f"mesh_enc_opt_k{k}", lambda: encode_blocks_device(opt_data, bs, hb, "optimal", mesh=m),
        encode_blocks_device(opt_data, bs, hb, "optimal", device=device), V1_OPT_LAUNCHES, k)
    enc["optimal_seconds"] = time.perf_counter() - t0

    k = MESH_NLZC_K
    ndata = corpus[: NLZC["bytes"]]
    m = on_card(k)
    run(f"mesh_nlzc_k{k}", lambda: ppm_tpu.decompress(nlzc_blob, mesh=m), ndata,
        {"huff_scan": 1, "ppm_decode": k})
    nlzc_ms = host_best(lambda: ppm_tpu.decompress(nlzc_blob, mesh=m), MESH_REPS) * 1e3

    k = MESH_RAGGED_K
    rdata = data[: 2 * k * SHIP["block_size"] + 17]
    rc = encode_container(rdata, parser="optimal", profile="wide", **SHIP)
    if len(parse_container(rc).comp_sizes) != 2 * k + 1:
        raise AssertionError("mesh: the ragged container is not 2k + 1 blocks")
    run(f"mesh_ragged_k{k}", lambda: mesh.decode_wide_sharded(rc, on_card(k)), rdata,
        dict.fromkeys(WIDE_KERNELS, wide_buckets(3)), k)

    try:
        mesh.decode_wide_sharded(corrupt_copy(wide_c), on_card(2))
    except IntegrityError as e:
        raised = str(e)
    else:
        raise AssertionError("mesh: a corrupt container decoded without IntegrityError")
    after = torch.cuda.current_device() if cuda else None
    if after != before:
        raise AssertionError(f"mesh: the current device moved from {before} to {after}")

    # the multi-process mode, every run at once: JAX's corpus as two ranks
    # sharing the device on gloo and, on a card, one rank on nccl; the
    # 8 MB at the shipping config (its dictionary) as two ranks on gloo
    build = Path(__file__).resolve().parent / ".build"
    build.mkdir(exist_ok=True)
    kind = "cuda" if cuda else "cpu"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ship_in = Path(tmp, "ship.bin")
        ship_in.write_bytes(data)
        ship = dict(input_path=ship_in, block_size=SHIP["block_size"],
                    dict_size=SHIP["dict_size"])
        mp_runs = {"gloo_2proc": (2, "gloo", {}), "gloo_2proc_ship": (2, "gloo", ship)}
        if cuda:
            mp_runs["nccl_1proc"] = (1, "nccl", {})
        with ThreadPoolExecutor(len(mp_runs)) as pool:
            runs = {name: pool.submit(mp_dryrun.spawn, procs, backend, kind, Path(tmp, name),
                                      MP_TIMEOUT, **kw)
                    for name, (procs, backend, kw) in mp_runs.items()}
            mp = {name: f.result() for name, f in runs.items()}
    if not mp["gloo_2proc_ship"].startswith(
            f"{mp_dryrun.OK}: 2 processes x 1 device ({kind}, gloo), {len(data)} bytes in "
            f"{n_wide} blocks of {SHIP['block_size']} ({n_wide + n_wide % 2} rows), dictionary "
            f"{SHIP['dict_size']} bytes"):
        raise AssertionError(f"mesh: the shipping mp_dryrun run: {mp['gloo_2proc_ship']}")
    emit({"phase": "mesh", "ok": True, "shards_on": str(on_card(1)[0]), "blocks": n_wide,
          "wide_ship": wide, "v1_bench": v1, "enc_v1": enc, "nlzc_k3_ms": nlzc_ms,
          "equal": equal, "corrupt_raised": raised,
          "current_device": {"before": before, "after": after},
          "mp_dryrun": mp, "mp_seconds": time.perf_counter() - t0,
          "launches": {p: {n: c for n, c in v.items() if c} for p, v in paths.items()},
          "timing": f"host clock: decodes best of {MESH_REPS}, encodes one call; one card, and "
                    f"one process stages its k shards in turn (no scaling)",
          "card": card})
    return paths


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2

    # the whole program must be here before anything is reported
    from nlzm_tpu_torch import _build
    from nlzm_tpu_torch.native import available, load

    if not available():
        load()  # raises with the build error of the host encoder

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "ok": True, "seconds": secs, "built": sorted(reports),
          "ptxas": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
                    for n, log in reports.items()}})

    tally = Tally()
    corpus = build_corpus(max(SHIP_BYTES, V1_ENC_BYTES))
    data = corpus[:SHIP_BYTES]
    wide_c, wide_launches, frontier_ps, front_c = run_wide(tally, data, "cuda", card)
    v1_c, v1_launches, big_c = run_v1(tally, data, "cuda", card)
    stream_launches = run_stream([("wide_ship", data, wide_c, WIDE_KERNELS),
                                  ("v1_bench", data, v1_c, V1_KERNELS)], "cuda", card)
    greedy = {}
    enc_launches = run_encode(tally, data, "cuda", card, greedy)
    v1enc_launches = run_v1_encode(tally, corpus[:V1_ENC_BYTES], "cuda", card, greedy)
    opt_launches = run_opt_encode(tally, corpus[:V1_ENC_BYTES], "cuda", card, greedy)
    t0 = time.perf_counter()
    cover = check_cover(tally, corpus, "cuda")
    emit({"phase": "kernels_cover", "ok": True, **cover, "seconds": time.perf_counter() - t0,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; ns a command of "
                    f"the longest block's chain; CTAs an SM from the occupancy calculator",
          "card": card})
    t0 = time.perf_counter()
    rep = check_rep(tally, "cuda")
    emit({"phase": "kernels_rep", "ok": True, **rep, "seconds": time.perf_counter() - t0,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; ns a match of the "
                    f"block with the most matches; runs from rep_model on the host",
          "card": card})
    t0 = time.perf_counter()
    rans = check_rans(tally, "cuda")
    emit({"phase": "kernels_rans", "ok": True, **rans, "seconds": time.perf_counter() - t0,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; ns a step of the "
                    f"longest chain (the most spans a block / 4); registers, CTAs an SM and "
                    f"waves from the CUDA runtime", "card": card})
    t0 = time.perf_counter()
    fm = check_fm(tally, corpus, "cuda")
    emit({"phase": "kernels_fm", "ok": True, **fm, "seconds": time.perf_counter() - t0,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; device_ms from "
                    f"torch.profiler; registers, CTAs an SM and waves from the CUDA runtime",
          "card": card})
    scan = check_scan(tally, wide_c, "cuda", frontier_ps)
    emit({"phase": "kernels_scan", "ok": True, **scan,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls of the main path's "
                    f"entry (no prior check); device_ms from torch.profiler; ns a step of the "
                    f"bucket's steps; registers, CTAs an SM and waves from the CUDA runtime",
          "card": card})
    expand = check_expand(tally, wide_c, v1_c, big_c, front_c, "cuda")
    emit({"phase": "kernels_expand", "ok": True, **expand,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; device_ms from "
                    f"torch.profiler (both kernels of a call); host_us the host's time to issue "
                    f"a call; registers, CTAs an SM and waves from the CUDA runtime",
          "card": card})
    asm = check_assemble(tally, wide_c, front_c, "cuda")
    emit({"phase": "kernels_assemble", "ok": True, **asm,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls of the main path's "
                    f"entry (_assemble_rows); device_ms from torch.profiler; registers, CTAs an "
                    f"SM and waves from the CUDA runtime", "card": card})
    pack = check_pack(tally, wide_c, front_c, corpus[:V1_ENC_BYTES], "cuda")
    emit({"phase": "kernels_pack", "ok": True, **pack,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls; device_ms from "
                    f"torch.profiler; registers, CTAs an SM and waves from the CUDA runtime",
          "card": card})
    plane_launches, plane_shape = check_plane_decode(tally, wide_c, "cuda")
    emit({"phase": "kernels_plane_decode", "ok": True, **plane_shape,
          "kernels": tally.summary(("plane_decode",)), "launches": plane_launches,
          "timing": f"CUDA events, mean of {KERNEL_REPS} back-to-back calls, summed over the "
                    f"ten wire planes (two buckets); ship_device_ms: torch.profiler, every "
                    f"plane_decode launch of {KERNEL_REPS} calls of the ten planes summed, a call; "
                    f"plain: 1 call (its comparison call past 1 s)",
          "card": card})
    research_launches, nlzc_blob = run_research(tally, corpus, "cuda", card)
    cli_launches = run_cli(data, "cuda", card)
    mesh_launches = run_mesh(corpus, wide_c, v1_c, nlzc_blob, "cuda", card)

    src = "nlzm_tpu_torch/csrc/"
    replaces = {
        "stage_windows": "nlzm_tpu/ops/wide_decode.py:726",
        "plane_scan": "nlzm_tpu/ops/wide_decode.py:318",
        "assemble": "nlzm_tpu/ops/wide_decode.py:597",
        "lz_expand": "nlzm_tpu/ops/expand_ops.py:227",
        "fsm_decode": "nlzm_tpu/ops/decode_v2.py:435",
        "find_matches": "nlzm_tpu/ops/encode_ops.py:87",
        "greedy_cover": "nlzm_tpu/ops/encode_ops.py:149",
        "repify": "nlzm_tpu/ops/encode_ops.py:367",
        "plane_encode": "nlzm_tpu/ops/wide_encode_dev.py:33",
        "emit_model": "nlzm_tpu/ops/encode_ops.py:438",
        "rans_backward": "nlzm_tpu/ops/encode_ops.py:586",
        "bits_forward": "nlzm_tpu/ops/encode_ops.py:658",
        "dp_parse": "nlzm_tpu/ops/encode_ops.py:203",
        "dp_cover": "nlzm_tpu/ops/encode_ops.py:288",
        "measure_costs": "nlzm_tpu/ops/encode_ops.py:321",
        "plane_decode": "nlzm_tpu/ops/wide_decode.py:73",
        "huff_scan": "nlzm_tpu/research/huff0.py:297",
        "ppm_decode": "nlzm_tpu/research/ppm_tpu.py:340",
    }
    sources = dict.fromkeys(replaces)
    sources["dp_cover"] = "greedy_cover"  # the greedy walk's template, its own entry
    shapes = dict.fromkeys(replaces, "e2e_ship buckets")
    shapes["fsm_decode"] = "e2e_v1_bench buckets"
    shapes.update(dict.fromkeys(ENC_KERNELS[:3], "8 MB at 32 KiB blocks, 245 blocks"))
    shapes["plane_encode"] = "the bench's 8 MB commands, five planes with priors, one launch"
    shapes.update(dict.fromkeys(V1ENC_KERNELS[3:], "8 MiB at 8 KiB blocks, 1024 blocks"))
    shapes.update(dict.fromkeys(OPT_KERNELS, "8 MiB at 8 KiB blocks, 1024 blocks, 3 candidates"))
    shapes["plane_decode"] = "the e2e_ship buckets' ten wire planes, each at its own steps"
    shapes["huff_scan"] = "huff0, 8 MB at 32 KiB blocks, 245 blocks"
    shapes["ppm_decode"] = "NLZC, 4 MiB at 16 KiB blocks, 256 blocks"
    paths = {"e2e_ship": wide_launches, "e2e_v1_bench": v1_launches,
             **{f"stream_{f}": c for f, c in stream_launches.items()}, **enc_launches,
             **v1enc_launches, **opt_launches, **plane_launches, **research_launches,
             **cli_launches, **mesh_launches}
    rows = []
    for n in replaces:
        r = tally.k[n]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        by_path = {p: c[n] for p, c in paths.items()}
        rows.append({
            "name": n, "route": "cuda", "source": f"{src}{sources[n] or n}.cu",
            "replaces": replaces[n],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "timed_at": shapes[n],
        })
    emit({"phase": "done", "ok": True, "seconds": time.perf_counter() - start,
          "timing": "host clock, the whole run, the kernels' build included"})
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
