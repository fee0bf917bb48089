"""NLZP wide profile, decode side: the format tables and payload parsing.

A copy of the decode-side part of nlzm_tpu/format/wide.py, which defines
the format (the encoders, the host reference decoder and the format
description stay there). tests/test_torch_host.py pins every piece here
to the original: the plane table, the chunk schedule, and the parsed
payloads and priors of real containers.

Block payload layout (big-endian): per plane u32 sym_count, u32
stream_bytes; u32 bits_bytes; per plane u16 x (NC - 1) chunk pair-count
deltas; the five plane streams (L x u32le lane seeds, then renorm pairs in
decode order); the raw-bit plane (MSB-first).
"""

from dataclasses import dataclass

import numpy as np

CHUNK_STEPS = 8  # steady-state table rebuild cadence (in scan steps)
WARMUP_CHUNKS = (2, 2, 4, 8)  # short early chunks: fast model warmup


def chunk_schedule(steps_needed: int) -> tuple:
    """Chunk lengths covering >= steps_needed (warmup then steady)."""
    sched = []
    total = 0
    for w in WARMUP_CHUNKS:
        sched.append(w)
        total += w
        if total >= steps_needed:
            return tuple(sched)
    while total < steps_needed:
        sched.append(CHUNK_STEPS)
        total += CHUNK_STEPS
    return tuple(sched)


def padded_steps(n_sym: int, lanes: int) -> int:
    """Total scan steps (= sum of the chunk schedule) for n_sym symbols."""
    need = max(1, -(-n_sym // lanes))
    return sum(chunk_schedule(need))


@dataclass(frozen=True)
class PlaneSpec:
    name: str
    lanes: int
    reads: int  # CDF reads per symbol
    alphabets: tuple  # per read
    rows: tuple  # context rows per read


# Wire v4: every plane is single-read over a joint alphabet, no context rows.
PLANES = (
    PlaneSpec("tok", 64, 1, (4,), (1,)),
    PlaneSpec("lit", 64, 1, (256,), (1,)),
    PlaneSpec("len", 32, 1, (8,), (1,)),
    PlaneSpec("lex", 16, 1, (256,), (1,)),
    PlaneSpec("dst", 32, 1, (64,), (1,)),
)
N_PLANES = len(PLANES)
HDR_BYTES = 8 * N_PLANES + 4

TOK_LIT, TOK_DICT, TOK_REP = 0, 1, 2


def parse_priors(blob: bytes):
    """Container priors blob -> {plane name: per read [rows, alphabet] int64}."""
    priors = {}
    off = 0
    for spec in PLANES:
        pr = []
        for r in range(spec.reads):
            n = spec.rows[r] * spec.alphabets[r]
            a = np.frombuffer(blob, ">u2", n, off).astype(np.int64)
            pr.append(a.reshape(spec.rows[r], spec.alphabets[r]))
            off += 2 * n
        priors[spec.name] = pr
    return priors


def priors_blob_size() -> int:
    return 2 * sum(
        spec.rows[r] * spec.alphabets[r]
        for spec in PLANES
        for r in range(spec.reads)
    )


def parse_payload(payload: bytes):
    """Split one wide block payload into its sections.

    Returns (counts, streams, offsets, bits): per-plane symbol counts,
    stream bytes (seeds + pairs), chunk-offset arrays, and the raw-bit
    plane bytes.
    """
    counts, sizes = [], []
    off = 0
    for _ in range(N_PLANES):
        counts.append(int.from_bytes(payload[off : off + 4], "big"))
        sizes.append(int.from_bytes(payload[off + 4 : off + 8], "big"))
        off += 8
    bits_len = int.from_bytes(payload[off : off + 4], "big")
    off += 4
    offsets = []
    for i in range(N_PLANES):
        nc = len(chunk_schedule(padded_steps(counts[i], PLANES[i].lanes)))
        deltas = np.frombuffer(payload, ">u2", nc - 1, off).astype(np.int64)
        off += 2 * (nc - 1)
        o = np.zeros(nc, np.int64)
        np.cumsum(2 * deltas, out=o[1:])
        offsets.append(o)
    streams = []
    for s in sizes:
        streams.append(payload[off : off + s])
        off += s
    bits = payload[off : off + bits_len]
    return counts, streams, offsets, bits
