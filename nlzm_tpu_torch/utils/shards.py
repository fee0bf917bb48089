"""Block-shard arithmetic shared by the sharded decodes (parallel/), the
sharded v1 encode (ops/encode_ops.py) and NLZC (research/ppm_tpu.py).

The codec's mesh is 1-D over blocks: the B blocks pad to a multiple of
the shard count n, and shard i holds the contiguous rows [i * Bp / n,
(i + 1) * Bp / n) of the Bp padded rows (JAX's P("blocks") layout;
pad_blocks is nlzm_tpu/parallel/mesh.py's _pad_blocks).
"""

import numpy as np


def pad_blocks(arr: np.ndarray, multiple: int):
    """arr padded with zero rows to a multiple of `multiple` rows, and its
    row count before."""
    b = arr.shape[0]
    pad = (-b) % multiple
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
    return arr, b


def shard_rows(n_rows: int, n_shards: int, i: int) -> tuple[int, int]:
    """Rows [lo, hi) of shard i when n_rows (padded) rows split over
    n_shards."""
    return i * n_rows // n_shards, (i + 1) * n_rows // n_shards
