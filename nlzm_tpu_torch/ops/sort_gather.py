"""Row gather and rank compaction, the two primitives of the wide decoder.

Counterpart of nlzm_tpu/ops/sort_gather.py. The JAX module restructures
gathers and compactions as packed sorts (the TPU has no per-lane gather)
and carries six variants for its packing budgets; on a GPU both are
plain indexed loads and stores, one i32 function each. The CUDA kernels
do the same work inline; these are the plain versions they are held to.
"""

import torch


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, k] = src[b, clamp(idx[b, k], 0, N - 1)], int32.

    The clamp mirrors XLA's gather (out-of-range reads clamp), so a
    corrupt stream degrades to wrong bytes and a CRC failure, never an
    indexing error.
    """
    N = src.shape[1]
    return torch.gather(src, 1, idx.long().clamp(0, max(N - 1, 0))).to(torch.int32)


def compact_by_rank(vals: torch.Tensor, rank: torch.Tensor, pred: torch.Tensor,
                    out_width: int) -> torch.Tensor:
    """out[b, rank[b, k]] = vals[b, k] where pred; 0 past each row's count.

    rank must be a bijection onto 0..count-1 over the pred positions (an
    exclusive cumsum of pred); ranks at or past out_width are dropped.
    """
    B, K = vals.shape
    keep = pred & (rank >= 0) & (rank < out_width)
    out = torch.zeros(B, out_width + 1, dtype=torch.int32, device=vals.device)
    # dropped records land in the spare last column, cut below
    dest = torch.where(keep, rank.long(), torch.full_like(rank.long(), out_width))
    out.scatter_(1, dest, torch.where(keep, vals, 0).to(torch.int32))
    return out[:, :out_width]
