// LZ expansion of command arrays into bytes by pointer doubling.
//
// Replaces nlzm_tpu/ops/expand_ops.py::lz_expand_parallel (with
// _parent_fill_sorted[_dict], _byte_fill_sorted, _byte_fill_dict,
// _sparse_fill[2]). The TPU version builds every position's parent and
// final byte with merged sorts and cummax fills, in a 15/16-bit packed
// form up to 32 KiB blocks and a 2-operand form above, because it has no
// per-lane gather or scatter. Here both are plain indexed stores and
// loads, with one i32 code path for every block size.
//
// Bound: memory latency of the dependent gathers (parent[parent[i]]),
// a few rounds over N i32 words per block; the working set (B x N x 9
// bytes) stays in L2 at the shipping shapes. Design: one CTA of 1024
// threads per block.
// - An exclusive block scan of the command lengths gives each command's
//   start (and the block's produced count); the thread of a command then
//   writes parent[i] = m - d + ((i - m) mod d) over its range, shifted by
//   the dictionary length D and clipped to [0, D + N - 1]; a literal roots
//   at itself, stores its byte at lit_at[start] and sets bit `start` of
//   the block's literal mask. Positions past the last command root at
//   themselves; they are zeroed at the end.
// - Pointer doubling, parent <- parent o parent, through parents >= D
//   only (dictionary parents are terminal): min(rounds_hint, log2 N)
//   rounds, or until a round changes nothing when there is no hint
//   (__syncthreads_or). Ping-pong between two global buffers, so every
//   round is the synchronous composition of the JAX decoder and of the
//   plain version, and the kernel agrees with the plain version even for
//   a hint that is too small; an in-place update would jump further and
//   agree only once converged.
// - out[i] = dict[parent] or lit_at[parent - D], zero at i >= produced.
//   On the JAX sort path with a dictionary the parent is capped at
//   D + N - 2, and position N - 1 rooted at itself takes the literal at
//   N - 1 or 0 (that path's pad-key corner patch).
// - A parent that is neither in the dictionary nor a literal (a round
//   hint below the chain depth; never with the container's own hint or
//   none) takes what the JAX fills give it: the byte of the latest literal
//   at or before it, or, with none, 0 (the last dictionary byte on the
//   JAX sort path with a dictionary). Only a block that has such a parent
//   (__syncthreads_or) runs the fill: a ballot scan of the literal mask
//   for each position's latest literal, then the byte pass again.
// Parents, lit_at and out are global scratch: a 32 KiB block with a
// 32 KiB dictionary would fit shared memory, the 128 KiB frontier blocks
// would not, and one code path serves both. The literal mask (N / 8
// bytes) lives in shared memory up to N = 256 Ki, in global beyond.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 1024;

__device__ __forceinline__ bool is_lit(const unsigned* mask, int j) {
  return (mask[j >> 5] >> (j & 31)) & 1u;
}

__global__ void __launch_bounds__(NTHREADS)
    lz_expand_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val, int T,
                     int B, int N, const unsigned char* __restrict__ dict, int D, int rounds,
                     int max_rounds, int use_sort, int* __restrict__ pa, int* __restrict__ pb,
                     unsigned char* __restrict__ lit_at, unsigned* __restrict__ lit_mask,
                     int mask_in_smem, unsigned char* __restrict__ out,
                     int* __restrict__ produced) {
  extern __shared__ unsigned smem_mask[];
  __shared__ int scratch[32][1];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cur = pa + (long long)b * N;
  int* nxt = pb + (long long)b * N;
  unsigned char* lit = lit_at + (long long)b * N;
  const int words = (N + 31) >> 5;
  unsigned* mask = mask_in_smem ? smem_mask : lit_mask + (long long)b * words;
  const int top = D + N - 1;

  for (int i = threadIdx.x; i < N; i += NTHREADS) cur[i] = i + D;
  for (int w = threadIdx.x; w < words; w += NTHREADS) mask[w] = 0;
  __syncthreads();

  int base = 0;
  for (int k0 = 0; k0 < T; k0 += NTHREADS) {
    const int k = k0 + threadIdx.x;
    const int ol = k < T ? op_len[(long long)k * B + b] : -1;
    const int ov = k < T ? op_val[(long long)k * B + b] : 0;
    const int len = ol < 0 ? 0 : (ol == 0 ? 1 : ol);
    int v[1] = {len}, tot[1];
    block_exclusive_scan<1>(v, tot, scratch);
    const int m = base + v[0];
    base += tot[0];
    if (len > 0) {
      const int d = ol == 0 ? 0 : ov;
      const int ds = max(d, 1);
      const int end = min(m + len, N);
      for (int i = max(m, 0); i < end; ++i) {
        const int par = d == 0 ? i : m - d + (i - m) % ds;
        cur[i] = clampi(par + D, 0, top);
      }
      if (ol == 0 && m >= 0 && m < N) {
        lit[m] = (unsigned char)(ov & 0xFF);
        atomicOr(&mask[m >> 5], 1u << (m & 31));
      }
    }
  }
  if (threadIdx.x == 0) produced[b] = base;
  __syncthreads();

  const int bound = rounds < 0 ? max_rounds : min(rounds, max_rounds);
  for (int r = 0; r < bound; ++r) {
    int changed = 0;
    for (int i = threadIdx.x; i < N; i += NTHREADS) {
      const int p = cur[i];
      const int q = p >= D ? cur[clampi(p - D, 0, N - 1)] : p;
      nxt[i] = q;
      changed |= q != p;
    }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    const int any = __syncthreads_or(changed);
    if (rounds < 0 && !any) break;
  }

  // Parents lie in [0, top] throughout. last: null on the first pass,
  // which leaves an unresolved parent's byte to the fill; afterwards the
  // latest literal at or before each position, or -1.
  const bool sort_dict = use_sort && D > 0;
  unsigned char* orow = out + (long long)b * N;
  auto bytes = [&](const int* last) {
    int unresolved = 0;
    for (int i = threadIdx.x; i < N; i += NTHREADS) {
      int byte = 0;
      if (i < base) {
        const int p = cur[i];
        const int q = sort_dict ? min(p, top - 1) : p;
        const int j = clampi(q - D, 0, N - 1);
        const bool lit_j = is_lit(mask, j);  // both loads issue at once
        const int lit_b = lit[j];
        if (sort_dict && i == N - 1 && p == top) {
          byte = is_lit(mask, N - 1) ? lit[N - 1] : 0;
        } else if (q < D) {
          byte = dict[clampi(q, 0, D - 1)];
        } else if (lit_j) {
          byte = lit_b;
        } else if (last == nullptr) {
          unresolved = 1;
        } else {
          const int l = last[j];
          byte = l >= 0 ? lit[l] : (sort_dict ? dict[D - 1] : 0);
        }
      }
      orow[i] = (unsigned char)byte;
    }
    return unresolved;
  };
  if (!__syncthreads_or(bytes(nullptr))) return;

  // nxt[j] <- the latest literal position at or before j, or -1: a ballot
  // of the mask per warp, the warps' latest in shared memory, a carry
  // across tiles of NTHREADS positions.
  __shared__ int warp_last[NTHREADS / 32];
  int carry = -1;
  for (int j0 = 0; j0 < N; j0 += NTHREADS) {
    const int j = j0 + threadIdx.x;
    const int w0 = j0 + warp * 32;
    const unsigned bal = __ballot_sync(0xffffffffu, j < N && is_lit(mask, j));
    const unsigned upto = bal & (0xffffffffu >> (31 - lane));
    if (lane == 0) warp_last[warp] = bal ? w0 + 31 - __clz(bal) : -1;
    __syncthreads();
    int l = upto ? w0 + 31 - __clz(upto) : -1;
    for (int w = warp - 1; l < 0 && w >= 0; --w) l = warp_last[w];
    if (j < N) nxt[j] = l < 0 ? carry : l;
    for (int w = NTHREADS / 32 - 1; w >= 0; --w) {
      if (warp_last[w] >= 0) {
        carry = warp_last[w];
        break;
      }
    }
    __syncthreads();
  }
  bytes(nxt);
}

}  // namespace

// op_len/op_val [T, B] i32; dict [D] u8 (null when D = 0); rounds < 0:
// until no change, else min(rounds, max_rounds); scratch pa/pb [B, N] i32,
// lit_at [B, N] u8, lit_mask [B, ceil(N / 32)] u32 (used when the mask
// takes more than 32 KiB of shared memory); out [B, N] u8; produced [B] i32.
NLZM_API int nlzm_lz_expand(const void* op_len, const void* op_val, const void* dict, void* pa,
                            void* pb, void* lit_at, void* lit_mask, void* out, void* produced,
                            int T, int B, int N, int D, int rounds, int max_rounds, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  // nlzm_tpu's packed-sort path (ops/expand_ops.py:255), whose fills differ
  const int use_sort = N <= 32768 && D + N <= 65536;
  const size_t mask_bytes = 4 * (size_t)((N + 31) / 32);
  const int in_smem = mask_bytes <= 32 * 1024;
  lz_expand_kernel<<<B, NTHREADS, in_smem ? mask_bytes : 0, (cudaStream_t)stream>>>(
      (const int*)op_len, (const int*)op_val, T, B, N, (const unsigned char*)dict, D, rounds,
      max_rounds, use_sort, (int*)pa, (int*)pb, (unsigned char*)lit_at, (unsigned*)lit_mask,
      in_smem, (unsigned char*)out, (int*)produced);
  return launch_status();
}
