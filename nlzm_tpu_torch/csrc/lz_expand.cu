// LZ expansion of command arrays into bytes by pointer doubling.
//
// Replaces nlzm_tpu/ops/expand_ops.py::lz_expand_parallel (with
// _parent_fill_sorted[_dict], _byte_fill_sorted, _byte_fill_dict,
// _sparse_fill[2]). The TPU version builds every position's parent and
// final byte with merged sorts and cummax fills, in a 15/16-bit packed
// form up to 32 KiB blocks and a 2-operand form above, because it has no
// per-lane gather or scatter. Here both are plain indexed stores and
// loads, with one i32 code path for every block size up to 128 KiB.
//
// Bound: memory latency of the dependent gathers (parent[parent[i]]),
// a few rounds over N i32 words per block; the working set (B x N x 9
// bytes) stays in L2 at the shipping shapes. Design: one CTA of 1024
// threads per block.
// - An exclusive block scan of the command lengths gives each command's
//   start (and the block's produced count); the thread of a command then
//   writes parent[i] = m - d + ((i - m) mod d) over its range, shifted by
//   the dictionary length D and clipped to [0, D + N - 1]; a literal roots
//   at itself and stores its byte at lit_at[start]. Positions past the
//   last command root at themselves; they are zeroed at the end.
// - Pointer doubling, parent <- parent o parent, through parents >= D
//   only (dictionary parents are terminal): min(rounds_hint, log2 N)
//   rounds, or until a round changes nothing when there is no hint
//   (__syncthreads_or). Ping-pong between two global buffers, so every
//   round is the synchronous composition of the JAX decoder and of the
//   plain version, and the kernel agrees with the plain version even for
//   a hint that is too small; an in-place update would jump further and
//   agree only once converged.
// - out[i] = dict[parent] or lit_at[parent - D], zero at i >= produced.
// Parents, lit_at and out are global scratch: a 32 KiB block with a
// 32 KiB dictionary would fit shared memory, the 128 KiB frontier blocks
// would not, and one code path serves both.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 1024;

__global__ void __launch_bounds__(NTHREADS)
    lz_expand_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val, int T,
                     int B, int N, const unsigned char* __restrict__ dict, int D, int rounds,
                     int max_rounds, int* __restrict__ pa, int* __restrict__ pb,
                     unsigned char* __restrict__ lit_at, unsigned char* __restrict__ out,
                     int* __restrict__ produced) {
  __shared__ int scratch[32][1];
  const int b = blockIdx.x;
  int* cur = pa + (long long)b * N;
  int* nxt = pb + (long long)b * N;
  unsigned char* lit = lit_at + (long long)b * N;
  const int top = D + N - 1;

  for (int i = threadIdx.x; i < N; i += NTHREADS) {
    cur[i] = i + D;
    lit[i] = 0;
  }
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
      if (ol == 0 && m >= 0 && m < N) lit[m] = (unsigned char)(ov & 0xFF);
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

  unsigned char* orow = out + (long long)b * N;
  for (int i = threadIdx.x; i < N; i += NTHREADS) {
    const int p = cur[i];
    const unsigned char byte = p < D ? dict[clampi(p, 0, D - 1)] : lit[clampi(p - D, 0, N - 1)];
    orow[i] = i < base ? byte : 0;
  }
}

}  // namespace

// op_len/op_val [T, B] i32; dict [D] u8 (null when D = 0); rounds < 0:
// until no change, else min(rounds, max_rounds); scratch pa/pb [B, N] i32,
// lit_at [B, N] u8; out [B, N] u8; produced [B] i32.
NLZM_API int nlzm_lz_expand(const void* op_len, const void* op_val, const void* dict, void* pa,
                            void* pb, void* lit_at, void* out, void* produced, int T, int B,
                            int N, int D, int rounds, int max_rounds, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  lz_expand_kernel<<<B, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)op_len, (const int*)op_val, T, B, N, (const unsigned char*)dict, D, rounds,
      max_rounds, (int*)pa, (int*)pb, (unsigned char*)lit_at, (unsigned char*)out,
      (int*)produced);
  return launch_status();
}
