// Greedy parse: one LZ command per step per block, from the match
// candidates of find_matches.
//
// Replaces nlzm_tpu/ops/encode_ops.py::greedy_cover. At the write head the
// JAX scan takes the match (delta d, length l) if d > 0 and l >= mmin(d),
// else a literal, and advances by max(length, 1); steps past n_valid emit
// (-1, the byte at the clamped head). op_len / op_val are [T, B].
//
// Bound: the serial chain of command starts (each start depends on the
// last), a few thousand dependent steps per block. Design, one CTA per
// block:
// 1. every thread computes, for its positions, the step the parse would
//    take there (the match length, or 1), into shared memory (N <= 32768:
//    128 KiB) or a global scratch row;
// 2. thread 0 walks the chain through that array - one shared-memory load
//    and an add per command - setting a bit per command start;
// 3. a block scan of the bit counts gives each start its step index, and
//    the commands and the dead rows are written by all threads at once.
// n_valid is clamped to [0, N], so the walk stays inside the block.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 512;

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

template <bool SMEM>
__global__ void __launch_bounds__(NTHREADS)
    greedy_cover_kernel(const uint8_t* __restrict__ data, const int* __restrict__ delta,
                        const int* __restrict__ mlen, const int* __restrict__ n_valid,
                        int* __restrict__ op_len, int* __restrict__ op_val, int* gstep,
                        unsigned* gmask, int B, int N, int num_steps) {
  extern __shared__ __align__(16) int sdyn[];
  __shared__ int scan_scratch[32][1];
  __shared__ int s_ncmd;
  __shared__ long long s_end;
  const int b = blockIdx.x, t = threadIdx.x;
  const int nwords = (N + 31) >> 5;
  int* step;
  unsigned* mask;
  if (SMEM) {
    step = sdyn;
    mask = reinterpret_cast<unsigned*>(sdyn + N);
  } else {
    step = gstep + (long long)b * N;
    mask = gmask + (long long)b * nwords;
  }
  const long long rowoff = (long long)b * N;
  for (int p = t; p < N; p += NTHREADS) {
    const int d = delta[rowoff + p], l = mlen[rowoff + p];
    step[p] = (d > 0 && l >= mmin_of(d)) ? l : 1;  // a match has l >= 2
  }
  for (int w = t; w < nwords; w += NTHREADS) mask[w] = 0u;
  __syncthreads();

  if (t == 0) {
    const int nv = clampi(n_valid[b], 0, N);
    long long pos = 0;
    int cnt = 0;
    while (pos < nv && cnt < num_steps) {
      const int p = (int)pos;
      mask[p >> 5] |= 1u << (p & 31);
      pos += step[p];
      ++cnt;
    }
    s_ncmd = cnt;
    s_end = pos;
  }
  __syncthreads();

  // step index of every start: exclusive prefix count of the mask bits,
  // each thread over a contiguous run of words
  const int per = (nwords + NTHREADS - 1) / NTHREADS;
  const int w0 = min(t * per, nwords), w1 = min(w0 + per, nwords);
  int mine[1] = {0}, total[1];
  for (int w = w0; w < w1; ++w) mine[0] += __popc(mask[w]);
  block_exclusive_scan<1>(mine, total, scan_scratch);
  int s = mine[0];
  for (int w = w0; w < w1; ++w) {
    unsigned m = mask[w];
    while (m) {
      const int p = (w << 5) + __ffs(m) - 1;
      m &= m - 1;
      const bool use = step[p] >= 2;
      op_len[(long long)s * B + b] = use ? step[p] : 0;
      op_val[(long long)s * B + b] = use ? delta[rowoff + p] : (int)data[rowoff + p];
      ++s;
    }
  }
  const int ncmd = s_ncmd;
  const long long end = s_end;  // the head of a finished block: n_valid
  const int tail = (int)data[rowoff + (end < N ? (int)end : N - 1)];
  for (int r = ncmd + t; r < num_steps; r += NTHREADS) {
    op_len[(long long)r * B + b] = -1;
    op_val[(long long)r * B + b] = tail;
  }
}

}  // namespace

// data [B, N] u8; delta, mlen [B, N] i32; n_valid [B] i32; op_len, op_val
// [num_steps, B] i32 out; gstep [B, N] i32 and gmask [B, ceil(N / 32)] u32
// scratch when N > 32768, else unused (may be null).
NLZM_API int nlzm_greedy_cover(const void* data, const void* delta, const void* mlen,
                               const void* n_valid, void* op_len, void* op_val, void* gstep,
                               void* gmask, int B, int N, int num_steps, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0 || N == 0 || num_steps == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 32768) {
    const size_t bytes = (size_t)N * sizeof(int) + (size_t)((N + 31) >> 5) * sizeof(unsigned);
    auto kern = greedy_cover_kernel<true>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, NTHREADS, bytes, s>>>((const uint8_t*)data, (const int*)delta, (const int*)mlen,
                                    (const int*)n_valid, (int*)op_len, (int*)op_val, nullptr,
                                    nullptr, B, N, num_steps);
  } else {
    greedy_cover_kernel<false><<<B, NTHREADS, 0, s>>>(
        (const uint8_t*)data, (const int*)delta, (const int*)mlen, (const int*)n_valid,
        (int*)op_len, (int*)op_val, (int*)gstep, (unsigned*)gmask, B, N, num_steps);
  }
  return launch_status();
}
