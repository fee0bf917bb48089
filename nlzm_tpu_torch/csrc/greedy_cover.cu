// Command covers: one LZ command per step per block, walking a per-position
// step from the start of the block. Two entries share the walk:
//
// - nlzm_greedy_cover replaces nlzm_tpu/ops/encode_ops.py::greedy_cover:
//   at the write head the JAX scan takes the match (delta d, length l) of
//   find_matches' one candidate if d > 0 and l >= mmin(d), else a literal,
//   and advances by max(length, 1);
// - nlzm_dp_cover replaces nlzm_tpu/ops/encode_ops.py::dp_cover: it follows
//   dp_parse's choices, advancing by max(choice_len, 1); a position with
//   choice_len > 0 is a match of that length at delta[choice_cand], 0 when
//   choice_cand is outside [0, C) (the JAX one-hot select), else a literal.
//
// Steps past n_valid emit (-1, the byte at the head clamped to N - 1).
// op_len / op_val are [T, B].
//
// Bound: the serial chain of command starts (each start depends on the
// last), a few thousand dependent steps per block. Design, one CTA per
// block:
// 1. every thread computes, for its positions, the step the parse would
//    take there, into shared memory (N <= 32768: 128 KiB) or a global
//    scratch row;
// 2. thread 0 walks the chain through that array - one shared-memory load
//    and an add per command - setting a bit per command start;
// 3. a block scan of the bit counts gives each start its step index, and
//    the commands and the dead rows are written by all threads at once.
// n_valid is clamped to [0, N], so the walk stays inside the block, however
// far a step jumps.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 512;

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

// The parse's inputs: greedy (DP false) reads delta [B, N] and mlen as
// `len`; dp (DP true) reads delta [B, N, C], choice_len as `len` and
// choice_cand as `cand`.
template <bool DP>
struct Choices {
  const int* __restrict__ delta;
  const int* __restrict__ len;
  const int* __restrict__ cand;
  int C;

  __device__ __forceinline__ int step(long long at) const {  // at = b * N + p
    const int l = len[at];
    if constexpr (DP) return max(l, 1);
    const int d = delta[at];
    return (d > 0 && l >= mmin_of(d)) ? l : 1;  // a match has l >= 2
  }
  // the command at a start p with step st: (length, distance), length 0
  // for a literal
  __device__ __forceinline__ int2 command(long long at, int st) const {
    if constexpr (!DP) return st >= 2 ? make_int2(st, delta[at]) : make_int2(0, 0);
    const int l = len[at];
    if (l <= 0) return make_int2(0, 0);
    const int c = cand[at];
    return make_int2(l, (c >= 0 && c < C) ? delta[at * C + c] : 0);
  }
};

template <bool SMEM, bool DP>
__global__ void __launch_bounds__(NTHREADS)
    cover_kernel(const uint8_t* __restrict__ data, Choices<DP> ch,
                 const int* __restrict__ n_valid, int* __restrict__ op_len,
                 int* __restrict__ op_val, int* gstep, unsigned* gmask, int B, int N,
                 int num_steps) {
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
  for (int p = t; p < N; p += NTHREADS) step[p] = ch.step(rowoff + p);
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
      const int2 cmd = ch.command(rowoff + p, step[p]);
      op_len[(long long)s * B + b] = cmd.x;
      op_val[(long long)s * B + b] = cmd.x > 0 ? cmd.y : (int)data[rowoff + p];
      ++s;
    }
  }
  const int ncmd = s_ncmd;
  const long long end = s_end;  // the head of a finished block
  const int tail = (int)data[rowoff + (end < N ? (int)end : N - 1)];
  for (int r = ncmd + t; r < num_steps; r += NTHREADS) {
    op_len[(long long)r * B + b] = -1;
    op_val[(long long)r * B + b] = tail;
  }
}

template <bool DP>
int launch_cover(const void* data, Choices<DP> ch, const void* n_valid, void* op_len,
                 void* op_val, void* gstep, void* gmask, int B, int N, int num_steps,
                 cudaStream_t s) {
  if (N <= 32768) {
    const size_t bytes = (size_t)N * sizeof(int) + (size_t)((N + 31) >> 5) * sizeof(unsigned);
    auto kern = cover_kernel<true, DP>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, NTHREADS, bytes, s>>>((const uint8_t*)data, ch, (const int*)n_valid,
                                    (int*)op_len, (int*)op_val, nullptr, nullptr, B, N,
                                    num_steps);
  } else {
    cover_kernel<false, DP><<<B, NTHREADS, 0, s>>>(
        (const uint8_t*)data, ch, (const int*)n_valid, (int*)op_len, (int*)op_val,
        (int*)gstep, (unsigned*)gmask, B, N, num_steps);
  }
  return launch_status();
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
  const Choices<false> ch{(const int*)delta, (const int*)mlen, nullptr, 1};
  return launch_cover(data, ch, n_valid, op_len, op_val, gstep, gmask, B, N, num_steps,
                      (cudaStream_t)stream);
}

// data [B, N] u8; delta [B, N, C] i32; choice_len, choice_cand [B, N] i32;
// n_valid [B] i32; op_len, op_val [num_steps, B] i32 out; gstep, gmask as
// for nlzm_greedy_cover.
NLZM_API int nlzm_dp_cover(const void* data, const void* delta, const void* choice_len,
                           const void* choice_cand, const void* n_valid, void* op_len,
                           void* op_val, void* gstep, void* gmask, int B, int N, int C,
                           int num_steps, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || N == 0 || num_steps == 0) return 0;
  const Choices<true> ch{(const int*)delta, (const int*)choice_len, (const int*)choice_cand, C};
  return launch_cover(data, ch, n_valid, op_len, op_val, gstep, gmask, B, N, num_steps,
                      (cudaStream_t)stream);
}
