// Per-block realized DP costs of an emitted command stream.
//
// Replaces nlzm_tpu/ops/encode_ops.py::measure_costs. A nonzero span costs
// bits16(f) = (14 - log2(max(f, 1))) * 16 bits for f = its top 16 bits;
// per block, five families of commands average their spans' costs:
// literals (op_len == 0: spans 0-2), matches (op_len > 0: span 0), matches
// without a length escape (span 1), escapes (op_len - mmin(max(op_val, 1))
// >= 7: spans 1-3) and dictionary matches (op_rep < 0: spans 4-5). A family
// of 4 or fewer commands takes its default cost; the slope (column 3) is
// the default's. The JAX function averages float32 sums in XLA's order;
// this one is exact by definition, as ops/encode_ops.py's plain version:
// bits16 from a table of int64 fixed-point values (2^-32 bit units), int64
// sums, each average rounded half to even in integers. Sums cannot
// overflow: 2^17 steps x 3 spans x 224 bits x 2^32 < 2^63.
//
// Bound: bytes, the [T, B] command arrays and [T, B, 6] spans read once.
// Design: a CTA takes 8 consecutive blocks (a 32-byte sector of each [T, B]
// row) and 64 step groups; thread (g, k) sums block k's steps g, g + 64,
// ...; lanes of a warp with the same block combine by shuffle, the warps
// through shared memory, and 8 threads round and store.
#include "common.cuh"

namespace {

constexpr int BPC = 8;      // blocks per CTA
constexpr int GROUPS = 64;  // step groups per block
constexpr int NTHREADS = BPC * GROUPS;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NFAM = 5;
constexpr int FIX_BITS = 32;

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

// round(s / (cnt << FIX_BITS)), ties to even; cnt > 0
__device__ __forceinline__ long long round_half_even(long long s, int cnt) {
  const long long d = (long long)cnt << FIX_BITS;
  long long q = s / d, r = s % d;
  if (r < 0) {  // floor division
    q -= 1;
    r += d;
  }
  return q + ((2 * r > d || (2 * r == d && (q & 1))) ? 1 : 0);
}

__global__ void __launch_bounds__(NTHREADS)
    measure_costs_kernel(const int* __restrict__ spans, const int* __restrict__ op_len,
                         const int* __restrict__ op_val, const int* __restrict__ op_rep,
                         const long long* __restrict__ table, const int* __restrict__ defaults,
                         int* __restrict__ costs, int T, int B) {
  __shared__ long long s_sum[NWARPS][BPC][NFAM];
  __shared__ int s_cnt[NWARPS][BPC][NFAM];
  const int k = threadIdx.x & (BPC - 1), g = threadIdx.x / BPC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * BPC + k;
  long long sum[NFAM] = {0, 0, 0, 0, 0};
  int cnt[NFAM] = {0, 0, 0, 0, 0};
  if (b < B) {
    for (int t = g; t < T; t += GROUPS) {
      const long long e = (long long)t * B + b;
      const int L = op_len[e];
      if (L < 0) continue;  // no family
      long long bits[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const unsigned sp = (unsigned)spans[e * 6 + j];
        bits[j] = sp ? table[sp >> 16] : 0;
      }
      if (L == 0) {
        sum[0] += bits[0] + bits[1] + bits[2];
        ++cnt[0];
        continue;
      }
      sum[1] += bits[0];
      ++cnt[1];
      if (L - mmin_of(max(op_val[e], 1)) >= 7) {
        sum[3] += bits[1] + bits[2] + bits[3];
        ++cnt[3];
      } else {
        sum[2] += bits[1];
        ++cnt[2];
      }
      if (op_rep[e] < 0) {
        sum[4] += bits[4] + bits[5];
        ++cnt[4];
      }
    }
  }
  // lanes k, k + 8, k + 16, k + 24 of a warp hold the same block
#pragma unroll
  for (int f = 0; f < NFAM; ++f) {
    for (int o = 8; o < 32; o <<= 1) {
      sum[f] += __shfl_xor_sync(0xffffffffu, sum[f], o);
      cnt[f] += __shfl_xor_sync(0xffffffffu, cnt[f], o);
    }
  }
  if (lane < BPC) {
#pragma unroll
    for (int f = 0; f < NFAM; ++f) {
      s_sum[warp][lane][f] = sum[f];
      s_cnt[warp][lane][f] = cnt[f];
    }
  }
  __syncthreads();
  if (threadIdx.x < BPC && b < B) {
    int* out = costs + (long long)b * 6;
    for (int f = 0; f < NFAM; ++f) {
      const int col = f < 3 ? f : f + 1;  // the slope sits between
      long long s = 0;
      int n = 0;
      for (int w = 0; w < NWARPS; ++w) {
        s += s_sum[w][k][f];
        n += s_cnt[w][k][f];
      }
      out[col] = n > 4 ? (int)round_half_even(s, n) : defaults[col];
    }
    out[3] = defaults[3];
  }
}

}  // namespace

// spans [T, B, 6] i32; op_len, op_val, op_rep [T, B] i32; table [65536] i64
// (bits16 in 2^-32 units, ops/encode_ops.py::bits16_table); defaults [6]
// i32 (default_dp_costs); costs [B, 6] i32 out.
NLZM_API int nlzm_measure_costs(const void* spans, const void* op_len, const void* op_val,
                                const void* op_rep, const void* table, const void* defaults,
                                void* costs, int T, int B, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  measure_costs_kernel<<<(B + BPC - 1) / BPC, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)spans, (const int*)op_len, (const int*)op_val, (const int*)op_rep,
      (const long long*)table, (const int*)defaults, (int*)costs, T, B);
  return launch_status();
}
