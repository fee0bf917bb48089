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
// Design: the grid fills the card whatever B is.
// - A CTA takes G = 8 adjacent blocks (a 32-byte sector of each [T, B]
//   row) and one of `splits` ranges of `rows` steps
//   (ops/encode_ops.py::cost_split: one wave of MC_CTAS_PER_SM CTAs an
//   SM); thread (r, k) sums block k's steps r, r + 32, ... of the range.
// - Loads: each thread keeps U = 4 steps in flight; a step's spans come as
//   8-byte pairs (a row of 8 blocks' spans, 192 bytes, starts 8-byte
//   aligned at any B), only where op_len >= 0, spans 4-5 only for a
//   dictionary match, op_val and op_rep only for a match; a span's table
//   entry only where the span is nonzero and its family uses it.
// - Partial sums and counts meet in a [B, 5] scratch through 64-bit
//   atomics (integer adds: exact in any order; negative table entries, f >
//   2^14, wrap in two's complement), and the last CTA of a block group
//   (a counter a group) rounds and stores its blocks' costs.
#include "common.cuh"

namespace {

constexpr int G = 8;         // blocks a CTA
constexpr int NTHREADS = 256;
constexpr int ROWS = NTHREADS / G;  // steps a pass (encode_ops.MC_ROWS)
constexpr int U = 4;         // steps a thread in flight
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

__device__ __forceinline__ unsigned long long bits_of(const long long* __restrict__ table,
                                                      int sp) {
  return sp ? (unsigned long long)__ldg(table + ((unsigned)sp >> 16)) : 0ull;
}

__global__ void __launch_bounds__(NTHREADS, 4)
    measure_costs_kernel(const int* __restrict__ spans, const int* __restrict__ op_len,
                         const int* __restrict__ op_val, const int* __restrict__ op_rep,
                         const long long* __restrict__ table, const int* __restrict__ defaults,
                         int* __restrict__ costs, unsigned long long* __restrict__ sums,
                         unsigned* __restrict__ cnts, unsigned* __restrict__ done, int T, int B,
                         int rows) {
  __shared__ unsigned long long s_sum[NWARPS][G][NFAM];
  __shared__ unsigned s_cnt[NWARPS][G][NFAM];
  __shared__ bool s_last;
  const int k = threadIdx.x & (G - 1), rr = threadIdx.x / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * G + k;
  const int t0 = blockIdx.y * rows, t1 = (int)min((long long)t0 + rows, (long long)T);
  unsigned long long sum[NFAM] = {0, 0, 0, 0, 0};
  unsigned cnt[NFAM] = {0, 0, 0, 0, 0};
  if (b < B) {
    for (int t = t0 + rr; t < t1; t += ROWS * U) {
      int len[U], val[U], rep[U];
      int2 s01[U], s23[U], s45[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tu = t + u * ROWS;
        len[u] = tu < t1 ? __ldg(op_len + (long long)tu * B + b) : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (long long)(t + u * ROWS) * B + b;
        const int2* sp = reinterpret_cast<const int2*>(spans + e * 6);
        s01[u] = s23[u] = make_int2(0, 0);
        val[u] = rep[u] = 0;
        if (len[u] >= 0) {
          s01[u] = __ldg(sp);
          s23[u] = __ldg(sp + 1);
        }
        if (len[u] > 0) {
          val[u] = __ldg(op_val + e);
          rep[u] = __ldg(op_rep + e);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (long long)(t + u * ROWS) * B + b;
        s45[u] = len[u] > 0 && rep[u] < 0
                     ? __ldg(reinterpret_cast<const int2*>(spans + e * 6) + 2)
                     : make_int2(0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int L = len[u];
        if (L == 0) {
          sum[0] += bits_of(table, s01[u].x) + bits_of(table, s01[u].y) +
                    bits_of(table, s23[u].x);
          ++cnt[0];
        } else if (L > 0) {
          sum[1] += bits_of(table, s01[u].x);
          ++cnt[1];
          if (L - mmin_of(max(val[u], 1)) >= 7) {
            sum[3] += bits_of(table, s01[u].y) + bits_of(table, s23[u].x) +
                      bits_of(table, s23[u].y);
            ++cnt[3];
          } else {
            sum[2] += bits_of(table, s01[u].y);
            ++cnt[2];
          }
          if (rep[u] < 0) {
            sum[4] += bits_of(table, s45[u].x) + bits_of(table, s45[u].y);
            ++cnt[4];
          }
        }
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
  if (lane < G) {
#pragma unroll
    for (int f = 0; f < NFAM; ++f) {
      s_sum[warp][lane][f] = sum[f];
      s_cnt[warp][lane][f] = cnt[f];
    }
  }
  __syncthreads();
  if (threadIdx.x < G * NFAM) {
    const int kk = threadIdx.x / NFAM, f = threadIdx.x - kk * NFAM;
    const int bb = blockIdx.x * G + kk;
    unsigned long long s = 0;
    unsigned n = 0;
    for (int w = 0; w < NWARPS; ++w) {
      s += s_sum[w][kk][f];
      n += s_cnt[w][kk][f];
    }
    if (bb < B && n) {
      atomicAdd(sums + (long long)bb * NFAM + f, s);
      atomicAdd(cnts + (long long)bb * NFAM + f, n);
    }
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (s_last && threadIdx.x < G && b < B) {
    __threadfence();
    int* out = costs + (long long)b * 6;
    for (int f = 0; f < NFAM; ++f) {
      const int col = f < 3 ? f : f + 1;  // the slope sits between
      const long long s = (long long)__ldcg(sums + (long long)b * NFAM + f);
      const int n = (int)__ldcg(cnts + (long long)b * NFAM + f);
      out[col] = n > 4 ? (int)round_half_even(s, n) : defaults[col];
    }
    out[3] = defaults[3];
  }
}

}  // namespace

// spans [T, B, 6] i32 (8-byte aligned); op_len, op_val, op_rep [T, B] i32;
// table [65536] i64 (bits16 in 2^-32 units, ops/encode_ops.py::
// bits16_table); defaults [6] i32 (default_dp_costs); costs [B, 6] i32
// out; scratch zeroed: [B, 5] u64 sums, [B, 5] u32 counts, [ceil(B / 8)]
// u32 counters. The grid: ceil(B / 8) x splits CTAs, each `rows` steps
// (ops/encode_ops.py::cost_split; splits x rows >= T).
NLZM_API int nlzm_measure_costs(const void* spans, const void* op_len, const void* op_val,
                                const void* op_rep, const void* table, const void* defaults,
                                void* costs, void* scratch, int T, int B, int splits, int rows,
                                int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (splits < 1 || splits > 65535 || rows < 1 || (long long)splits * rows < T ||
      ((uintptr_t)spans & 7))
    return (int)cudaErrorInvalidValue;
  unsigned long long* sums = static_cast<unsigned long long*>(scratch);
  unsigned* cnts = reinterpret_cast<unsigned*>(sums + (long long)B * NFAM);
  unsigned* done = cnts + (long long)B * NFAM;
  const dim3 grid((B + G - 1) / G, splits);
  measure_costs_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)spans, (const int*)op_len, (const int*)op_val, (const int*)op_rep,
      (const long long*)table, (const int*)defaults, (int*)costs, sums, cnts, done, T, B, rows);
  return launch_status();
}

// The launch's shape on this card: out [4] i32 = registers a thread,
// resident CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// SMs, threads a CTA.
NLZM_API int nlzm_measure_costs_shape(void* out, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  cudaFuncAttributes attr = {};
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)measure_costs_kernel);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)measure_costs_kernel,
                                                      NTHREADS, 0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = ctas;
  o[2] = sms;
  o[3] = NTHREADS;
  return 0;
}
