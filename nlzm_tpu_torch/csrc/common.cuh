// Shared helpers of the port's kernels: clamped indexing, warp and block
// scans, and the wide profile's fence rebuild.
//
// Every index a kernel derives from stream data is clamped before it is
// used: the JAX decoder's gathers clamp silently (XLA semantics), and a
// corrupt container must end in a CRC failure, never in a device fault.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NLZM_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_inclusive_sum(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Block-wide exclusive prefix sums of NV values per thread, in thread
// order. v[j] becomes the sum of v[j] over lower threads; total[j] the
// sum over the block. blockDim.x must be a multiple of 32. scratch holds
// 32 x NV ints of shared memory; every thread of the block must call.
template <int NV>
__device__ __forceinline__ void block_exclusive_scan(int (&v)[NV], int (&total)[NV],
                                                     int (*scratch)[NV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) incl[j] = warp_inclusive_sum(v[j]);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < NV; ++j) scratch[warp][j] = incl[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      int s = lane < nwarps ? scratch[lane][j] : 0;
      s = warp_inclusive_sum(s);
      if (lane < nwarps) scratch[lane][j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int base = warp > 0 ? scratch[warp - 1][j] : 0;
    total[j] = scratch[nwarps - 1][j];
    v[j] = base + incl[j] - v[j];
  }
  __syncthreads();  // scratch is free for the next call
}

constexpr int CDF_TOTAL = 1 << 14;  // the wide profile's 14-bit CDF scale

// A symbol's wide-profile frequency from its count, as format/wide.py
// build_cdf: 1 + carry * (2^14 - alph) / (total + 1), truncated. rt is
// 1 / (total + 1) within 2 ulp (rcp.approx). Where 0 <= carry <= total the
// quotient is below 2^14, so the float estimate is within 1 of it and one
// correction each way makes it exact; else (negative or huge priors) an
// i64 division.
__device__ __forceinline__ int cdf_freq(int carry, int alph, int tot, float rt) {
  const long long num = (long long)carry * (CDF_TOTAL - alph);
  if (carry >= 0 && carry <= tot && num <= 0xFFFFFFFFLL) {
    const long long den = (long long)tot + 1;
    long long q = __float2uint_rz(__uint2float_rn((unsigned)num) * rt);
    const long long rem = num - q * den;
    q += (rem >= den) - (rem < 0);
    return 1 + (int)q;
  }
  return 1 + (int)(num / (tot + 1));
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Wide-profile fences [alph + 1] from counts [alph] (cdf_freq), the
// exclusive prefix sums with the last pinned at 2^14. Called by one whole
// warp; F is the fences' type (int, or uint16_t where they are stored as
// u16: every fence is in 0..2^14 for counts in 0..2^31). From 33 to 256
// symbols a lane takes a run of ceil(alph / 32) and the warp scans the
// runs once; else 32 symbols a round.
template <typename F>
__device__ __forceinline__ void build_fences(const int* carry, F* fen, int alph) {
  const int lane = threadIdx.x & 31;
  if (alph > 32 && alph <= 256) {
    const int m = (alph + 31) >> 5, k0 = lane * m;
    int fr[8], run = 0, tot = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fr[i] = i < m && k0 + i < alph ? carry[k0 + i] : 0;
      tot += fr[i];
    }
    tot = warp_sum(tot);
    const float rt = rcp_approx((float)tot + 1.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fr[i] = i < m && k0 + i < alph ? cdf_freq(fr[i], alph, tot, rt) : 0;
      run += fr[i];
    }
    int f = warp_inclusive_sum(run) - run;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < m && k0 + i < alph) fen[k0 + i] = (F)f;
      f += fr[i];
    }
  } else {
    int tot = 0;
    for (int k = lane; k < alph; k += 32) tot += carry[k];
    tot = warp_sum(tot);
    const float rt = rcp_approx((float)tot + 1.0f);
    int run = 0;
    for (int k0 = 0; k0 < alph; k0 += 32) {
      const int k = k0 + lane;
      const int fr = k < alph ? cdf_freq(carry[k], alph, tot, rt) : 0;
      const int inc = warp_inclusive_sum(fr);
      if (k < alph) fen[k] = (F)(run + inc - fr);
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  if (lane == 0) fen[alph] = (F)CDF_TOTAL;
  __syncwarp();
}

// Per-read chunk-adaptive tables of a wide-profile plane in dynamic
// shared memory sm, as plane_encode.cu and plane_decode.cu keep them: read
// r's fences [rows[r], alph[r] + 1] at sm + fen[r], carries and chunk
// counts [rows[r], alph[r]] at sm + car[r] and sm + cnt[r]. The whole
// block calls; (read, row) pairs are dealt to warps round robin.
//
// plane_tables_init: carries from the read's prior ([rows, alph] counts)
// or 0, counts 0, initial fences built from the prior or uniform.
__device__ __forceinline__ void plane_tables_init(int* sm, const int* fen, const int* car,
                                                  const int* cnt, const int* alph,
                                                  const int* rows, const long long* prior_ptr,
                                                  int R) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  for (int r = 0; r < R; ++r) {
    const int* prior = reinterpret_cast<const int*>(prior_ptr[r]);
    const int n = rows[r] * alph[r];
    for (int i = t; i < n; i += blockDim.x) {
      sm[car[r] + i] = prior ? prior[i] : 0;
      sm[cnt[r] + i] = 0;
    }
  }
  __syncthreads();
  for (int r = 0, k = 0; r < R; ++r) {
    const int a = alph[r];
    for (int row = 0; row < rows[r]; ++row, ++k) {
      if (k % nwarps != warp) continue;
      int* f = sm + fen[r] + row * (a + 1);
      if (prior_ptr[r]) {
        build_fences(sm + car[r] + row * a, f, a);
      } else {
        for (int i = lane; i <= a; i += 32) f[i] = i < a ? i * (CDF_TOTAL / a) : CDF_TOTAL;
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// plane_tables_rebuild, at a chunk boundary: carry = (carry >> 1) +
// counts, counts = 0, fences rebuilt from the carries.
__device__ __forceinline__ void plane_tables_rebuild(int* sm, const int* fen, const int* car,
                                                     const int* cnt, const int* alph,
                                                     const int* rows, int R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  __syncthreads();  // every count of the chunk is in
  for (int r = 0, k = 0; r < R; ++r) {
    const int a = alph[r];
    for (int row = 0; row < rows[r]; ++row, ++k) {
      if (k % nwarps != warp) continue;
      int* c = sm + car[r] + row * a;
      int* n = sm + cnt[r] + row * a;
      for (int j = lane; j < a; j += 32) {
        c[j] = (c[j] >> 1) + n[j];
        n[j] = 0;
      }
      __syncwarp();
      build_fences(c, sm + fen[r] + row * (a + 1), a);
    }
  }
  __syncthreads();
}

// Launch epilogue shared by the C entry points: the launch's own error
// (bad configuration, too many resources) as an int, 0 when it launched.
static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
