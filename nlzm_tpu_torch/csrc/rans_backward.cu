// 4-lane interleaved rANS encode of a span stream, backward.
//
// Replaces nlzm_tpu/ops/encode_ops.py::rans_backward. The TPU version scans
// the [T, B, 6] spans backward with every block's four lane states in
// registers (one-hot lane selects), then compacts the renorm pairs into
// place with a cumulative sum and a dropping scatter.
//
// The JAX lane of a span is k & 3, with k the number of nonzero spans
// before it in forward order (t, then slot), so the four lanes are four
// independent chains; from the last span back, in u32: over = x >= (f <<
// 18) (which wraps: to 0 at f = 2^14, always a renorm there), x1 = over ?
// x >> 16 : x, x = ((x1 / f) << 14) + x1 % f + start, f = max(freq, 1).
//
// Bound: the longest chain, about a quarter of a block's spans, each step a
// few dependent integer instructions; the spans are read once (bytes), the
// stream written once. Design: the chain never waits on device memory or
// runs a division.
// - The step is x = q * c + x1 * a + start with c = 2^14 - f, q = floor(x1 /
//   f) (x1 % f = x1 - q * f): q is the high word of x1 * (ceil(2^48 / f) <<
//   16), two multiplies from the span's magic, exact for every u32 x1 and f
//   < 2^16. At f = 1 the magic is 0 and a = 2^14 (else 1). Everything but
//   x1 comes from the span alone and is worked out ahead: a 16-byte record
//   a span, one shared load a step, two steps ahead of its use.
// - The chain can start before a block's span count K is known: it labels
//   a span by its backward index r = K - 1 - k, so label r & 3 is forward
//   lane (K - 1 - r) & 3, and the four final states are put in forward
//   order once K is known.
// - A CTA takes G adjacent blocks (1, 2, 4 or 8: the most that leaves at
//   most 1/16 of the SMs without a CTA), in tiles of R rows from the last
//   back. Warp 0 runs the chains, lanes 4g + label, G blocks at once. R
//   staging threads a block, a row each: the CTA copies tiles of rows in
//   ahead (cp.async; one row of the G blocks is G x 24 adjacent bytes), and
//   a tile's nonzero spans are compacted in backward order (a scan over its
//   rows) into records in one of two buffers while the chain consumes the
//   other; one barrier a round. A tile with no span in any of the G blocks
//   takes no round (a barrier reduction).
// - The chain writes each span's pair (or NO_PAIR) over the span's record.
//   Two rounds later the staging warps, a third of the tile each, ballot
//   them into the block's scratch row from its end back, so the pairs stand
//   in forward order at the end of the row. At the end the CTA writes each
//   stream row: the four seeds, the pairs (high byte first), zeros up to
//   cap, 16 bytes a store where cap allows it. Bytes at or past cap are
//   dropped (the JAX scatter's mode="drop").
// Nothing is indexed by data: a span's value is computed with, never used
// as an address, and the pair offsets come from the kernel's own counts.
#include "common.cuh"

// Build option, for comparisons (rans_compare.py): NLZM_RANS_BLOCKS = 1, 2,
// 4 or 8 fixes G.
#ifndef NLZM_RANS_BLOCKS
#define NLZM_RANS_BLOCKS 0  // 0: chosen from B and the SM count
#endif

namespace {

constexpr int R = 96;              // rows a tile (chip_smoke.RANS_R)
constexpr int TILE = 6 * R;        // a block's spans in a tile, at most
constexpr int STRIDE = TILE + 20;  // a block's records, padded: lookahead, banks
constexpr int NSG = R;             // staging threads a block: a row each
constexpr int SW = R / 32;         // staging warps a block
constexpr unsigned NO_PAIR = 0x10000u;

template <int G>
struct Shape {
  static constexpr int RS = 6 * G + (G > 1 ? 2 : 0);  // a raw row's words (8-byte units odd)
  static constexpr int NTHREADS = 32 + NSG * G;
  static constexpr int RAW = R * RS;                   // words of a raw tile
  static constexpr int NRAW = G == 1 ? 8 : G == 2 ? 4 : 3;  // raw tiles, NRAW - 1 in flight
  static constexpr int SMEM = 2 * G * STRIDE * 16 + NRAW * RAW * 4;
};

// A span's record: w = (f << 16) | start, a = 2^14 at f = 1 (else 1), and
// the magic's words, (ceil(2^48 / f) << 16) mod 2^64 (0 at f = 1). m is
// exact: the double 2^48 / f (correctly rounded reciprocal) truncates to
// within 2 below ceil(2^48 / f), and e = m * f - 2^48 says how far.
__device__ __forceinline__ uint4 record(unsigned w) {
  const unsigned f = w >> 16;
  unsigned long long m = __double2ull_rz(__drcp_rn((double)f) * 281474976710656.0);
  const long long e = (long long)(m * f) - (1LL << 48);
  m += (e < 0) + (e < -(long long)f);
  if (f == 1) m = 0;
  return make_uint4(w, f == 1 ? 0x4000u : 1u, (unsigned)(m >> 16), (unsigned)m << 16);
}

// One span (record r) on state x; returns its pair, NO_PAIR when it has
// none. The chain is x -> over -> x1 -> q -> x: a compare, a select, two
// multiplies for q and one multiply-add.
__device__ __forceinline__ unsigned step(unsigned& x, const uint4& r) {
  const unsigned f = r.x >> 16;
  const unsigned thr = f << 18, c = 0x4000u - f;
  const bool over = x >= thr;
  const unsigned code = over ? (x & 0xFFFFu) : NO_PAIR;
  const unsigned x1 = over ? x >> 16 : x;
  const unsigned q = (unsigned)(((unsigned long long)x1 * r.z + __umulhi(x1, r.w)) >> 32);
  x = q * c + x1 * r.y + (r.x & 0xFFFFu);
  return code;
}

// every staging thread of the CTA (N of them)
template <int N>
__device__ __forceinline__ void staging_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// every staging thread of the CTA (N of them): whether c holds for any
template <int N>
__device__ __forceinline__ bool staging_any(bool c) {
  unsigned r;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 p, %1, 0;\n bar.red.or.pred q, 1, %2, p;\n"
      " selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((unsigned)c), "n"(N)
      : "memory");
  return r != 0;
}

// the staging warps of block g (immediate barrier ids 2 .. G + 1)
template <int G, int I = 0>
__device__ __forceinline__ void group_bar(int g) {
  if constexpr (I < G) {
    if (g == I) {
      asm volatile("bar.sync %0, %1;\n" ::"n"(2 + I), "n"(NSG) : "memory");
      return;
    }
    group_bar<G, I + 1>(g);
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy but the latest N groups has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int G>
__global__ void __launch_bounds__(Shape<G>::NTHREADS)
    rans_kernel(const unsigned* __restrict__ spans, int T, int B, int cap,
                unsigned* __restrict__ scratch, unsigned char* __restrict__ stream,
                int* __restrict__ rans_bytes) {
  using S = Shape<G>;
  extern __shared__ __align__(16) uint4 rec[];  // [2][G][STRIDE]: by buffer and block
  unsigned* const raw = reinterpret_cast<unsigned*>(rec + 2 * G * STRIDE);  // [NRAW][R][RS]
  __shared__ int tile_n[2][G], tile_r0[2][G];  // a buffer's spans, spans staged before it
  __shared__ int part[G][SW], pairs[G][SW];    // the staging warps' row and pair counts
  __shared__ unsigned seeds[G][4];             // final states by backward label
  __shared__ int fin_k[G], fin_p[G];
  __shared__ int filled;  // rounds staged so far

  const int tid = threadIdx.x, b0 = blockIdx.x * G;
  const int ntiles = (T + R - 1) / R;

  if (tid < 32) {
    // the chains: lane 4g + l runs label l of block g
    const int g = tid >> 2, l = tid & 3;
    const bool mine = g < G && b0 + g < B;
    unsigned x = 1u << 16;
    for (int i = 0;; ++i) {
      __syncthreads();  // round i is staged, or the staging is done
      // filled only grows: a read racing the next round's write still exceeds i
      if (i >= filled) break;
      const int p = i & 1;
      const int n = mine ? tile_n[p][g] : 0;
      const int j0 = (l - (mine ? tile_r0[p][g] : 0)) & 3;  // the label's first span
      const int steps = n > j0 ? (n - j0 + 3) >> 2 : 0;
      const int nsteps = __reduce_max_sync(0xffffffffu, steps);
      uint4* const rb = rec + (p * G + (mine ? g : 0)) * STRIDE;
      auto load = [&](int s) { return rb[min(j0 + 4 * s, STRIDE - 1)]; };
      unsigned keep = x;
      // past its own steps a lane runs on stale records; keep holds its
      // state. Four steps a round, each record loaded two steps ahead.
      auto run = [&](int s, const uint4& r) {
        const unsigned code = step(x, r);
        if (s < steps) {
          rb[j0 + 4 * s].x = code;
          keep = x;
        }
      };
      uint4 a0 = load(0), a1 = load(1);
      for (int s = 0; s < nsteps; s += 4) {
        const uint4 c0 = load(s + 2), c1 = load(s + 3);
        run(s, a0);
        run(s + 1, a1);
        a0 = load(s + 4);
        a1 = load(s + 5);
        run(s + 2, c0);
        run(s + 3, c1);
      }
      x = keep;
    }
    if (mine) seeds[g][l] = x;
  } else {
    // staging: thread R * g + sg of block g stages each tile's row of
    // backward index sg (row R - 1 - sg of the tile); warp wg of the block
    // harvests spans [HW * wg, HW * (wg + 1)) of a consumed tile
    constexpr int NS = NSG * G, HW = TILE / SW, HK = HW / 32;
    const int st = tid - 32, g = st / NSG, sg = st - g * NSG, wg = sg >> 5, lane = st & 31;
    const long long row6 = 6LL * T;  // a block's scratch words
    unsigned short* const pb =
        reinterpret_cast<unsigned short*>(scratch + (long long)min(b0 + g, B - 1) * row6);
    const unsigned below = (1u << lane) - 1u;
    int K = 0, P = 0;  // spans staged, pairs harvested
    unsigned code[HK], fl[HK];

    // thread st copies 8-byte units st, st + NS and st + 2 NS of a tile
    // (R rows of G x 24 bytes): their rows, raw offsets and source offsets
    int rho[3], dst[3];
    long long src[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = st + k * NS, v = e % (3 * G);
      rho[k] = e / (3 * G);
      dst[k] = rho[k] * S::RS + 2 * v;
      src[k] = b0 + v / 3 < B ? ((long long)rho[k] * B + b0) * 6 + 2 * v : -1;
    }
    auto fetch = [&](int u) {  // tile u's rows into raw[u % NRAW], zeros off the array
      if (u < ntiles) {
        const int t0 = T - (u + 1) * R;
        unsigned* const rw = raw + (u % S::NRAW) * S::RAW;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (t0 + rho[k] >= 0 && src[k] >= 0)
            cp_async8(rw + dst[k], spans + src[k] + (long long)t0 * B * 6);
          else
            *reinterpret_cast<uint2*>(rw + dst[k]) = make_uint2(0u, 0u);
        }
      }
      cp_async_commit();  // one group a tile, empty past the last
    };
    // a consumed tile h's pairs, in two halves around a group barrier:
    // gather (this warp's codes into registers, its pair count) ...
    auto gather = [&](int h) {
      const int n = h >= 0 ? tile_n[h & 1][g] : 0;
      const uint4* const cb = rec + ((h & 1) * G + g) * STRIDE;
      int c = 0;
#pragma unroll
      for (int k = 0; k < HK; ++k) {
        const int j = HW * wg + 32 * k + lane;
        code[k] = NO_PAIR;
        fl[k] = 0;
        if (HW * wg + 32 * k < n) {  // the warp's chunk holds spans
          if (j < n) code[k] = cb[j].x;
          fl[k] = __ballot_sync(0xffffffffu, code[k] != NO_PAIR);
          c += __popc(fl[k]);
        }
      }
      return c;
    };
    // ... then place them in the scratch row from its end back (r order)
    auto place = [&]() {
      int at = P;
#pragma unroll
      for (int w = 0; w < SW; ++w) at += w < wg ? pairs[g][w] : 0;
#pragma unroll
      for (int k = 0; k < HK; ++k) {
        if (fl[k]) {
          if (code[k] != NO_PAIR)
            pb[2 * row6 - 1 - at - __popc(fl[k] & below)] =
                (unsigned short)__byte_perm(code[k], 0, 0x4401);  // high byte first
          at += __popc(fl[k]);
        }
      }
#pragma unroll
      for (int w = 0; w < SW; ++w) P += pairs[g][w];
    };

    for (int u = 0; u < S::NRAW - 1; ++u) fetch(u);
    int k = 0;                          // rounds staged
    for (int u = 0; u < ntiles; ++u) {  // tile u, while the chain runs round k - 1
      cp_async_wait<S::NRAW - 2>();     // tile u has landed (later ones may be in flight)
      staging_bar<NS>();  // ... for every thread; raw[(u - 1) % NRAW] was read
      fetch(u + S::NRAW - 1);
      unsigned sp[6];
      const uint2* rr = reinterpret_cast<const uint2*>(raw + (u % S::NRAW) * S::RAW +
                                                       (R - 1 - sg) * S::RS + 6 * g);
      int c = 0;
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        const uint2 w = rr[h];
        sp[2 * h] = w.x;
        sp[2 * h + 1] = w.y;
        c += (w.x != 0) + (w.y != 0);
      }
      if (!staging_any<NS>(c != 0)) continue;  // a tile empty in every block: no round
      const int pc = gather(k - 2);  // round k - 2, in the buffer round k goes to
      const int inc = warp_inclusive_sum(c);
      if (lane == 31) part[g][wg] = inc, pairs[g][wg] = pc;
      group_bar<G>(g);
      int q = inc - c, n = 0;
#pragma unroll
      for (int w = 0; w < SW; ++w) {
        q += w < wg ? part[g][w] : 0;
        n += part[g][w];
      }
      uint4* const rb = rec + ((k & 1) * G + g) * STRIDE;
#pragma unroll
      for (int h = 5; h >= 0; --h) {  // backward: slot 5 first
        const unsigned v = sp[h];
        if (v) rb[q++] = record((max(v >> 16, 1u) << 16) | (v & 0xFFFFu));
      }
      if (sg == 0) {
        tile_n[k & 1][g] = n;
        tile_r0[k & 1][g] = K;
      }
      if (st == 0) filled = k + 1;
      K += n;
      place();
      ++k;
      __syncthreads();
    }
    // the last two rounds' pairs, as the chain finishes them
    for (int h = k - 2; h < k; ++h) {
      const int pc = gather(h);
      if (lane == 0) pairs[g][wg] = pc;
      group_bar<G>(g);
      place();
      group_bar<G>(g);
      if (h == k - 2) {
        if (st == 0) filled = k;
        __syncthreads();
      }
    }
    if (sg == 0) {
      fin_k[g] = K;
      fin_p[g] = P;
    }
  }
  __syncthreads();

  // the stream rows: seeds (forward lane L is label (K - 1 - L) & 3), the
  // pairs in forward order from the end of the scratch row, zeros
  for (int g = 0; g < G && b0 + g < B; ++g) {
    const int b = b0 + g, K = fin_k[g], P = fin_p[g];
    const unsigned sd0 = seeds[g][(K - 1) & 3], sd1 = seeds[g][(K - 2) & 3];
    const unsigned sd2 = seeds[g][(K - 3) & 3], sd3 = seeds[g][(K - 4) & 3];
    const unsigned short* pr =
        reinterpret_cast<const unsigned short*>(scratch + (long long)b * 6 * T) + 12LL * T - P;
    unsigned char* out = stream + (long long)b * cap;
    if ((cap & 15) == 0) {
      uint4* o = reinterpret_cast<uint4*>(out);
      for (int ci = tid; ci < cap / 16; ci += S::NTHREADS) {
        uint4 v = make_uint4(sd0, sd1, sd2, sd3);
        if (ci > 0) {
          const int i0 = 8 * (ci - 1);
          unsigned w[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = i0 + 2 * m;
            w[m] = (i < P ? pr[i] : 0u) | (i + 1 < P ? (unsigned)pr[i + 1] << 16 : 0u);
          }
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        o[ci] = v;
      }
    } else {
      for (int p = tid; p < cap; p += S::NTHREADS) {
        unsigned v = 0;
        if (p < 16) {
          const unsigned sd = p < 8 ? (p < 4 ? sd0 : sd1) : (p < 12 ? sd2 : sd3);
          v = sd >> (8 * (p & 3));
        } else {
          const int i = (p - 16) >> 1;
          if (i < P) v = (p & 1) ? pr[i] >> 8 : pr[i];
        }
        out[p] = (unsigned char)v;
      }
    }
    if (tid == 0) rans_bytes[b] = 16 + 2 * P;
  }
}

// G: NLZM_RANS_BLOCKS, else the largest of 8, 4, 2, 1 whose CTAs leave at
// most 1/16 of the SMs idle (1 below that). The SM count is read once a
// device.
int blocks_a_cta(int B, int device) {
  if (NLZM_RANS_BLOCKS) return NLZM_RANS_BLOCKS;
  static int sms[64] = {};
  int n = device >= 0 && device < 64 ? sms[device] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) sms[device] = n;
  }
  int G = 8;
  while (G > 1 && 16 * ((B + G - 1) / G) < 15 * n) G >>= 1;
  return G;
}

// the dynamic shared-memory limit of G's kernel, set once a device
template <int G>
cudaError_t smem_setup(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute((const void*)rans_kernel<G>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Shape<G>::SMEM);
  if (e == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return e;
}

template <int G>
int launch(const void* spans, void* scratch, void* stream, void* rans_bytes, int T, int B,
           int cap, int device, cudaStream_t s) {
  const cudaError_t e = smem_setup<G>(device);
  if (e != cudaSuccess) return (int)e;
  rans_kernel<G><<<(B + G - 1) / G, Shape<G>::NTHREADS, Shape<G>::SMEM, s>>>(
      (const unsigned*)spans, T, B, cap, (unsigned*)scratch, (unsigned char*)stream,
      (int*)rans_bytes);
  return launch_status();
}

// G's kernel on this device: out[0..6] = G, threads, dynamic shared bytes,
// registers a thread, resident CTAs an SM, SMs, R.
template <int G>
int shape_of(int* out, int device) {
  cudaError_t e = smem_setup<G>(device);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, (const void*)rans_kernel<G>);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)rans_kernel<G>,
                                                      Shape<G>::NTHREADS, Shape<G>::SMEM);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {G, Shape<G>::NTHREADS, Shape<G>::SMEM, attr.numRegs, ctas, sms, R};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

__global__ void record_kernel(unsigned* out, int n) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < n) {
    const uint4 r = record((unsigned)max(f, 1) << 16);
    out[3 * f] = r.y;
    out[3 * f + 1] = r.z;
    out[3 * f + 2] = r.w;
  }
}

}  // namespace

// spans [T, B, 6] i32 (u32 bits); scratch [B, 6T] i32 (the pairs, u16, at
// the end of each row); stream [B, cap] u8; rans_bytes [B] i32.
NLZM_API int nlzm_rans_backward(const void* spans, void* scratch, void* stream, void* rans_bytes,
                                int T, int B, int cap, int device, void* cuda_stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (blocks_a_cta(B, device)) {
    case 8: return launch<8>(spans, scratch, stream, rans_bytes, T, B, cap, device, s);
    case 4: return launch<4>(spans, scratch, stream, rans_bytes, T, B, cap, device, s);
    case 2: return launch<2>(spans, scratch, stream, rans_bytes, T, B, cap, device, s);
    default: return launch<1>(spans, scratch, stream, rans_bytes, T, B, cap, device, s);
  }
}

// The launch shape at B, for reports: out[0..6] (host ints) = G, threads,
// dynamic shared bytes, registers a thread, resident CTAs an SM, SMs, R.
NLZM_API int nlzm_rans_shape(void* out, int B, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  int* o = (int*)out;
  switch (blocks_a_cta(B, device)) {
    case 8: return shape_of<8>(o, device);
    case 4: return shape_of<4>(o, device);
    case 2: return shape_of<2>(o, device);
    default: return shape_of<1>(o, device);
  }
}

// A span record's a and magic words for f in [0, n) (f = 0 as 1): out
// [n, 3] u32 on the device.
NLZM_API int nlzm_rans_records(void* out, int n, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return 0;
  record_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((unsigned*)out, n);
  return launch_status();
}
