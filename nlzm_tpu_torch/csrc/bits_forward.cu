// MSB-first packing of the raw-bit fields into a frame's bit section.
//
// Replaces nlzm_tpu/ops/encode_ops.py::bits_forward. The TPU version scans
// the steps forward with a 32-bit accumulator per block, flushing up to
// three whole bytes after each field with a dropping scatter, and drains
// four bytes at the end.
//
// That loop's output is the concatenation of every field's bits (field a,
// then field b, per step; each value masked to clip(nb, 0, 24) bits),
// zero padded: full bytes at < cap, then the drain, which writes its four
// bytes at min(n, cap - 1) for n = full bytes .. full bytes + 3 (a partial
// byte, then zeros), so byte cap - 1 ends zero once n + 3 reaches it.
//
// Bound: bytes; the four [T, B] fields are read once and the sections
// written once. Design: a CTA takes G adjacent blocks (G = 8: a field row's
// 8 ints are one 32-byte sector). A CTA walks T x G / 4096 tiles one after
// another, while the grid pulls (B / G) x T sectors of each field through
// L2, so G balances the two: G = 8, halved while the grid would have fewer
// than 16 G CTAs (8 from 1017 blocks, 4 from 253, 2 from 63, else 1: of G =
// 1, 2, 4, 8 the fastest, or within 1% of it, on the v1 fields at B = 8 to
// 1024, T = 8192, on an H100), and halved while G sections would not fit in
// shared memory. Their sections sit in shared memory as big-endian u32
// words. The CTA walks the steps in tiles of NT / G runs of R steps a block:
// thread t takes block t % G and run t / G, so each load of a warp reads
// whole sectors of 32 / G rows. A thread loads its run's 4R values of the
// next tile before it packs this one, so they arrive while it packs; it
// keeps each field as value << 5 | bit count. A run's first bit is its
// block's bits before the tile (left by the last warp of the tile before),
// plus the sums of the block's runs in earlier warps (read from shared
// memory after the tile's one barrier), plus those of the earlier lanes of
// its warp (shuffles at stride G). The run builds its bits in a 64-bit
// accumulator and stores each whole word: only its first word (when it
// starts inside a word) and its last partial word can hold a neighbour's
// bits, and those take atomicOr. Words past cap are dropped. At the end byte
// cap - 1 takes the drain's zero and the sections go out with 16-byte stores
// (each row's unaligned head and tail by bytes).
#include "common.cuh"

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int R = 8;                   // steps a run
constexpr int SMEM_MAX = 224 * 1024;  // dynamic shared bytes a CTA takes at most

__device__ __forceinline__ void emit(unsigned* words, int nw, int w, unsigned word,
                                     bool shared) {
  if (w >= nw) return;  // past cap: dropped
  if (shared)
    atomicOr(words + w, word);
  else
    words[w] = word;
}

__device__ __forceinline__ unsigned char byte_of(const unsigned* words, int i) {
  return (unsigned char)(words[i >> 2] >> (24 - 8 * (i & 3)));
}

template <int G>
__global__ void __launch_bounds__(NT, 1)
    bits_forward_kernel(const int* __restrict__ va, const int* __restrict__ nba,
                        const int* __restrict__ vb, const int* __restrict__ nbb, int T, int B,
                        int cap, int SW, unsigned char* __restrict__ out,
                        int* __restrict__ n_bytes) {
  extern __shared__ unsigned sm[];  // G sections of SW words (word nw on: zero)
  // by tile parity: each warp's run total of each block, and each block's
  // bits before the tile
  __shared__ int wsum[2][NWARP][G];
  __shared__ int carry[2][G];
  constexpr int RUNS = NT / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid & (G - 1), run = tid / G;
  const int b = blockIdx.x * G + g;
  const bool live = b < B;
  const int nw = (cap + 3) >> 2;
  for (int i = tid; i < G * SW; i += NT) sm[i] = 0;
  if (tid < G) carry[0][tid] = 0;
  __syncthreads();
  unsigned* words = sm + g * SW;

  // a tile's raw fields, loaded one tile ahead of the one being packed
  int ra[R], rna[R], rb[R], rnb[R];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool in = live && t0 + i < T;
      const long long at = (long long)(t0 + i) * B + b;
      rna[i] = in ? __ldg(nba + at) : 0;
      rnb[i] = in ? __ldg(nbb + at) : 0;
      ra[i] = in ? __ldg(va + at) : 0;
      rb[i] = in ? __ldg(vb + at) : 0;
    }
  };
  load(run * R);

  int tile = 0;
  for (int base = 0; base < T; base += RUNS * R, ++tile) {
    unsigned fa[R], fb[R];  // each field as value << 5 | bit count
    int s = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int na = clampi(rna[i], 0, 24), nb = clampi(rnb[i], 0, 24);
      fa[i] = ((unsigned)ra[i] & ((1u << na) - 1)) << 5 | na;
      fb[i] = ((unsigned)rb[i] & ((1u << nb) - 1)) << 5 | nb;
      s += na + nb;
    }
    if (base + RUNS * R < T) load(base + RUNS * R + run * R);  // in flight while this tile packs
    // the run's first bit: the block's bits before the tile, its runs in
    // earlier warps, and in this warp those of lanes lane - G, lane - 2G, ...
    int incl = s;
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += z;
    }
    int(*ws)[G] = wsum[tile & 1];
    if (lane >= 32 - G) ws[warp][g] = incl;
    __syncthreads();
    int before = carry[tile & 1][g];
    for (int w = 0; w < warp; ++w) before += ws[w][g];
    if (warp == NWARP - 1 && lane >= 32 - G) carry[(tile + 1) & 1][g] = before + incl;
    if (s == 0) continue;
    const int off = before + incl - s;

    int w = off >> 5, used = off & 31;
    bool head = used != 0;  // the first word may hold the run before's bits
    unsigned long long acc = 0;
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      const unsigned f = i & 1 ? fb[i >> 1] : fa[i >> 1];
      const int n = f & 31;
      acc |= (unsigned long long)(f >> 5) << ((64 - used - n) & 63);  // 0 when n = 0
      used += n;
      if (used >= 32) {
        emit(words, nw, w, (unsigned)(acc >> 32), head);
        head = false;
        acc <<= 32;
        used -= 32;
        ++w;
      }
    }
    if (used) emit(words, nw, w, (unsigned)(acc >> 32), true);  // the run after may share it
  }
  __syncthreads();

  if (tid < G && blockIdx.x * G + tid < B) {
    const int full = carry[tile & 1][tid] >> 3;
    n_bytes[blockIdx.x * G + tid] = full + 4;
    if (full + 4 >= cap) {  // the drain's last byte
      const int i = cap - 1;
      sm[tid * SW + (i >> 2)] &= ~(0xFFu << (24 - 8 * (i & 3)));
    }
  }
  __syncthreads();

  for (int gg = 0; gg < G && blockIdx.x * G + gg < B; ++gg) {
    const unsigned* wd = sm + gg * SW;
    unsigned char* row = out + (long long)(blockIdx.x * G + gg) * cap;
    const int h = min((int)((16 - ((uintptr_t)row & 15)) & 15), cap);
    const int nchunk = (cap - h) >> 4;
    const int tail = h + (nchunk << 4);
    if (tid < h) row[tid] = byte_of(wd, tid);
    if (tail + tid < cap) row[tail + tid] = byte_of(wd, tail + tid);
    for (int q = tid; q < nchunk; q += NT) {
      const int i = h + (q << 4);
      const unsigned* p = wd + (i >> 2);
      const int sh = 8 * (i & 3);
      unsigned w5[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) w5[k] = __byte_perm(p[k], 0, 0x0123);  // bytes in order
      uint4 o;
      o.x = __funnelshift_r(w5[0], w5[1], sh);
      o.y = __funnelshift_r(w5[1], w5[2], sh);
      o.z = __funnelshift_r(w5[2], w5[3], sh);
      o.w = __funnelshift_r(w5[3], w5[4], sh);
      *reinterpret_cast<uint4*>(row + i) = o;
    }
  }
}

// words a section: one past cap's (the 16-byte copy reads word nw), odd so
// the G sections start on different banks
int section_words(int cap) { return (((cap + 3) >> 2) + 1) | 1; }

int group_of(int B, int cap) {
  const long long sec = 4LL * section_words(cap);
  int G = 8;
  while (G > 1 && (G * sec > SMEM_MAX || (B + G - 1) / G < 16 * G)) G >>= 1;
  return G;
}

const void* kernel_for(int G) {
  switch (G) {
    case 8: return (const void*)bits_forward_kernel<8>;
    case 4: return (const void*)bits_forward_kernel<4>;
    case 2: return (const void*)bits_forward_kernel<2>;
    default: return (const void*)bits_forward_kernel<1>;
  }
}

cudaError_t allow_smem(const void* fn, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

}  // namespace

// va, nba, vb, nbb [T, B] i32; out [B, cap] u8; n_bytes [B] i32.
NLZM_API int nlzm_bits_forward(const void* va, const void* nba, const void* vb, const void* nbb,
                               void* out, void* n_bytes, int T, int B, int cap, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  const int SW = section_words(cap);
  const int G = group_of(B, cap);
  const int smem = 4 * G * SW;
  const void* fn = kernel_for(G);
  void* args[] = {(void*)&va, (void*)&nba, (void*)&vb, (void*)&nbb, (void*)&T, (void*)&B,
                  (void*)&cap, (void*)&SW, (void*)&out, (void*)&n_bytes};
  cudaError_t e = allow_smem(fn, smem);
  if (e == cudaSuccess)
    e = cudaLaunchKernel(fn, dim3((B + G - 1) / G), dim3(NT), args, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : launch_status();
}

// out[7]: blocks a CTA (G), threads a CTA, dynamic shared bytes, registers
// a thread, resident CTAs an SM, SMs, steps a tile; the launch at (B, cap).
NLZM_API int nlzm_bits_shape(void* out, int B, int cap, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  const int G = group_of(B, cap);
  const int smem = 4 * G * section_words(cap);
  const void* fn = kernel_for(G);
  cudaError_t e = allow_smem(fn, smem);
  cudaFuncAttributes attr = {};
  int ctas = 0, sms = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {G, NT, smem, attr.numRegs, ctas, sms, NT / G * R};
  for (int i = 0; i < 7; ++i) ((int*)out)[i] = v[i];
  return 0;
}
