// Batched canonical-Huffman decode of the huff0 block container: one
// symbol a block a step, 14-bit code length limit, left-justified tables.
//
// Replaces nlzm_tpu/research/huff0.py::_huff_scan_body. On the TPU every
// step was a dozen tensor ops over [B]: a 3-word window gather, 14 dense
// limit compares, one-hot selects of the length's base and offset and a
// one-hot contraction over the 256-entry symbol table. Here one thread
// decodes one block.
//
// Bound: latency of the serial chain (each symbol's length decides where
// the next one starts), T steps a block; bytes and operations are far
// below it. Design: one CTA a block; its threads load the symbol table
// into shared memory, then thread 0 walks the chain with the 14 limits,
// bases and offsets in registers (fully unrolled compares and selects).
// JAX refills a 22-bit window with up to two bytes a step and peeks at its
// top 14 bits; that is exactly the 14 bits at bit offset cb (the lengths
// decoded so far) of the stream, so a step reads the three bytes at
// cb >> 3 from global memory and advances cb by the length. Byte q is
// byte q & 3 of u32 word min(q >> 2, W - 1) of the stream zero-padded to
// W words, as JAX's clamped window reads it. The length and the symbol
// index are clamped as JAX clamps them.
#include "common.cuh"

namespace {

constexpr int LIMIT = 14;

__global__ void huff_scan_kernel(const uint8_t* __restrict__ streams,
                                 const int* __restrict__ base_l, const int* __restrict__ limit_l,
                                 const int* __restrict__ offs, const int* __restrict__ syms,
                                 uint8_t* __restrict__ out, int S, int T) {
  __shared__ int sym[256];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sym[i] = syms[b * 256 + i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int lim[LIMIT + 1], base[LIMIT + 1], off[LIMIT + 1];
#pragma unroll
  for (int l = 1; l <= LIMIT; ++l) {
    lim[l] = limit_l[b * (LIMIT + 1) + l];
    base[l] = base_l[b * (LIMIT + 1) + l];
    off[l] = offs[b * (LIMIT + 1) + l];
  }
  const uint8_t* st = streams + (long long)b * S;
  const int W = (S + 3) >> 2;
  uint8_t* o = out + (long long)b * T;
  int cb = 0;  // bits consumed
  for (int t = 0; t < T; ++t) {
    unsigned v = 0u;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int q = (cb >> 3) + k;
      const int at = (min(q >> 2, W - 1) << 2) | (q & 3);
      v = (v << 8) | (at < S ? (unsigned)st[at] : 0u);
    }
    const int peek = (int)(v >> (10 - (cb & 7))) & ((1 << LIMIT) - 1);
    int L = 1;
#pragma unroll
    for (int l = 1; l <= LIMIT; ++l) L += peek >= lim[l];
    L = min(L, LIMIT);
    int bl = 0, of = 0;
#pragma unroll
    for (int l = 1; l <= LIMIT; ++l) {
      if (L == l) {
        bl = base[l];
        of = off[l];
      }
    }
    o[t] = (uint8_t)sym[clampi(of + ((peek - bl) >> (LIMIT - L)), 0, 255)];
    cb += L;
  }
}

}  // namespace

// streams [B, S] u8; base_l, limit_l, offs [B, 15] i32; syms [B, 256] i32;
// out [B, T] u8.
NLZM_API int nlzm_huff_scan(const void* streams, const void* base_l, const void* limit_l,
                            const void* offs, const void* syms, void* out, int B, int S, int T,
                            int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || T == 0) return 0;
  if (S < 1) return (int)cudaErrorInvalidValue;
  huff_scan_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, (const int*)base_l, (const int*)limit_l, (const int*)offs,
      (const int*)syms, (uint8_t*)out, S, T);
  return launch_status();
}
