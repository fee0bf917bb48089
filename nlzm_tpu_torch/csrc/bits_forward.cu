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
// Design: one CTA per block, the section in shared memory as big-endian
// u32 words (zeroed, one spare word past cap). 256 steps at a time, one
// thread per step: a block scan of the bit lengths gives each field's bit
// offset, and the field ORs its <= 24 bits into at most two words
// (atomicOr: the fields never overlap, so order does not matter; bits
// past cap are dropped). The words are then written out byte by byte,
// with the drain's last zero at cap - 1.
//
// Bound: bytes; the four [T, B] fields are read once (rows B apart, one
// sector a load) and the section written once.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// OR the nb-bit value v into the MSB-first bit string at bit offset off
__device__ __forceinline__ void put(unsigned* words, int nw, long long off, unsigned v, int nb) {
  const long long w = off >> 5;
  if (nb == 0 || w >= nw) return;
  const int e = (int)(off & 31) + nb;  // end of the field in words w, w + 1
  if (e <= 32) {
    atomicOr(&words[w], v << (32 - e));
  } else {
    atomicOr(&words[w], v >> (e - 32));
    atomicOr(&words[w + 1], v << (64 - e));  // word nw is the spare
  }
}

__global__ void __launch_bounds__(NT)
    bits_forward_kernel(const int* __restrict__ va, const int* __restrict__ nba,
                        const int* __restrict__ vb, const int* __restrict__ nbb, int T, int B,
                        int cap, unsigned char* __restrict__ out, int* __restrict__ n_bytes) {
  extern __shared__ unsigned words[];  // nw + 1
  __shared__ int scan[32][1];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nw = (cap + 3) >> 2;
  for (int i = tid; i <= nw; i += NT) words[i] = 0;
  __syncthreads();

  long long bits = 0;
  for (int base = 0; base < T; base += NT) {
    const int t = base + tid;
    unsigned a = 0, c = 0;
    int na = 0, nc = 0;
    if (t < T) {
      const long long at = (long long)t * B + b;
      na = clampi(nba[at], 0, 24);
      nc = clampi(nbb[at], 0, 24);
      a = (unsigned)va[at] & ((1u << na) - 1);
      c = (unsigned)vb[at] & ((1u << nc) - 1);
    }
    int v[1] = {na + nc}, tot[1];
    block_exclusive_scan<1>(v, tot, scan);
    const long long off = bits + v[0];
    put(words, nw, off, a, na);
    put(words, nw, off + na, c, nc);
    bits += tot[0];
  }
  __syncthreads();

  const long long full = bits >> 3;
  unsigned char* row = out + (long long)b * cap;
  for (int i = tid; i < cap; i += NT) {
    unsigned char byte = (unsigned char)(words[i >> 2] >> (24 - 8 * (i & 3)));
    if (i == cap - 1 && full + 4 >= cap) byte = 0;  // the drain's last byte
    row[i] = byte;
  }
  if (tid == 0) n_bytes[b] = (int)(unsigned)(full + 4);
}

}  // namespace

// va, nba, vb, nbb [T, B] i32; out [B, cap] u8; n_bytes [B] i32.
NLZM_API int nlzm_bits_forward(const void* va, const void* nba, const void* vb, const void* nbb,
                               void* out, void* n_bytes, int T, int B, int cap, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  const int smem = 4 * ((cap + 3) / 4 + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bits_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  bits_forward_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      (const int*)va, (const int*)nba, (const int*)vb, (const int*)nbb, T, B, cap,
      (unsigned char*)out, (int*)n_bytes);
  return launch_status();
}
