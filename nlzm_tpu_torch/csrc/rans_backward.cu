// 4-lane interleaved rANS encode of a span stream, backward.
//
// Replaces nlzm_tpu/ops/encode_ops.py::rans_backward. The TPU version scans
// the [T, B, 6] spans backward with every block's four lane states in
// registers (one-hot lane selects), then compacts the renorm pairs into
// place with a cumulative sum and a dropping scatter.
//
// The JAX lane of a span is cnt & 3, with cnt the number of nonzero spans
// before it in forward order (t, then slot): span k of the compacted
// stream codes on lane k & 3, so the four lanes are four independent
// chains. Design: one CTA per block, three passes.
// 1. Compaction: 256 steps at a time, one thread per step; a block scan of
//    the nonzero counts places the spans, in forward order, in the block's
//    row of a global scratch [B, 6T].
// 2. The chains: thread j < 4 walks k = j mod 4 from the last such span
//    back to 0, from state 1 << 16, in u32 exactly as JAX: over = x >=
//    (f << 18) (which wraps to 0 at f = 2^14: always a renorm there),
//    x1 = over ? x >> 16 : x, x = ((x1 / f) << 14) + x1 % f + start, f =
//    max(freq, 1). It overwrites span k with its pair (x & 0xFFFF) or with
//    0x10000 for none, and loads span k - 4 before working on span k.
// 3. Placement: the row is zero filled and the four final states written
//    (u32 little-endian, lane 0 first); a block scan of the pair flags
//    places pair i at bytes 16 + 2i (high byte first). Bytes at or past
//    cap are dropped (the JAX scatter's mode="drop").
//
// Bound: the latency of the longest chain (a division per span, about a
// quarter of the block's spans); the spans are read once, the stream
// written once.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr unsigned NO_PAIR = 0x10000u;

__global__ void __launch_bounds__(NT)
    rans_backward_kernel(const unsigned* __restrict__ spans, int T, int B, int cap,
                         unsigned* __restrict__ scratch, unsigned char* __restrict__ stream,
                         int* __restrict__ rans_bytes) {
  __shared__ int scan[32][1];
  __shared__ unsigned seeds[4];
  const int b = blockIdx.x, tid = threadIdx.x;
  unsigned* comp = scratch + (long long)b * 6 * T;
  unsigned char* out = stream + (long long)b * cap;

  // 1. compaction, forward order
  int K = 0;
  for (int base = 0; base < T; base += NT) {
    const int t = base + tid;
    unsigned s[6] = {0, 0, 0, 0, 0, 0};
    if (t < T) {
      const uint2* p = reinterpret_cast<const uint2*>(spans + ((long long)t * B + b) * 6);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint2 w = p[i];
        s[2 * i] = w.x;
        s[2 * i + 1] = w.y;
      }
    }
    int v[1] = {0}, tot[1];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[0] += s[i] != 0;
    block_exclusive_scan<1>(v, tot, scan);
    int k = K + v[0];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (s[i] != 0) comp[k++] = s[i];
    K += tot[0];
  }
  __syncthreads();

  // 2. the four lane chains, backward
  if (tid < 4) {
    unsigned x = 1u << 16;
    if (tid < K) {
      int k = tid + ((K - 1 - tid) >> 2) * 4;  // the last span of lane tid
      unsigned sp = comp[k];
      for (; k >= 0; k -= 4) {
        const unsigned nxt = k >= 4 ? comp[k - 4] : 0u;
        const unsigned fq = max(sp >> 16, 1u);
        const bool over = x >= (fq << 18);
        const unsigned pair = x & 0xFFFFu;
        const unsigned x1 = over ? x >> 16 : x;
        x = ((x1 / fq) << 14) + x1 % fq + (sp & 0xFFFFu);
        comp[k] = over ? pair : NO_PAIR;
        sp = nxt;
      }
    }
    seeds[tid] = x;
  }
  __syncthreads();

  // 3. seeds, zero fill, then the pairs in forward order
  for (int i = tid; i < cap; i += NT)
    out[i] = i < 16 ? (unsigned char)(seeds[i >> 2] >> (8 * (i & 3))) : 0;
  __syncthreads();
  int pairs = 0;
  for (int base = 0; base < K; base += NT) {
    const int k = base + tid;
    const unsigned code = k < K ? comp[k] : NO_PAIR;
    int v[1] = {code != NO_PAIR}, tot[1];
    block_exclusive_scan<1>(v, tot, scan);
    if (code != NO_PAIR) {
      const long long at = 16 + 2 * ((long long)pairs + v[0]);
      if (at < cap) out[at] = (unsigned char)(code >> 8);
      if (at + 1 < cap) out[at + 1] = (unsigned char)code;
    }
    pairs += tot[0];
  }
  if (tid == 0) rans_bytes[b] = (int)(16u + 2u * (unsigned)pairs);
}

}  // namespace

// spans [T, B, 6] i32 (u32 bits); scratch [B, 6T] i32; stream [B, cap] u8;
// rans_bytes [B] i32.
NLZM_API int nlzm_rans_backward(const void* spans, void* scratch, void* stream, void* rans_bytes,
                                int T, int B, int cap, int device, void* cuda_stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  rans_backward_kernel<<<B, NT, 0, (cudaStream_t)cuda_stream>>>(
      (const unsigned*)spans, T, B, cap, (unsigned*)scratch, (unsigned char*)stream,
      (int*)rans_bytes);
  return launch_status();
}
