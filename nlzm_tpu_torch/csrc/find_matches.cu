// Hash-chain match candidates for the device parse: for every position,
// the k nearest earlier positions with the same 16-bit 4-byte hash, and
// their byte-exact match lengths.
//
// Replaces nlzm_tpu/ops/encode_ops.py::find_matches (with _extend_matches).
// The JAX function argsorts h * N + pos (a lexicographic 2-key sort above
// N = 32768), so equal hashes sit together with positions ascending; the
// entry k places back in sorted order is the k-th previous occurrence.
// Lengths compare 66 little-endian words against the candidate, which is
// the count of equal leading bytes of the block zero-padded past N, capped
// at MAX_MLEN = 264 and at n_valid - p.
//
// Bound: the sort. One CTA per block sorts its N keys in place with a
// bitonic network (log2(M) (log2(M) + 1) / 2 barrier-separated stages over
// M = next power of two >= N keys). Design:
// - N <= 32768: the u32 keys h * N + pos (at most 2^31 - 1) and the
//   block's bytes live in dynamic shared memory (160 KiB at N = 32768,
//   opt-in above 48 KiB), so the sort and the length compares never touch
//   device memory after one coalesced load.
// - N > 32768: u64 keys in a global scratch buffer [B, M] the wrapper
//   allocates, the bytes read from device memory; the same network.
// - After the sort each thread takes sorted entries i: the candidate k is
//   entry i - k when its hash is equal, dropped past `reach`. Lengths are
//   a byte loop that stops at the first difference (no per-position
//   backward search). Outputs scatter back to position order.
// - Every position appears once in the sorted order, so every output is
//   written; n_valid is clamped to [0, N].
#include "common.cuh"

namespace {

constexpr int NTHREADS = 1024;
constexpr int MAX_MLEN = 264;
constexpr unsigned HASH4_MULT = 987660757u;

__device__ __forceinline__ unsigned byte_at(const uint8_t* row, int j, int N) {
  return j < N ? (unsigned)row[j] : 0u;
}

// 16-bit hash of the little-endian 4-byte word at p (zeros past N).
__device__ __forceinline__ unsigned hash_at(const uint8_t* row, int p, int N) {
  const unsigned w = byte_at(row, p, N) | (byte_at(row, p + 1, N) << 8) |
                     (byte_at(row, p + 2, N) << 16) | (byte_at(row, p + 3, N) << 24);
  return (w * HASH4_MULT) >> 16;  // u32 product: mod 2^32
}

// Equal leading bytes at p and q (q < p), at most MAX_MLEN, over the row
// zero-padded past N.
__device__ __forceinline__ int common_prefix(const uint8_t* row, int p, int q, int N) {
  int n = 0;
  while (n < MAX_MLEN && byte_at(row, p + n, N) == byte_at(row, q + n, N)) ++n;
  return n;
}

// Ascending bitonic sort of M (a power of two) keys by the whole block;
// keys may sit in shared or device memory.
template <typename K>
__device__ void bitonic_sort(K* keys, int M) {
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (M >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const K a = keys[lo], b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <typename K, bool SMEM>
__global__ void __launch_bounds__(NTHREADS)
    find_matches_kernel(const uint8_t* __restrict__ data, const int* __restrict__ n_valid,
                        int* __restrict__ delta, int* __restrict__ mlen, K* gkeys, int N, int M,
                        int reach, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, t = threadIdx.x;
  const uint8_t* row = data + (long long)b * N;
  K* keys;
  if (SMEM) {
    keys = reinterpret_cast<K*>(smem);
    uint8_t* srow = smem + (size_t)M * sizeof(K);
    for (int i = t; i < N; i += NTHREADS) srow[i] = row[i];
    row = srow;
    __syncthreads();
  } else {
    keys = gkeys + (long long)b * M;
  }
  for (int i = t; i < M; i += NTHREADS)
    keys[i] = i < N ? (K)hash_at(row, i, N) * (K)N + (K)i : ~(K)0;
  __syncthreads();
  bitonic_sort(keys, M);

  const int nv = clampi(n_valid[b], 0, N);
  for (int i = t; i < N; i += NTHREADS) {
    const K ki = keys[i];
    const K hi = ki / (K)N;
    const int p = (int)(ki - hi * (K)N);
    const long long o = ((long long)b * N + p) * C;
    for (int k = 1; k <= C; ++k) {
      int d = 0, l = 0;
      if (i >= k) {
        const K kq = keys[i - k];
        const K hq = kq / (K)N;
        if (hq == hi) {
          const int q = (int)(kq - hq * (K)N);
          const int dd = p - q;
          if (dd > 0 && dd <= reach) {
            d = dd;
            l = min(common_prefix(row, p, q, N), max(nv - p, 0));
          }
        }
      }
      delta[o + k - 1] = d;
      mlen[o + k - 1] = l;
    }
  }
}

}  // namespace

// data [B, N] u8 (zero padded past n_valid); n_valid [B] i32; delta and
// mlen [B, N, C] i32 out; gkeys: u64 [B, M] scratch when N > 32768, else
// unused (may be null). M: the next power of two >= N.
NLZM_API int nlzm_find_matches(const void* data, const void* n_valid, void* delta, void* mlen,
                               void* gkeys, int B, int N, int M, int reach, int C, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 32768) {
    const size_t bytes = (size_t)M * sizeof(unsigned) + (size_t)N;
    auto kern = find_matches_kernel<unsigned, true>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, NTHREADS, bytes, s>>>((const uint8_t*)data, (const int*)n_valid, (int*)delta,
                                    (int*)mlen, nullptr, N, M, reach, C);
  } else {
    find_matches_kernel<unsigned long long, false><<<B, NTHREADS, 0, s>>>(
        (const uint8_t*)data, (const int*)n_valid, (int*)delta, (int*)mlen,
        (unsigned long long*)gkeys, N, M, reach, C);
  }
  return launch_status();
}
