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
// at MAX_MLEN = 264 and at max(n_valid - p, 0) in int32 (wrapping, as JAX).
//
// Bound: issue and shared-memory traffic; the bytes moved are small (the
// block in, 8C bytes a position out). One CTA a block; nothing is sorted
// by comparisons and nothing is written in sorted order:
// - The block's bytes go to shared memory once (16-byte loads), with
//   PAD zero bytes past N, so every word read below needs no bounds test;
//   a word at any byte offset is two aligned loads and a funnel shift.
// - Only prev[p], the nearest q < p with the same hash, is needed:
//   candidate k of p is prev applied k times (a hash's entries are
//   contiguous in JAX's sorted order). Two stable 8-bit passes give it.
//   Warp w owns the items [32 R w, 32 R (w + 1)), a round of 32 adjacent
//   items at a time, lanes in order, so ranking a round by its peers (the
//   lanes with the same digit, found by eight ballots) keeps item order:
//   stability by construction. (__match_any_sync takes time in the number
//   of distinct digits of the round: most of the kernel's on text.)
//   * Pass 1 sorts positions by the hash's low byte: per-warp digit
//     counts (shared atomics), one block scan over them in digit-major
//     order (the offsets), then each round scatters its positions to
//     offset + rank among its peers. `order` then holds positions by (low
//     byte, position).
//   * Pass 2 never scatters by rank. The final order is `order` stably
//     sorted by the high byte, so an item's predecessor there is the
//     previous item of `order` with the same high byte: a lower peer of its
//     round, else the last such item of earlier rounds and warps (each
//     warp's last item a digit, carried forward across warps). It has the
//     same hash when the low bytes agree too: then prev[pos] = that
//     position, written by position, else none.
// - Lengths in position order, a warp taking 32 adjacent positions at a
//   time: the candidate chain walks prev (one out of reach ends it:
//   farther ones are out of reach too); each lane compares its first SHORT
//   bytes alone, two words a step (XOR, __ffs for the first unequal
//   byte); past them the warp searches together (long_prefix): lanes with
//   one distance share the mismatches of byte y against y - d, so 32 lanes
//   compare 128 bytes a step for all of them. A divergent byte or word
//   loop would run every warp as long as its longest match, and text's
//   few long matches then took more time than all the rest of the lengths.
// - Stores in position order: for C <= 4 a warp's [32, C] tile of delta
//   and of mlen is transposed by shuffles into C fully coalesced rows.
// - N <= 32768: positions as u16 in shared memory (`order` and `prev`,
//   64 KiB each at 32768); above, u32 in the global scratch the wrapper
//   allocates ([B, 2, N]); the bytes stay in shared memory up to the
//   format's 131072 (128 KiB + the pad + counters).
// - Threads a CTA: ITEMS items a lane, or FEW_ITEMS when the grid is
//   smaller than FEW_BLOCKS, where a block's latency is the launch's.
// - Build options, for match_compare.py's split of the time: NLZM_FM_STOP
//   = 1..4 ends the kernel after the counts and offsets, pass 1, pass 2's
//   last items, or the sort; NLZM_FM_NO_COMPARE keeps the chain and the
//   stores and compares no byte. Their outputs are not find_matches'.
#include "common.cuh"

namespace {

constexpr int MAX_MLEN = 264;
constexpr int PAD = 272;  // zero bytes past N: the last word pair a length reads ends at N + 266
constexpr unsigned HASH4_MULT = 987660757u;
constexpr int DIGITS = 256;
constexpr int ROW = DIGITS + 1;  // a warp's counters, padded: the scan's reads spread over banks
constexpr unsigned NONE = 0xFFFFFFFFu;  // no item (pass 2's carried last)
constexpr int SMEM_MAX_N = 32768;
constexpr int MAX_N = 131072;
constexpr int ITEMS = 16;  // items a lane (rounds a warp) at most, up to 1024 threads
constexpr int FEW_ITEMS = 4;
constexpr int FEW_BLOCKS = 264;  // two CTAs on each of the H100's 132 SMs
constexpr int SHORT = 16;  // bytes a lane compares alone; past them the warp searches together

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// Threads a CTA for B blocks of N bytes: ceil(N / items) rounded up to a
// warp, within [32, 1024].
int threads_for(int B, int N) {
  const int items = B < FEW_BLOCKS ? FEW_ITEMS : ITEMS;
  const int t = (N + items - 1) / items;
  return t <= 32 ? 32 : (t >= 1024 ? 1024 : (t + 31) & ~31);
}

// Dynamic shared bytes: the padded bytes, order and prev when they live in
// shared memory, the per-warp counters and the scan's scratch.
int smem_bytes(int N, int T) {
  const int pos = N <= SMEM_MAX_N ? 2 * align16(N * 2) : 0;
  return align16(N + PAD) + pos + (T / 32) * ROW * 4 + 32 * 4;
}

// The little-endian word at byte offset y (W: the padded bytes as u32):
// two aligned words, a funnel shift.
__device__ __forceinline__ unsigned word_at(const unsigned* W, unsigned y) {
  return __funnelshift_r(W[y >> 2], W[(y >> 2) + 1], (y & 3) * 8);
}

// 16-bit hash of the word at p.
__device__ __forceinline__ unsigned hash_at(const unsigned* W, unsigned p) {
  return (word_at(W, p) * HASH4_MULT) >> 16;  // u32 product: mod 2^32
}

// The lanes whose digit (0..255) equals this lane's, among the lanes
// whose `v` equals this lane's (every lane calls): a ballot a bit, the
// last only for a round past N.
__device__ __forceinline__ unsigned peers_of(unsigned digit, bool v, bool full) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool on = (digit >> bit) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    peers &= on ? m : ~m;
  }
  if (!full) {
    const unsigned m = __ballot_sync(0xffffffffu, v);
    peers &= v ? m : ~m;
  }
  return peers;
}

// The first SHORT bytes of common_prefix of p against every candidate
// Q[k] at once (0 where Q[k] is none; the words at p loaded once a step
// for all of them). Returns the mask of candidates equal through SHORT
// bytes, whose lengths long_prefix finishes.
template <int CC>
__device__ __forceinline__ unsigned short_prefixes(const unsigned* W, unsigned p,
                                                   const unsigned (&Q)[CC], unsigned none,
                                                   int (&L)[CC]) {
  unsigned ip = p >> 2, iq[CC], sq[CC], q0[CC], alive = 0;
  const unsigned sp = (p & 3) * 8;
#pragma unroll
  for (int k = 0; k < CC; ++k) {
    L[k] = 0;
    iq[k] = Q[k] >> 2;
    sq[k] = (Q[k] & 3) * 8;
    if (Q[k] != none) {
      alive |= 1u << k;
      q0[k] = W[iq[k]];
    }
  }
  unsigned p0 = W[ip];
  for (int n = 0; alive && n < SHORT; n += 8) {
    const unsigned p1 = W[ip + 1], p2 = W[ip + 2];
    const unsigned a0 = __funnelshift_r(p0, p1, sp), a1 = __funnelshift_r(p1, p2, sp);
#pragma unroll
    for (int k = 0; k < CC; ++k) {
      if (!((alive >> k) & 1u)) continue;
      const unsigned q1 = W[iq[k] + 1], q2 = W[iq[k] + 2];
      const unsigned x0 = a0 ^ __funnelshift_r(q0[k], q1, sq[k]);
      const unsigned x1 = a1 ^ __funnelshift_r(q1, q2, sq[k]);
      if (x0 | x1) {
        L[k] = n + (x0 ? (__ffs(x0) - 1) >> 3 : 4 + ((__ffs(x1) - 1) >> 3));
        alive &= ~(1u << k);
      }
      iq[k] += 2;
      q0[k] = q2;
    }
    ip += 2;
    p0 = p2;
  }
  return alive;
}

// Lengths past the first SHORT bytes, for the lanes (positions p0 + lane)
// whose candidate at distance d still matched there (`alive`): the warp
// searches together. Lanes with one distance d share the mismatches of
// byte y against byte y - d; for the lowest alive lane s and every alive
// lane with its d, the 32 lanes compare 4 bytes each, 128 a step, over
// [p_s + SHORT, p_last + MAX_MLEN), and each lane takes the first mismatch
// from its own p + SHORT (every mismatch bit of the range is kept). Every
// lane of the warp calls; L is set where alive.
__device__ __forceinline__ void long_prefix(const unsigned* W, int p0, bool alive, int d, int& L) {
  const int lane = threadIdx.x & 31;
  constexpr int STEPS = (31 + MAX_MLEN - SHORT + 127) / 128;
  unsigned todo = __ballot_sync(0xffffffffu, alive);
  while (todo) {
    const int s = __ffs(todo) - 1;
    const int ds = __shfl_sync(0xffffffffu, d, s);
    const unsigned group = __ballot_sync(0xffffffffu, alive && d == ds);
    const int base = p0 + s + SHORT, end = p0 + 31 - __clz(group) + MAX_MLEN;
    unsigned X[STEPS], M[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int y = base + 128 * j + 4 * lane;
      X[j] = y < end ? word_at(W, y) ^ word_at(W, y - ds) : 0u;
      M[j] = __ballot_sync(0xffffffffu, X[j] != 0);
    }
    // this lane's start is r bytes into the range, in word c (c < 8); the
    // first mismatch from there is in word c, else in the first word past
    // c with one (cc; -1: none). Every lane shuffles.
    const int r = max(lane - s, 0), c = r >> 2;
    const unsigned xc = __shfl_sync(0xffffffffu, X[0], c) & (~0u << (8 * (r & 3)));
    int cc = -1;
#pragma unroll
    for (int j = STEPS - 1; j >= 0; --j) {
      const unsigned above = j == 0 ? M[0] & ~((2u << c) - 1u) : M[j];
      if (above) cc = 32 * j + __ffs(above) - 1;
    }
    unsigned xn = 0;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const unsigned y = __shfl_sync(0xffffffffu, X[j], cc & 31);
      if (cc >> 5 == j) xn = y;
    }
    if ((group >> lane) & 1u) {
      const unsigned x = xc ? xc : xn;
      const int m = 4 * (xc ? c : cc) + ((__ffs(x) - 1) >> 3);  // bytes into the range
      L = x ? min(SHORT + m - r, MAX_MLEN) : MAX_MLEN;
      alive = false;
    }
    todo &= ~group;
  }
}

// A warp's [32, CC] tile V (lane = position p0 + lane) stored as rows of
// out [N, CC] in position order: CC coalesced rows of 32 ints.
template <int CC>
__device__ __forceinline__ void store_tile(int* out, const int (&V)[CC], int p0, int N) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < CC; ++r) {
    const int i = r * 32 + lane, src = i / CC, k = i - src * CC;
    int x = 0;
#pragma unroll
    for (int kk = 0; kk < CC; ++kk) {
      const int y = __shfl_sync(0xffffffffu, V[kk], src);
      if (kk == k) x = y;
    }
    if (p0 * CC + i < N * CC) out[p0 * CC + i] = x;
  }
}

#ifdef NLZM_FM_STOP
#define FM_STOP(k)                                                    \
  if (NLZM_FM_STOP == k) {                                            \
    if (t == 0) delta[(size_t)b * N * C] = (int)hist[0] + (int)prev[N - 1]; \
    return;                                                           \
  }
#else
#define FM_STOP(k)
#endif

// CC: candidates a position, 1..4 (in registers, stored as tiles), or 0
// for any C (a candidate at a time, stored where it is).
template <typename Pos, bool SMEM, int CC>
__global__ void __launch_bounds__(1024)
    find_matches_kernel(const uint8_t* __restrict__ data, const int* __restrict__ n_valid,
                        int* __restrict__ delta, int* __restrict__ mlen, unsigned* gpos, int N,
                        int reach, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned none = (Pos)~(Pos)0;  // no candidate
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int T = blockDim.x, NW = T >> 5, R = (N + T - 1) / T;
  const unsigned lt = (1u << lane) - 1u;

  uint8_t* bytes = smem;
  const unsigned* W = reinterpret_cast<const unsigned*>(smem);
  unsigned char* next = smem + align16(N + PAD);
  Pos *order, *prev;  // positions by (low hash byte, position); then prev by position
  if constexpr (SMEM) {
    order = reinterpret_cast<Pos*>(next);
    prev = reinterpret_cast<Pos*>(next + align16(N * 2));
    next += 2 * align16(N * 2);
  } else {
    order = reinterpret_cast<Pos*>(gpos + (size_t)b * 2 * N);
    prev = order + N;
  }
  unsigned* hist = reinterpret_cast<unsigned*>(next);  // [NW][ROW]
  int(*scratch)[1] = reinterpret_cast<int(*)[1]>(hist + NW * ROW);
  unsigned* mine = hist + w * ROW;

  const uint8_t* row = data + (size_t)b * N;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int n16 = N >> 4;
    for (int i = t; i < n16; i += T)
      reinterpret_cast<uint4*>(bytes)[i] = reinterpret_cast<const uint4*>(row)[i];
    for (int i = (n16 << 4) + t; i < N; i += T) bytes[i] = row[i];
  } else {
    for (int i = t; i < N; i += T) bytes[i] = row[i];
  }
  for (int i = N + t; i < align16(N + PAD); i += T) bytes[i] = 0;
  for (int i = t; i < NW * ROW; i += T) hist[i] = 0;
  __syncthreads();

  const int first = w * 32 * R;  // this warp's items: first .. first + 32 R - 1
  const int rounds = first < N ? min(R, (N - first + 31) / 32) : 0;

  // pass 1, counts of the low byte in the warp's row
  for (int p = first + lane; p < min(first + 32 * rounds, N); p += 32)
    atomicAdd(&mine[hash_at(W, p) & 255u], 1u);
  __syncthreads();
  {  // offsets: exclusive sums in digit-major order, 8 entries a thread
    // (NW * 256 = 8T entries)
    int c[8], s[1] = {0}, total[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = 8 * t + i, x = (int)hist[(e % NW) * ROW + e / NW];
      c[i] = s[0];
      s[0] += x;
    }
    block_exclusive_scan<1>(s, total, scratch);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = 8 * t + i;
      hist[(e % NW) * ROW + e / NW] = (unsigned)(s[0] + c[i]);
    }
  }
  __syncthreads();
  FM_STOP(1)
  // pass 1, scatter: offset + rank among the round's lower peers
  for (int r = 0; r < rounds; ++r) {
    const int p = first + r * 32 + lane;
    const bool v = p < N;
    const unsigned key = hash_at(W, p) & 255u;
    const unsigned peers = peers_of(key, v, first + r * 32 + 32 <= N);
    const unsigned base = v ? mine[key] : 0u;
    if (v) order[base + __popc(peers & lt)] = (Pos)p;
    __syncwarp();
    if (v && lane == 31 - __clz(peers)) mine[key] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  FM_STOP(2)
  for (int i = t; i < NW * ROW; i += T) hist[i] = 0;
  __syncthreads();

  // pass 2, each warp's last item a high byte: the largest (j + 1) << 8 |
  // low byte
  for (int j = first + lane; j < min(first + 32 * rounds, N); j += 32) {
    const unsigned h = hash_at(W, order[j]);
    atomicMax(&mine[h >> 8], (unsigned)(j + 1) << 8 | (h & 255u));
  }
  __syncthreads();
  // carried forward: a warp's row becomes the last item (low byte << 24 |
  // position) of earlier warps
  for (int d = t; d < DIGITS; d += T) {
    unsigned carry = NONE;
    for (int k = 0; k < NW; ++k) {
      const unsigned x = hist[k * ROW + d];
      hist[k * ROW + d] = carry;
      if (x) carry = (x & 255u) << 24 | (unsigned)order[(x >> 8) - 1];
    }
  }
  __syncthreads();
  FM_STOP(3)
  // pass 2, prev: the predecessor with the same high byte is a lower peer
  // of the round, else the row's last; the same hash when the low bytes
  // agree
  for (int r = 0; r < rounds; ++r) {
    const int j = first + r * 32 + lane;
    const bool v = j < N;
    const unsigned pos = v ? (unsigned)order[j] : 0u;
    const unsigned h = hash_at(W, pos);
    const unsigned key = h >> 8;
    const unsigned peers = peers_of(key, v, first + r * 32 + 32 <= N);
    const unsigned lower = peers & lt;
    const unsigned item = (h & 255u) << 24 | pos;
    const unsigned up = __shfl_sync(0xffffffffu, item, lower ? 31 - __clz(lower) : lane);
    const unsigned pred = lower ? up : (v ? mine[key] : NONE);
    __syncwarp();
    if (v) {
      if (lane == 31 - __clz(peers)) mine[key] = item;
      prev[pos] = (pred != NONE && (pred >> 24) == (h & 255u)) ? (Pos)(pred & 0xFFFFFFu) : (Pos)none;
    }
    __syncwarp();
  }
  __syncthreads();
  FM_STOP(4)

  // lengths, in position order; the limit max(n_valid - p, 0) wraps in
  // 32 bits as JAX's int32 subtraction does
  const unsigned nv = (unsigned)n_valid[b];
  int* dout = delta + (size_t)b * N * C;
  int* lout = mlen + (size_t)b * N * C;
  for (int p0 = w * 32; p0 < N; p0 += T) {
    const int p = p0 + lane;
    const bool v = p < N;
    const int lim = max((int)(nv - (unsigned)p), 0);
    unsigned q = v ? (unsigned)prev[p] : none;
    if constexpr (CC > 0) {
      unsigned Q[CC];  // the chain, none past the first out of reach
      int D[CC], L[CC];
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        Q[k] = none;
        D[k] = 0;
        if (q != none && p - (int)q <= reach) {
          Q[k] = q;
          D[k] = p - (int)q;
          q = k + 1 < CC ? (unsigned)prev[q] : none;
        } else {
          q = none;
        }
      }
#ifdef NLZM_FM_NO_COMPARE
#pragma unroll
      for (int k = 0; k < CC; ++k) L[k] = Q[k] != none ? lim : 0;
#else
      const unsigned longer = short_prefixes<CC>(W, p, Q, none, L);
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        long_prefix(W, p0, (longer >> k) & 1u, D[k], L[k]);
        L[k] = min(L[k], lim);
      }
#endif
      store_tile<CC>(dout, D, p0, N);
      store_tile<CC>(lout, L, p0, N);
    } else {  // any C: a candidate at a time, stored where it is
      for (int k = 0; k < C; ++k) {
        unsigned Q[1] = {none};
        int D = 0, L[1];
        if (q != none && p - (int)q <= reach) {
          Q[0] = q;
          D = p - (int)q;
          q = (unsigned)prev[q];
        } else {
          q = none;
        }
        const unsigned longer = short_prefixes<1>(W, p, Q, none, L);
        long_prefix(W, p0, longer & 1u, D, L[0]);
        if (v) {
          dout[(size_t)p * C + k] = D;
          lout[(size_t)p * C + k] = min(L[0], lim);
        }
      }
    }
  }
}

using Kernel = void (*)(const uint8_t*, const int*, int*, int*, unsigned*, int, int, int);

template <typename Pos, bool SMEM>
Kernel kernel_for_c(int C) {
  switch (C) {
    case 1: return find_matches_kernel<Pos, SMEM, 1>;
    case 2: return find_matches_kernel<Pos, SMEM, 2>;
    case 3: return find_matches_kernel<Pos, SMEM, 3>;
    case 4: return find_matches_kernel<Pos, SMEM, 4>;
    default: return find_matches_kernel<Pos, SMEM, 0>;
  }
}

Kernel kernel_for(int N, int C) {
  return N <= SMEM_MAX_N ? kernel_for_c<uint16_t, true>(C) : kernel_for_c<unsigned, false>(C);
}

}  // namespace

// data [B, N] u8 (zero padded past n_valid); n_valid [B] i32; delta and
// mlen [B, N, C] i32 out; gpos: u32 [B, 2, N] scratch when N > 32768, else
// unused (may be null). M is unused (the parent's sort width). N <=
// 131072, C >= 1; reach is the wrapper's, clamped to [0, N].
NLZM_API int nlzm_find_matches(const void* data, const void* n_valid, void* delta, void* mlen,
                               void* gpos, int B, int N, int M, int reach, int C, int device,
                               void* stream) {
  (void)M;
  cudaSetDevice(device);
  if (B == 0 || N == 0) return 0;
  if (N > MAX_N || C < 1) return (int)cudaErrorInvalidValue;
  const int T = threads_for(B, N), bytes = smem_bytes(N, T);
  const Kernel kern = kernel_for(N, C);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, T, bytes, (cudaStream_t)stream>>>((const uint8_t*)data, (const int*)n_valid,
                                               (int*)delta, (int*)mlen, (unsigned*)gpos, N,
                                               reach, C);
  return launch_status();
}

// The launch for B blocks of N bytes, C candidates, on this card: out[0..4]
// = threads a CTA, dynamic shared bytes, registers a thread
// (cudaFuncGetAttributes), resident CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs.
NLZM_API int nlzm_fm_shape(void* out, int B, int N, int C, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  if (N < 1 || N > MAX_N || C < 1) return (int)cudaErrorInvalidValue;
  const int T = threads_for(B, N), bytes = smem_bytes(N, T);
  const Kernel kern = kernel_for(N, C);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, kern)) != cudaSuccess) return (int)e;
  int ctas = 0, sms = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, T, bytes)) != cudaSuccess)
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)e;
  int* o = (int*)out;
  o[0] = T;
  o[1] = bytes;
  o[2] = a.numRegs;
  o[3] = ctas;
  o[4] = sms;
  return 0;
}
