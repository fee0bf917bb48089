// LZ expansion of command arrays into bytes by pointer doubling.
//
// Replaces nlzm_tpu/ops/expand_ops.py::lz_expand_parallel (with
// _parent_fill_sorted[_dict], _byte_fill_sorted, _byte_fill_dict,
// _sparse_fill[2]). The TPU version builds every position's parent and
// final byte with merged sorts and cummax fills, in a 15/16-bit packed
// form up to 32 KiB blocks (D + N <= 65536) and a 2-operand form above,
// because it has no per-lane gather or scatter. Here both are plain
// indexed loads and stores.
//
// Bound: the dependent loads of the doubling rounds (parent[parent[i]]),
// a few rounds over N words a block. Design: one CTA of NT threads a
// block (lz_expand_kernel), after a transpose of the commands.
// - lz_expand_transpose_kernel copies the [T, B] commands into [B, TP]
//   (op_len, op_val) pairs when there are more than DIRECT_B blocks or one
//   tile of slots: a block's commands, strided by B, would cost its CTA a
//   32-byte sector a value. The rows entry (nlzm_lz_expand_rows) takes
//   such pairs from the caller (csrc/assemble.cu writes them) and reads
//   them in place, with no transpose.
// - Commands: each thread loads CPT consecutive slots at once (a tile of
//   NT x CPT), one block scan of their lengths (int64: a start past 2^31
//   is never taken for one in the block) gives each its start, and the
//   block's produced count wraps to int32 as JAX's cumsum does. A command
//   of length > 0 that starts in [0, N) marks its start in a bit mask and
//   leaves its delta at delta_at[start]; a literal also its byte at
//   lit[start] and a bit in the literal mask. Bits are gathered per mask
//   word in registers before one atomicOr.
// - Parents per position, a warp a mask word at a time, a lane a
//   position: the covering command's start m is the latest start bit at
//   or below the lane, else the carry (a block max-scan of each warp's
//   latest start), and the parent m - d + ((i - m) mod d) (the remainder
//   from a float quotient and one fixup), shifted by the dictionary
//   length D and clamped to [0, D + N - 1]. Positions past the block's
//   produced count (int64) root at themselves. No thread fills a
//   command's range: a 32 KiB run costs what 32 KiB of short matches cost.
// - Doubling, parent <- parent o parent through parents >= D only
//   (dictionary parents are terminal): at most min(rounds_hint, log2 N)
//   rounds, or log2 N without a hint, and never a round after one that
//   changed nothing (__syncthreads_or). Two ping-pong buffers, so every
//   round is the synchronous composition of the JAX decoder and of the
//   plain version, and the kernel agrees with them even for a hint that
//   is too small.
// - Bytes: a thread takes 16 consecutive positions and writes them with
//   one 16-byte store: dict[parent] or lit[parent - D] (one table on the
//   packed path), zero at i >= produced. On JAX's packed path with a
//   dictionary the parent is capped at D + N - 2, and position N - 1
//   rooted at itself takes the literal at N - 1 or 0 (that path's pad-key
//   corner patch). A parent that is neither in the dictionary nor a
//   literal (a hint below the chain depth) takes what the JAX fills give
//   it: the byte of the latest literal at or before it, or, with none, 0
//   (the last dictionary byte on the packed path with a dictionary). Only
//   a block that has one (__syncthreads_or) rewrites lit in place with
//   those bytes (a max-scan of the literal mask) and writes its bytes
//   again.
// On JAX's packed path (PACKED) the parents are u16 and live with the
// dictionary, the literal bytes and both masks in shared memory (5 N + D
// + N / 4 bytes: 200 KB at N = D = 32768); above it parents and literals
// are [B, N] global scratch and the masks stay in shared memory up to
// MASK_SMEM bytes.
//
// JAX's packed path packs a command's start and delta, or a literal's
// position and byte, into one u32 word and does not mask them: a delta
// outside 0..2^15 - 1 (2^16 - 1 with a dictionary), a literal's op_val
// outside 0..2^15 - 1, or a start whose shifted word wraps changes what
// its sorts give. The command pass flags such a block, and its CTA then
// runs JAX's sorts word for word instead (packed_block: CTA bitonic sorts
// of L words in the block's global slot, the parents in shared memory).
// No other block waits for it.
#include "common.cuh"

#ifndef NLZM_LZ_STOP
#define NLZM_LZ_STOP 0  // 1, 2, 3: end after the commands, the parents, the rounds (timing only)
#endif
#ifndef NLZM_LZ_EMULATE_ALL
#define NLZM_LZ_EMULATE_ALL 0  // 1: every block on JAX's packed path takes packed_block (testing)
#endif

namespace {

constexpr int NT = 1024;
constexpr int CPT = 8;                  // command slots a thread a tile (even)
constexpr int TILE = NT * CPT;          // command slots a tile
constexpr int DIRECT_B = 8;             // blocks up to which one tile of [T, B] is read as it is
constexpr int STILE = 16384;            // the packed emulation's sort tile, u32 words at most
constexpr int MASK_SMEM = 160 * 1024;   // masks in shared memory up to this size
constexpr unsigned PAD = 0xFFFFFFFFu;   // the packed sorts' pad key

// PACKED shared memory: parents (2 x 2 NP), the dictionary (D) and right
// after it the literals (NP), so that a parent q indexes both; then the
// masks (8 W), 16-byte aligned
__host__ __device__ inline size_t mask_offset(int W, int D) {
  return (160 * (size_t)W + D + 15) & ~(size_t)15;
}

__device__ __forceinline__ int len_of(int ol) { return ol < 0 ? 0 : (ol == 0 ? 1 : ol); }

__device__ __forceinline__ bool is_lit(const unsigned* mask, int j) {
  return (mask[j >> 5] >> (j & 31)) & 1u;
}

// Block-wide exclusive scan of one value a thread under op (identity id);
// *total the op over the block. scratch: 32 values of shared memory.
template <typename V, typename Op>
__device__ __forceinline__ V block_exclusive(V x, V id, Op op, V* scratch, V* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  V inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = op(y, inc);
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    V s = lane < nw ? scratch[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = op(y, s);
    }
    if (lane < nw) scratch[lane] = s;
  }
  __syncthreads();
  V ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = id;
  const V res = warp ? op(scratch[warp - 1], ex) : ex;
  *total = scratch[nw - 1];
  __syncthreads();  // scratch is free for the next call
  return res;
}

struct Add {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};
struct Max {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a > b ? a : b; }
};

// [T, B] op_len, op_val -> cmds [B, TP] (op_len, op_val), 32 x 32 tiles.
__global__ void __launch_bounds__(256)
    lz_expand_transpose_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                               int T, int B, int TP, int2* __restrict__ cmds) {
  __shared__ int2 tile[32][33];
  const int k0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, b = b0 + tx;
    if (k < T && b < B) {
      const long long at = (long long)k * B + b;
      tile[r][tx] = make_int2(op_len[at], op_val[at]);
    }
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int b = b0 + r, k = k0 + tx;
    if (k < T && b < B) cmds[(long long)b * TP + k] = tile[tx][r];
  }
}

// Parents: u16 in shared memory (PACKED) or i32 in global memory.
template <bool PACKED>
struct Par;
template <>
struct Par<true> {
  unsigned short* p;
  __device__ int get(int i) const { return p[i]; }
  __device__ void set(int i, int v) const { p[i] = (unsigned short)v; }
};
template <>
struct Par<false> {
  int* p;
  __device__ int get(int i) const { return p[i]; }
  __device__ void set(int i, int v) const { p[i] = v; }
};

// The doubling rounds on cur / nxt; returns whichever holds the result.
template <bool PACKED>
__device__ Par<PACKED> doubling(Par<PACKED> cur, Par<PACKED> nxt, int N, int NP, int D,
                                int rounds, int max_rounds) {
  const int bound = rounds < 0 ? max_rounds : min(rounds, max_rounds);
  for (int rd = 0; rd < bound; ++rd) {
    unsigned changed = 0;
    if constexpr (PACKED) {
      const unsigned* c32 = (const unsigned*)cur.p;
      unsigned* n32 = (unsigned*)nxt.p;
#pragma unroll 4
      for (int k = threadIdx.x; k < NP / 2; k += NT) {
        const unsigned v = c32[k];
        const int p0 = v & 0xFFFF, p1 = v >> 16;
        const int q0 = p0 >= D ? cur.p[p0 - D] : p0;
        const int q1 = p1 >= D ? cur.p[p1 - D] : p1;
        const unsigned u = (unsigned)q0 | ((unsigned)q1 << 16);
        n32[k] = u;
        changed |= u ^ v;
      }
    } else {
#pragma unroll 8
      for (int i = threadIdx.x; i < N; i += NT) {
        const int p = cur.p[i];
        const int q = p >= D ? cur.p[p - D] : p;
        nxt.p[i] = q;
        changed |= (unsigned)(q ^ p);
      }
    }
    const Par<PACKED> tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (!__syncthreads_or(changed != 0)) break;
  }
  return cur;
}

// --- JAX's packed path, word for word, for a flagged block ---

// Ascending bitonic sort of a[0, L) (L a power of two, in global memory):
// the stages of stride below the tile (TL words, a power of two) in shared
// memory, the others in place.
__device__ void bitonic_sort(unsigned* a, int L, unsigned* tile, int TL) {
  TL = min(TL, L);
  auto stage = [&](unsigned* x, int n, int base, int k, int j) {
    for (int p = threadIdx.x; p < n / 2; p += NT) {
      const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1)), hi = lo + j;
      const bool up = ((base + lo) & k) == 0;
      const unsigned u = x[lo], v = x[hi];
      if ((u > v) == up) {
        x[lo] = v;
        x[hi] = u;
      }
    }
    __syncthreads();
  };
  auto tiles = [&](int k, int j_top) {
    for (int t0 = 0; t0 < L; t0 += TL) {
      for (int x = threadIdx.x; x < TL; x += NT) tile[x] = a[t0 + x];
      __syncthreads();
      for (int kk = j_top ? k : 2; kk <= k; kk <<= 1)
        for (int j = j_top ? j_top : kk >> 1; j > 0; j >>= 1) stage(tile, TL, t0, kk, j);
      for (int x = threadIdx.x; x < TL; x += NT) a[t0 + x] = tile[x];
      __syncthreads();
    }
  };
  tiles(TL, 0);
  for (int k = 2 * TL; k <= L; k <<= 1) {
    for (int j = k >> 1; j >= TL; j >>= 1) stage(a, L, 0, k, j);
    tiles(k, TL >> 1);
  }
}

// _sparse_fill's middle on sorted a[0, L): the query test, the cummax fill,
// post, and the route-back keys in place. kind 0: parents (post of
// _parent_fill_sorted[_dict], shifted by D); 1: bytes.
__device__ void fill_keys(unsigned* a, int L, int pb, int kind, int N, int D, unsigned* s32) {
  const unsigned pmask = (1u << pb) - 1;
  unsigned carry = 0;
  constexpr int E = 4;
  for (int x0 = 0; x0 < L; x0 += NT * E) {
    const int x = x0 + threadIdx.x * E;
    unsigned v[E], run = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = x + e < L ? a[x + e] : PAD;
      const bool q = ((v[e] >> pb) & 1u) && v[e] != PAD;
      run = max(run, q || v[e] == PAD ? 0u : v[e]);
    }
    unsigned tot;
    unsigned f = max(carry, block_exclusive<unsigned>(run, 0u, Max(), s32, &tot));
    carry = max(carry, tot);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned s = v[e];
      const bool q = ((s >> pb) & 1u) && s != PAD;
      if (!q && s != PAD) f = max(f, s);
      const int qpay = (int)(s & pmask);
      int res;
      if (kind == 0) {
        const int m = (int)(f >> (pb + 1)), d = (int)(f & pmask);
        int par = qpay;
        if (d != 0) {
          int rr = (qpay - m) % d;
          if (rr < 0) rr += d;
          par = m - d + rr;
        }
        res = min(max(par + D, 0), D + N - 1);
      } else {
        res = (int)(f & 0xFF);
      }
      if (x + e < L) a[x + e] = q ? ((s & pmask) << pb) | (unsigned)res : PAD;
    }
  }
  __syncthreads();
}

// JAX's packed-path expansion of block b (lz_expand_parallel with
// _parent_fill_sorted[_dict], the rounds, _byte_fill_sorted /
// _byte_fill_dict): the merged sorts of source and query words in A (L
// words), the parents u16 in cur / nxt, the sort tile in shared memory.
__device__ void packed_block(const int* __restrict__ op_len, const int* __restrict__ op_val,
                             const int2* crow, int T, int B, int b, int N,
                             const unsigned char* __restrict__ dict, int D, int rounds,
                             int max_rounds, unsigned* A, int L,
                             Par<true> cur, Par<true> nxt, int NP, unsigned* tile, int TL,
                             unsigned char* __restrict__ orow, int* __restrict__ produced,
                             unsigned* su) {
  const int t = threadIdx.x;
  // each command's word from its int32 start (JAX's cumsum), a tile of NT
  // commands a scan; word(k, start) -> the word at A[at(k)]. The commands
  // from [T, B] op_len / op_val, or (rows entry: op_len null) from the
  // caller's pairs crow, never from the slot A that the sorts write over
  auto commands = [&](auto&& put) {
    unsigned base = 0;
    for (int k0 = 0; k0 < T; k0 += NT) {
      const int k = k0 + t;
      int ol = -1, ov = 0;
      if (k < T && op_len) {
        ol = op_len[(long long)k * B + b];
        ov = op_val[(long long)k * B + b];
      } else if (k < T) {
        const int2 c = __ldcg(crow + k);
        ol = c.x;
        ov = c.y;
      }
      unsigned tot;
      const unsigned ex = block_exclusive<unsigned>((unsigned)len_of(ol), 0u, Add(), su, &tot);
      if (k < T) put(k, ol, ov, (int)(base + ex));
      base += tot;
    }
    return (int)base;
  };
  // _parent_fill_sorted[_dict]
  const int pb = D ? 16 : 15;
  const int prod = commands([&](int k, int ol, int ov, int s) {
    A[k] = len_of(ol) > 0 ? (((unsigned)s << 1) << pb) | (unsigned)(ol == 0 ? 0 : ov) : PAD;
  });
  for (int x = T + t; x < L; x += NT) {
    const unsigned i = x - T;
    A[x] = x < T + N ? (((i << 1) | 1u) << pb) | i : PAD;
  }
  __syncthreads();
  bitonic_sort(A, L, tile, TL);
  fill_keys(A, L, pb, 0, N, D, su);
  bitonic_sort(A, L, tile, TL);
  for (int i = t; i < NP; i += NT) cur.set(i, i < N ? (int)(A[i] & ((1u << pb) - 1)) : 0);
  __syncthreads();
  cur = doubling<true>(cur, nxt, N, NP, D, rounds, max_rounds);
  // _byte_fill_sorted / _byte_fill_dict: the dictionary's words, the
  // literals' at D + start (int32), the queries keyed by the parent
  // (capped at D + N - 2 with a dictionary); the corner patch takes the
  // op_val of the literals at N - 1, summed
  int corner = 0;
  commands([&](int k, int ol, int ov, int s) {
    A[D + k] = ol == 0 ? ((((unsigned)s + (unsigned)D) << 1) << 15) | (unsigned)ov : PAD;
    if (ol == 0 && s == N - 1) corner = (int)((unsigned)corner + (unsigned)ov);
  });
  for (int x = t; x < L; x += NT) {
    if (x < D) {
      A[x] = ((unsigned)x << 16) | dict[x];
    } else if (x >= D + T + N) {
      A[x] = PAD;
    } else if (x >= D + T) {
      const unsigned i = x - D - T;
      const unsigned key = D ? min(cur.get(i), D + N - 2) : cur.get(i);
      A[x] = (((key << 1) | 1u) << 15) | i;
    }
  }
  unsigned csum;
  block_exclusive<unsigned>((unsigned)corner, 0u, Add(), su, &csum);
  bitonic_sort(A, L, tile, TL);
  fill_keys(A, L, 15, 1, N, D, su);
  bitonic_sort(A, L, tile, TL);
  for (int i = t; i < N; i += NT) {
    unsigned v = A[i] & 0x7FFF;
    if (D && i == N - 1 && cur.get(N - 1) == D + N - 1) v = csum;
    orow[i] = i < prod ? (unsigned char)v : 0;
  }
  if (t == 0) produced[b] = prod;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// mod x by d for 0 <= x and d >= 1: the float quotient, one fixup
__device__ __forceinline__ int mod_pos(int x, int d) {
  if (x < d) return x;
  if (x >= 1 << 22) return x % d;
  const int q = (int)__fdividef((float)x, (float)d);
  int r = x - q * d;
  if (r < 0)
    r += d;
  else if (r >= d)
    r -= d;
  return r;
}

// cmds: [B, TP] (op_len, op_val) pairs from lz_expand_transpose_kernel
// or the caller's (rows entry: op_len / op_val null), or null to read
// op_len / op_val [T, B] as they are (one tile at most, of a few blocks).
// PACKED: slots [B, L] u32, the packed emulation's sorts, each block's
// first 2 TP words its transposed commands (so neither pointer is
// __restrict__, and the commands are loaded past L1: packed_block writes
// over them); not PACKED: gpar [2, B, N] i32, glit [B, N] u8, gmask [B, 2
// W] u32 when the masks do not fit shared memory.
template <bool PACKED>
__global__ void __launch_bounds__(NT, 1)
    lz_expand_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                     const int2* cmds, int T, int TP, int B, int N,
                     const unsigned char* __restrict__ dict, int D, int rounds, int max_rounds,
                     unsigned* slots, int L, int* __restrict__ gpar,
                     unsigned char* __restrict__ glit, unsigned* __restrict__ gmask,
                     int masks_in_smem, unsigned char* __restrict__ out,
                     int* __restrict__ produced) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s64[32];
  __shared__ int s32[32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = (N + 31) >> 5, NP = W * 32;
  const int top = D + N - 1;

  Par<PACKED> cur, nxt;
  unsigned char* lit;
  const unsigned char* dsm = dict;  // the dictionary bytes the byte pass reads
  size_t off = 0;
  if constexpr (PACKED) {
    cur.p = (unsigned short*)smem;
    nxt.p = cur.p + NP;
    unsigned char* ds = (unsigned char*)(nxt.p + NP);
    lit = ds + D;
    dsm = ds;
    off = mask_offset(W, D);
    const bool vec = ((uintptr_t)dict & 15) == 0;
    const int d16 = vec ? D & ~15 : 0;
    for (int x = 16 * t; x < d16; x += 16 * NT) cp_async16(ds + x, dict + x);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int x = d16 + t; x < D; x += NT) ds[x] = dict[x];
  } else {
    cur.p = gpar + (long long)b * N;
    nxt.p = gpar + (long long)(B + b) * N;
    lit = glit + (long long)b * N;
  }
  unsigned* smask = masks_in_smem ? (unsigned*)(smem + off) : gmask + (long long)b * 2 * W;
  unsigned* lmask = smask + W;
  for (int w = t; w < 2 * W; w += NT) smask[w] = 0;
  __syncthreads();

  // commands: starts, marks, and (PACKED) the packing check
  const int2* crow = cmds + (long long)b * TP;
  long long base = 0;
  int bad = 0;
  for (int k0 = 0; k0 < T; k0 += TILE) {
    const int kt = k0 + t * CPT;
    int ol[CPT], ov[CPT];
    if (cmds) {
#pragma unroll
      for (int c = 0; c < CPT; c += 2) {
        const int4 v =
            kt + c < TP ? __ldcg((const int4*)(crow + kt + c)) : make_int4(-1, 0, -1, 0);
        ol[c] = kt + c < T ? v.x : -1;
        ov[c] = v.y;
        ol[c + 1] = kt + c + 1 < T ? v.z : -1;
        ov[c + 1] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const bool in = kt + c < T;
        ol[c] = in ? op_len[(long long)(kt + c) * B + b] : -1;
        ov[c] = in ? op_val[(long long)(kt + c) * B + b] : 0;
      }
    }
    long long sum = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) sum += len_of(ol[c]);
    long long tot;
    long long st = base + block_exclusive<long long>(sum, 0, Add(), s64, &tot);
    base += tot;
    int sw = -1, lw = -1;
    unsigned sbits = 0, lbits = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int len = len_of(ol[c]);
      if (len == 0) continue;
      const int d = ol[c] == 0 ? 0 : ov[c];
      if constexpr (PACKED) {
        const int s = (int)(unsigned)(unsigned long long)st;  // JAX's int32 start
        bad |= (unsigned)s >= (D ? 1u << 15 : 1u << 16) ||
               (unsigned)d >= (D ? 1u << 16 : 1u << 15);
        if (ol[c] == 0) bad |= (unsigned)ov[c] >= 1u << 15 || (long long)s + D >= 1 << 16;
      }
      if (st < N) {
        const int m = (int)st;
        if ((m >> 5) != sw) {
          if (sbits) atomicOr(&smask[sw], sbits);
          sw = m >> 5;
          sbits = 0;
        }
        sbits |= 1u << (m & 31);
        nxt.set(m, d);  // delta_at, until the parents are built
        if (ol[c] == 0) {
          lit[m] = (unsigned char)ov[c];
          if ((m >> 5) != lw) {
            if (lbits) atomicOr(&lmask[lw], lbits);
            lw = m >> 5;
            lbits = 0;
          }
          lbits |= 1u << (m & 31);
        }
      }
      st += len;
    }
    if (sbits) atomicOr(&smask[sw], sbits);
    if (lbits) atomicOr(&lmask[lw], lbits);
  }
  unsigned char* orow = out + (long long)b * N;
  if constexpr (PACKED) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (__syncthreads_or(bad | NLZM_LZ_EMULATE_ALL)) {
      // the dictionary copy is in; its room and the literals' are the sort tile's
      const size_t room = mask_offset(W, D) + 8 * (size_t)W - 4 * (size_t)NP;
      int TL = 1;
      while (TL < STILE && (size_t)TL * 8 <= room) TL <<= 1;
      packed_block(op_len, op_val, crow, T, B, b, N, dict, D, rounds, max_rounds,
                   slots + (long long)b * L, L, cur, nxt, NP, (unsigned*)(nxt.p + NP), TL,
                   orow, produced, (unsigned*)s32);
      return;
    }
  } else {
    __syncthreads();
  }
  const long long total = base;
  const int prod = (int)(unsigned)(unsigned long long)total;
  if (t == 0) produced[b] = prod;
  if (NLZM_LZ_STOP == 1) return;

  // parents, 32 positions (a mask word) a warp at a time, a lane each: the
  // covering command's start m is the lane's latest start bit in the
  // word, else the carry (from a block max-scan of each warp's latest)
  const int NW = NT / 32, WPW = (W + NW - 1) / NW;
  const int wa = min(warp * WPW, W), wb = min(wa + WPW, W);
  int last = -1;
  for (int w = wa + lane; w < wb; w += 32) {
    const unsigned bits = smask[w];
    if (bits) last = w * 32 + 31 - __clz(bits);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  int carry, unused;
  carry = block_exclusive<int>(lane == 0 ? last : -1, -1, Max(), s32, &unused);
  carry = __shfl_sync(0xffffffffu, carry, 0);
#pragma unroll 4
  for (int w = wa; w < wb; ++w) {
    const unsigned bits = smask[w];
    const int i = w * 32 + lane;
    const unsigned below = bits & (0xffffffffu >> (31 - lane));
    const int m = below ? w * 32 + 31 - __clz(below) : carry;
    const int d = m >= 0 ? nxt.get(m) : 0;
    int v = i + D;  // m - d + r >= -2^31 + 1 for d > 0; m - d overflows for d < 0
    if (m >= 0 && i < total && d > 0) v = max(m - d + mod_pos(i - m, d), -D) + D;
    if (m >= 0 && i < total && d < 0) v = (int)min((long long)m - d + D, (long long)top);
    v = min(max(v, 0), top);
    if (i >= N) v = 0;  // padding: terminal or its own parent, never changes
    if (PACKED || i < N) cur.set(i, v);
    if (bits) carry = w * 32 + 31 - __clz(bits);
  }
  __syncthreads();
  if (NLZM_LZ_STOP == 2) return;

  cur = doubling<PACKED>(cur, nxt, N, NP, D, rounds, max_rounds);
  if (NLZM_LZ_STOP == 3) return;

  // bytes, 16 positions a thread at a time; filled: lit holds, at every
  // position, the byte of the latest literal at or before it
  const bool sort_dict = PACKED && D > 0;
  const bool vec = (N & 15) == 0;
  auto bytes = [&](bool filled) {
    int unresolved = 0;
    for (int c = t; c * 16 < N; c += NT) {
      const int i0 = c * 16;
      int pv[16];
      if constexpr (PACKED) {
        const uint4* src = (const uint4*)(cur.p + i0);
        const uint4 a = src[0], e = src[1];
        const unsigned u[8] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pv[2 * j] = u[j] & 0xFFFF;
          pv[2 * j + 1] = u[j] >> 16;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) pv[j] = i0 + j < N ? cur.p[i0 + j] : 0;
      }
      unsigned wv[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = i0 + j, p = pv[j];
        int byte = 0;
        if (i < prod && i < N) {
          const int q = sort_dict ? min(p, top - 1) : p;
          if (sort_dict && i == N - 1 && p == top) {
            byte = is_lit(lmask, N - 1) ? lit[N - 1] : 0;
          } else if (PACKED && (filled || q < D || is_lit(lmask, q - D))) {
            byte = dsm[q];  // the dictionary, then the literals
          } else if (!PACKED && q < D) {
            byte = dsm[q];
          } else if (!PACKED && (filled || is_lit(lmask, q - D))) {
            byte = lit[q - D];
          } else {
            unresolved = 1;
          }
        }
        wv[j >> 2] |= (unsigned)byte << (8 * (j & 3));
      }
      if (vec) {
        *(uint4*)(orow + i0) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      } else {
        for (int j = 0; j < 16 && i0 + j < N; ++j)
          orow[i0 + j] = (unsigned char)(wv[j >> 2] >> (8 * (j & 3)));
      }
    }
    return unresolved;
  };
  if (!__syncthreads_or(bytes(false))) return;

  // lit[j] <- the byte of the latest literal at or before j, or none: a
  // thread a run of mask words, its carry from a block max-scan
  const int none = sort_dict ? dict[D - 1] : 0;
  const int WPT = (W + NT - 1) / NT;
  const int w0 = min(t * WPT, W), w1 = min(w0 + WPT, W);
  last = -1;
  for (int w = w1 - 1; w >= w0 && last < 0; --w) {
    const unsigned bits = lmask[w];
    if (bits) last = w * 32 + 31 - __clz(bits);
  }
  int l = block_exclusive<int>(last, -1, Max(), s32, &unused);
  for (int w = w0; w < w1; ++w) {
    const unsigned bits = lmask[w];
    for (int j = 0; j < 32; ++j) {
      const int i = w * 32 + j;
      if (i >= N) break;
      if ((bits >> j) & 1u)
        l = i;
      else
        lit[i] = l >= 0 ? lit[l] : (unsigned char)none;
    }
  }
  __syncthreads();
  bytes(true);
}

struct Layout {
  bool packed, masks_in_smem, transpose;
  int W, TP, L;
  long long words;  // int32 scratch words
  size_t smem;
};

// The launch's layout: scratch words (int32) and dynamic shared bytes.
// The commands transposed ([B, TP] pairs, TP = T rounded up to even) past
// DIRECT_B blocks, unless they come as pairs (rows). PACKED: a slot of L
// words a block (its transposed commands, then the packed emulation's
// sorts), L the power of two at or above max(D + T + N, 2 TP); else the
// transposed commands, two parent rows and the literal bytes a block, and
// the masks past MASK_SMEM.
Layout layout_of(int T, int B, int N, int D, bool rows) {
  Layout y = {};
  y.packed = N <= 32768 && D + N <= 65536;  // nlzm_tpu's packed-sort path (ops/expand_ops.py:255)
  y.transpose = !rows && T > 0 && (B > DIRECT_B || T > TILE);
  y.W = (N + 31) / 32;
  y.TP = y.transpose ? (T + 1) & ~1 : 0;
  const size_t mask_bytes = 8 * (size_t)y.W;
  if (y.packed) {
    const long long need = (long long)D + T + N > 2LL * y.TP ? (long long)D + T + N : 2LL * y.TP;
    long long l = 2;
    while (l < need) l <<= 1;
    y.L = (int)l;
    y.words = (long long)B * y.L;
    y.masks_in_smem = true;
    y.smem = mask_offset(y.W, D) + mask_bytes;
  } else {
    y.masks_in_smem = mask_bytes <= MASK_SMEM;
    y.words = 2LL * B * y.TP + 2LL * B * N + ((long long)B * N + 3) / 4 +
              (y.masks_in_smem ? 0 : 2LL * B * y.W);
    y.smem = y.masks_in_smem ? mask_bytes : 0;
  }
  return y;
}

// the dynamic shared-memory limit of a kernel, raised once a device to at
// least `bytes`
cudaError_t smem_setup(const void* fn, int slot, size_t bytes, int device) {
  static size_t done[2][64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || done[slot][device] >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done[slot][device] = bytes;
  return e;
}

// The launch of both entries: op_len / op_val [T, B] (transposed into the
// scratch past DIRECT_B blocks or one tile) or, when rows is given, the
// caller's [B, TP] pairs, read in place.
int run(const int* ol, const int* ov, const int2* rows, int TP, const unsigned char* dt,
        int* sc, unsigned char* out, int* produced, int T, int B, int N, int D, int rounds,
        int max_rounds, int device, cudaStream_t s) {
  const Layout y = layout_of(T, B, N, D, rows != nullptr);
  int2* cmds = rows ? const_cast<int2*>(rows) : (y.transpose ? (int2*)sc : nullptr);
  // PACKED and transposed: block b's commands at the start of its slot (a
  // row of L / 2 pairs)
  if (!rows) TP = y.packed ? y.L / 2 : y.TP;
  const void* fn = y.packed ? (const void*)lz_expand_kernel<true>
                            : (const void*)lz_expand_kernel<false>;
  const cudaError_t e = smem_setup(fn, y.packed ? 0 : 1, y.smem, device);
  if (e != cudaSuccess) return (int)e;
  if (y.transpose) {
    lz_expand_transpose_kernel<<<dim3((T + 31) / 32, (B + 31) / 32), 256, 0, s>>>(ol, ov, T, B,
                                                                                  TP, cmds);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return (int)e2;
  }
  if (y.packed) {
    lz_expand_kernel<true><<<B, NT, y.smem, s>>>(ol, ov, cmds, T, TP, B, N, dt, D, rounds,
                                                 max_rounds, (unsigned*)sc, y.L, nullptr,
                                                 nullptr, nullptr, 1, out, produced);
  } else {
    int* gpar = sc + 2LL * B * y.TP;
    unsigned char* glit = (unsigned char*)(gpar + 2LL * B * N);
    unsigned* gmask = (unsigned*)(gpar + 2LL * B * N + ((long long)B * N + 3) / 4);
    lz_expand_kernel<false><<<B, NT, y.smem, s>>>(ol, ov, cmds, T, TP, B, N, dt, D, rounds,
                                                  max_rounds, nullptr, 0, gpar, glit, gmask,
                                                  y.masks_in_smem, out, produced);
  }
  return launch_status();
}

}  // namespace

// Scratch int32 words a call takes at this shape (the wrapper allocates
// them): *out (host long long); rows: 1 for nlzm_lz_expand_rows.
NLZM_API int nlzm_lz_expand_scratch(void* out, int T, int B, int N, int D, int rows, int device,
                                    void* stream) {
  (void)device;
  (void)stream;
  *(long long*)out = layout_of(T, B, N, D, rows != 0).words;
  return 0;
}

// op_len/op_val [T, B] i32; dict [D] u8 (null when D = 0); rounds < 0:
// until no change, else min(rounds, max_rounds); scratch: int32 words as
// nlzm_lz_expand_scratch; out [B, N] u8; produced [B] i32.
NLZM_API int nlzm_lz_expand(const void* op_len, const void* op_val, const void* dict,
                            void* scratch, void* out, void* produced, int T, int B, int N, int D,
                            int rounds, int max_rounds, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (N < 1 || D < 0 || T < 0) return (int)cudaErrorInvalidValue;
  return run((const int*)op_len, (const int*)op_val, nullptr, 0, (const unsigned char*)dict,
             (int*)scratch, (unsigned char*)out, (int*)produced, T, B, N, D, rounds, max_rounds,
             device, (cudaStream_t)stream);
}

// The same on cmds [B, TP] (op_len, op_val) i32 pairs, T <= TP, TP even,
// 16-byte aligned (csrc/assemble.cu's rows); scratch as
// nlzm_lz_expand_scratch with rows 1.
NLZM_API int nlzm_lz_expand_rows(const void* cmds, const void* dict, void* scratch, void* out,
                                 void* produced, int T, int TP, int B, int N, int D, int rounds,
                                 int max_rounds, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (N < 1 || D < 0 || T < 0 || TP < T || (TP & 1) || ((uintptr_t)cmds & 15))
    return (int)cudaErrorInvalidValue;
  return run(nullptr, nullptr, (const int2*)cmds, TP, (const unsigned char*)dict, (int*)scratch,
             (unsigned char*)out, (int*)produced, T, B, N, D, rounds, max_rounds, device,
             (cudaStream_t)stream);
}

// The launch at this shape on this device, for reports: out[0..8] (host
// ints) = threads, dynamic shared bytes, registers a thread, resident CTAs
// an SM, SMs, 1 on JAX's packed path, 1 with the masks in shared memory,
// 1 with the commands transposed first, the packed emulation's slot words.
NLZM_API int nlzm_lz_expand_shape(void* out, int T, int B, int N, int D, int rows, int device,
                                  void* stream) {
  (void)stream;
  cudaSetDevice(device);
  const Layout y = layout_of(T, B, N, D, rows != 0);
  const void* fn = y.packed ? (const void*)lz_expand_kernel<true>
                            : (const void*)lz_expand_kernel<false>;
  cudaError_t e = smem_setup(fn, y.packed ? 0 : 1, y.smem, device);
  cudaFuncAttributes attr = {};
  int ctas = 0, sms = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, y.smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[9] = {NT, (int)y.smem, attr.numRegs, ctas, sms, y.packed ? 1 : 0,
                    y.masks_in_smem ? 1 : 0, y.transpose ? 1 : 0, y.L};
  for (int i = 0; i < 9; ++i) ((int*)out)[i] = v[i];
  return 0;
}
