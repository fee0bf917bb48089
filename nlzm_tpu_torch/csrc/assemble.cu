// Command assembly: plane symbols -> LZ commands, [B, TP] (op_len, op_val)
// pairs, the rows lz_expand's command pass reads.
//
// Replaces nlzm_tpu/ops/wide_decode.py::assemble_ops (with _bits_fetch).
// The TPU version routes symbols to commands with gather-via-sort
// (ops/sort_gather.py) because it has no per-lane gather; here every
// route is one indexed load.
//
// Bound: three dependent steps a block and their instructions. A
// command's plane symbols sit at its exclusive rank among commands of its
// kind; the raw-bit offsets and escape ranks depend on symbols gathered at
// those ranks; a rep's distance is one of the four latest dict distances
// before it, which depend on the raw bits. Design: one CTA of NT threads a
// block, the block's Tc slots held at once in shared memory (chunks of CH
// = NT x SPT slots, SPT slots a thread in a run of consecutive slots, at
// most 16; one chunk up to 14,336 slots, so one at the shipping shape), no
// device-memory scratch:
// - the chunk's tok row lands in shared memory by cp.async (4 bytes a
//   slot, coalesced), beside the block's raw-bit halfwords (16-byte
//   cp.async, staged once);
// - scan 1 (match, dict, literal counts of each run) gives each run its
//   ranks, and each run writes, at each rank, its slot: MAP for matches
//   and literals, DR for dicts. The chunk's len, literal and slot symbols
//   are contiguous runs of their planes, copied coalesced (cp.async)
//   straight into their slots through those maps;
// - scan 2 (escapes, raw-bit widths) gives each run its lex ranks and bit
//   offsets; its lex gathers are issued together, by cp.async into its
//   own slots, the raw-bit fields come from the row, and each dict's
//   distance is final;
// - after one barrier each rep reads its distance from the dict DR names
//   (or, before the chunk's first dicts, from the 4-entry window carried
//   from the chunk before: the virtual history 1, 2, 3, 4 at a block's
//   start);
// - each warp's 32 runs leave shared memory as 16-byte coalesced stores
//   of pairs as soon as the warp is done with them.
// Slots are swizzled in shared memory (groups of 4 ints XORed within each
// 32-int row): a run is read and written 4 slots at a time, and neither a
// run's walk nor the coalesced passes meet bank conflicts. A run is walked
// a group of 4 at a time (the group loops are not unrolled): 16 slots a
// thread then fit 72 registers without spills, so a CTA of 896 threads
// holds a shipping block (up to 14,336 slots) in one chunk; blocks of at
// most 1024 slots run 512 threads a CTA.
//
// JAX's packed path (block sizes <= 32 KiB, pb = 15, or 16 with a
// dictionary) compacts the dict distances with a sort of (rank << pb) |
// delta keys and does not mask delta: a delta outside 0..2^pb - 1 spills
// into the rank bits and moves entries of the compacted array that reps
// read. A block with such a delta flags itself and resolves its reps again
// from JAX's construction (flagged_block): its dict keys sorted in shared
// memory, merged with Tc - n_dict filler keys, masked to the payload, zero
// from the dict count on. No other block waits for it.
//
// Every gathered index is clamped (the JAX gathers clamp silently), and
// so is the distance-extra width (ab <= 16) as in the JAX decoder.
#include "common.cuh"

namespace {

constexpr int NT = 896;                // threads a CTA past SMALL slots
constexpr int NT_SMALL = 512;          // threads a CTA up to SMALL slots
constexpr int SMALL = 1024;
constexpr int CHMAX = 16384;           // command slots a chunk at most
constexpr int SMEM_MAX = 224 * 1024;   // the raw-bit row is staged while the total fits
constexpr int TOK_LIT = 0, TOK_DICT = 1, TOK_REP = 2;

struct Plane {
  const int* p;
  int width;   // columns in use
  int stride;  // row stride (elements)
};

struct Planes {
  Plane tok, len, lex, lit, slot;
};

__device__ __forceinline__ const int* at_ptr(const Plane& a, int b, int k) {
  return a.p + (long long)b * a.stride + clampi(k, 0, a.width - 1);
}

__device__ __forceinline__ int load_at(const Plane& a, int b, int k) {
  return __ldg(at_ptr(a, b, k));
}

// MSB-first field of `width` (<= 16) bits at bit offset `off`, from the
// block's big-endian halfwords (nlzm_tpu wide_decode._bits_fetch).
__device__ __forceinline__ int bits_fetch(const unsigned short* row, int hb, int off, int width) {
  if (width <= 0) return 0;
  const int h0 = off >> 4;
  const unsigned hw0 = row[clampi(h0, 0, hb - 1)];
  const unsigned hw1 = row[clampi(h0 + 1, 0, hb - 1)];
  const unsigned word = (hw0 << 16) | hw1;
  const unsigned w = (unsigned)min(width, 16);
  return (int)((word << (off & 15)) >> (32u - w));
}

__device__ __forceinline__ int mmin_of(int delta) {
  return 2 + (delta > 0xFF) + (delta > 0xFFF) + (delta > 0xFFFFF);
}

// int32 sums wrap, as the JAX arrays do
__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// distance-extra width of a dict slot symbol
__device__ __forceinline__ int ab_of(int slot) {
  return slot >= 4 ? clampi((slot >> 1) - 1, 0, 16) : 0;
}

__device__ __forceinline__ int dict_delta(int slot, int ab, int extra) {
  return (slot >= 4 ? ((2 + (slot & 1)) << ab) + extra : slot) + 1;
}

// w[q] for q in 0..3, in registers
__device__ __forceinline__ int pick4(const int (&w)[4], int q) {
  return q == 0 ? w[0] : (q == 1 ? w[1] : (q == 2 ? w[2] : w[3]));
}

// shared-memory index of chunk slot k: its group of 4 XORed by the row
__device__ __forceinline__ int swz(int k) { return k ^ ((k >> 3) & 28); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// V consecutive ints of a run (V = 1, 2 or 4), one shared-memory access
template <int V>
struct Vec {
  int v[V];
  __device__ __forceinline__ void load(const int* p) {
    if constexpr (V == 4) {
      const int4 a = *(const int4*)p;
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (V == 2) {
      const int2 a = *(const int2*)p;
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(int* p) const {
    if constexpr (V == 4) {
      *(int4*)p = make_int4(v[0], v[1], v[2], v[3]);
    } else if constexpr (V == 2) {
      *(int2*)p = make_int2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  }
};

// Exclusive sums of NV ints a thread in thread order (v becomes the
// prefix), totals in tot. Two barriers; sc is not read again before the
// caller's next barrier.
template <int NTH, int NV>
__device__ __forceinline__ void block_scan_ints(int (&v)[NV], int (&tot)[NV], int (*sc)[NV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = NTH / 32;
  int inc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) inc[j] = warp_inclusive_sum(v[j]);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < NV; ++j) sc[warp][j] = inc[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      int s = lane < nw ? sc[lane][j] : 0;
      s = warp_inclusive_sum(s);
      if (lane < nw) sc[lane][j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    tot[j] = sc[nw - 1][j];
    v[j] = (warp ? sc[warp - 1][j] : 0) + inc[j] - v[j];
  }
}

// --- a flagged block: JAX's packed compaction of the dict distances ---

constexpr int K_NONE = 0, K_LIT = 1, K_DICT = 2, K_REP = 3;

// an active slot's kind: a tok symbol outside 0..2 (3 of the alphabet of
// 4) is no command
__device__ __forceinline__ int kind_of(int tok) {
  return tok == TOK_LIT ? K_LIT : (tok == TOK_DICT ? K_DICT : (tok == TOK_REP ? K_REP : K_NONE));
}

// One slot at a time, NT slots a tile with carried scans (the first
// design's walk): visit(k, kind, lv, d_rank, v, slot) for every slot k <
// Tc, v the raw-bit field. Returns the block's dict count.
template <int NTH, typename Visit>
__device__ int walk_slots(const Planes& P, int b, int ncmd, const unsigned short* bits, int hb,
                          Visit&& visit) {
  __shared__ int w3[32][3];
  __shared__ int w2[32][2];
  const int Tc = P.tok.width;
  int m_base = 0, d_base = 0, l_base = 0, e_base = 0, w_base = 0;
  for (int k0 = 0; k0 < Tc; k0 += NTH) {
    const int k = k0 + threadIdx.x;
    const bool in = k < Tc;
    const int tok = in ? __ldg(P.tok.p + (long long)b * P.tok.stride + k) : -1;
    const bool active = in && k < ncmd;
    const int kind = active ? kind_of(tok) : K_NONE;
    int f3[3] = {kind >= K_DICT, kind == K_DICT, kind == K_LIT}, t3[3];
    block_exclusive_scan<3>(f3, t3, w3);
    const int m_rank = m_base + f3[0], d_rank = d_base + f3[1];
    m_base += t3[0];
    d_base += t3[1];
    l_base += t3[2];
    const int len_sym = kind >= K_DICT ? load_at(P.len, b, m_rank) : 0;
    const bool esc = kind >= K_DICT && len_sym == 7;
    const int slot = kind == K_DICT ? load_at(P.slot, b, d_rank) : 0;
    const int width = kind == K_REP ? 2 : (kind == K_DICT ? ab_of(slot) : 0);
    int f2[2] = {esc, width}, t2[2];
    block_exclusive_scan<2>(f2, t2, w2);
    const int lex_rank = e_base + f2[0], off = w_base + f2[1];
    e_base += t2[0];
    w_base += t2[1];
    const int lv = esc ? wadd(7, load_at(P.lex, b, lex_rank)) : len_sym;
    const int v = bits_fetch(bits, hb, off, width);
    if (in) visit(k, kind, lv, d_rank, v, slot);
  }
  return d_base;
}

// JAX's D for a block with a dict distance outside the payload, and its
// reps again. Keys: (d_rank << pb) | delta as JAX forms them (i32 for pb
// 15, u32 for 16), held as u32 in ascending order (an i32 key with its
// sign bit flipped); the filler key of the Tc - nd other slots is
// PACK_MAX << pb. S: at least the next power of two of nd words.
template <int NTH>
__device__ void flagged_block(const Planes& P, int b, int ncmd, const unsigned short* bits,
                              int hb, int pb, unsigned* S, int2* __restrict__ orow) {
  __shared__ int cnt_sc[32][1];
  const int t = threadIdx.x, Tc = P.tok.width;
  const unsigned flip = pb == 15 ? 0x80000000u : 0u;
  const unsigned fill = (1u << (15 + pb)) ^ flip;
  const unsigned mask = (1u << pb) - 1;
  const int nd = walk_slots<NTH>(P, b, ncmd, bits, hb, [&](int k, int kind, int, int d_rank,
                                                            int v, int slot) {
    if (kind == K_DICT) {
      const int delta = dict_delta(slot, ab_of(slot), v);
      S[d_rank] = (((unsigned)d_rank << pb) | (unsigned)delta) ^ flip;
    }
  });
  int L = 1;
  while (L < nd) L <<= 1;
  for (int i = nd + t; i < L; i += NTH) S[i] = 0xFFFFFFFFu;
  __syncthreads();
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < L; i += NTH) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned x = S[i], y = S[l];
          if ((x > y) == ((i & k) == 0)) {
            S[i] = y;
            S[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  int below[1] = {0}, n_lo[1];
  for (int i = t; i < nd; i += NTH) below[0] += S[i] < fill;
  block_scan_ints<NTH, 1>(below, n_lo, cnt_sc);
  const int fillers = Tc - nd;
  // sorted position i of the Tc keys, masked to the payload
  auto D = [&](int i) -> int {
    if (i < n_lo[0]) return (int)(S[i] & mask);
    if (i < n_lo[0] + fillers) return 0;
    return (int)(S[i - fillers] & mask);
  };
  walk_slots<NTH>(P, b, ncmd, bits, hb, [&](int k, int kind, int lv, int d_rank, int v, int) {
    if (kind == K_REP) {
      const int j = d_rank - 1 - v;
      const int delta = j >= 0 ? D(j) : -j;
      orow[k] = make_int2(wadd(lv, mmin_of(delta)), delta);
    }
  });
}

// --- the kernel ---

// bit_half [B, hb] u16; bits_smem: the row is staged in shared memory
// past the chunk; n_cmds [B]; cmds [B, TP] pairs; pb 15 or 16 on JAX's
// packed path (flagged blocks), 0 off it. NTH threads, SPT slots a thread.
template <int NTH, int SPT>
__global__ void __launch_bounds__(NTH, 1)
    assemble_kernel(Planes P, const unsigned short* __restrict__ bit_half, int hb, int bits_smem,
                    const int* __restrict__ n_cmds, int2* __restrict__ cmds, int TP, int pb) {
  constexpr int CH = NTH * SPT;
  constexpr int V = SPT < 4 ? SPT : 4;  // a run's ints an access
  constexpr unsigned VM = (1u << V) - 1;
  extern __shared__ __align__(16) int smem[];
  int* X = smem;       // tok, then op_len (and a match's len symbol, a rep's lv)
  int* Y = smem + CH;  // op_val (and a dict's slot, a rep's raw bits)
  unsigned short* DR = (unsigned short*)(smem + 2 * CH);  // the chunk's dicts' slots by rank
  unsigned short* MAP = DR + CH;  // its matches' slots by rank, then its literals'
  __shared__ int sc3[32][3];
  __shared__ int sc2[32][2];
  const int b = blockIdx.x, t = threadIdx.x;
  const int Tc = P.tok.width;
  const int ncmd = n_cmds[b];
  const int* tokrow = P.tok.p + (long long)b * P.tok.stride;
  int2* orow = cmds + (long long)b * TP;

  // the raw-bit row: halfword h at sb[h], 16-byte chunks by cp.async, the
  // unaligned ends (at most 7 halfwords each) one a thread, stored once
  // the chunk's tok is on its way
  const unsigned short* bits = bit_half + (long long)b * hb;
  unsigned short* sb = nullptr;
  int end_at = -1;
  unsigned short end_v = 0;
  if (bits_smem) {
    const uintptr_t a = (uintptr_t)bits;
    sb = MAP + CH + ((a & 15) >> 1);
    const int head = min(hb, (int)(((16 - (a & 15)) & 15) >> 1));
    const int n16 = (hb - head) >> 3, tail = head + 8 * n16;
    for (int q = t; q < n16; q += NTH) cp_async16(sb + head + 8 * q, bits + head + 8 * q);
    if (t < head) end_at = t;
    if (t >= 8 && t - 8 < hb - tail) end_at = tail + t - 8;
    if (end_at >= 0) end_v = bits[end_at];
    bits = sb;
  }

  int m_base = 0, d_base = 0, l_base = 0, e_base = 0, w_base = 0;
  int cw[4] = {1, 2, 3, 4};  // distances of dict ranks d_base - 1 - q (the virtual history first)
  int bad = 0;
  const int r0 = t * SPT;  // the run: chunk slots r0 .. r0 + SPT - 1
  for (int c0 = 0; c0 < Tc; c0 += CH) {
    for (int k = t; k < CH; k += NTH) {
      if (c0 + k < Tc)
        cp_async4(X + swz(k), tokrow + c0 + k);
      else
        X[swz(k)] = 0;
    }
    if (end_at >= 0 && c0 == 0) sb[end_at] = end_v;
    cp_async_wait_all();
    __syncthreads();

    // kinds (a bit a slot: literal, dict, match) and scan 1
    unsigned lm = 0, dm = 0, mm = 0;
#pragma unroll 1
    for (int i0 = 0; i0 < SPT; i0 += V) {
      Vec<V> x;
      x.load(X + swz(r0 + i0));
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int i = i0 + q, g = c0 + r0 + i;
        const bool live = g < Tc && g < ncmd;
        lm |= (unsigned)(live && x.v[q] == TOK_LIT) << i;
        dm |= (unsigned)(live && x.v[q] == TOK_DICT) << i;
        mm |= (unsigned)(live && (x.v[q] == TOK_DICT || x.v[q] == TOK_REP)) << i;
      }
    }
    int f3[3] = {__popc(mm), __popc(dm), __popc(lm)}, t3[3];
    block_scan_ints<NTH>(f3, t3, sc3);

    // the chunk's len, literal and slot symbols are contiguous runs of
    // their planes (ranks m_base.., l_base.., d_base..): each run maps its
    // matches' and literals' ranks (MAP) and its dicts' (DR) to their
    // slots and sets what no copy writes; then the ranges are copied
    // coalesced (cp.async) straight into the slots (X: len symbol, Y: slot
    // or literal); scan 2
    {
      int mr = f3[0], lr = t3[0] + f3[2], dr = f3[1];
#pragma unroll 1
      for (int i0 = 0; i0 < SPT; i0 += V) {
        Vec<V> x, y;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int i = i0 + q, g = c0 + r0 + i;
          const bool lit = (lm >> i) & 1u, match = (mm >> i) & 1u, dict = (dm >> i) & 1u;
          if (match) MAP[mr++] = (unsigned short)(r0 + i);
          if (lit) MAP[lr++] = (unsigned short)(r0 + i);
          if (dict) DR[dr++] = (unsigned short)(r0 + i);
          x.v[q] = lit || match || (g < Tc && g < ncmd) ? 0 : -1;
          y.v[q] = 0;
        }
        x.store(X + swz(r0 + i0));
        y.store(Y + swz(r0 + i0));
      }
    }
    __syncthreads();
    for (int j = t; j < t3[0]; j += NTH)
      cp_async4(X + swz(MAP[j]), at_ptr(P.len, b, m_base + j));
    for (int j = t; j < t3[2]; j += NTH)
      cp_async4(Y + swz(MAP[t3[0] + j]), at_ptr(P.lit, b, l_base + j));
    for (int j = t; j < t3[1]; j += NTH) cp_async4(Y + swz(DR[j]), at_ptr(P.slot, b, d_base + j));
    m_base += t3[0];
    l_base += t3[2];
    d_base += t3[1];
    cp_async_wait_all();
    __syncthreads();
    unsigned esc = 0;
    int width_sum = 0, t2[2];
#pragma unroll 1
    for (int i0 = 0; i0 < SPT; i0 += V) {
      if (!((mm >> i0) & VM)) continue;
      Vec<V> x, y;
      x.load(X + swz(r0 + i0));
      y.load(Y + swz(r0 + i0));
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int i = i0 + q;
        const bool match = (mm >> i) & 1u, dict = (dm >> i) & 1u;
        esc |= (unsigned)(match && x.v[q] == 7) << i;
        width_sum += dict ? ab_of(y.v[q]) : (match ? 2 : 0);
      }
    }
    int f2[2] = {(int)__popc(esc), width_sum};
    block_scan_ints<NTH>(f2, t2, sc2);
    int er = e_base + f2[0], off = w_base + f2[1];
    e_base += t2[0];
    w_base += t2[1];

    // lex gathers in flight (over an escape's len symbol, 7); raw-bit
    // fields; dicts final
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if ((esc >> i) & 1u) cp_async4(X + swz(r0 + i), at_ptr(P.lex, b, er++));
    cp_async_wait_all();
    {
#pragma unroll 1
      for (int i0 = 0; i0 < SPT; i0 += V) {
        if (!((mm >> i0) & VM)) continue;
        Vec<V> x, y;
        x.load(X + swz(r0 + i0));
        y.load(Y + swz(r0 + i0));
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int i = i0 + q;
          if (!((mm >> i) & 1u)) continue;
          const bool dict = (dm >> i) & 1u;
          const int lv = (esc >> i) & 1u ? wadd(7, x.v[q]) : x.v[q];
          const int slot = y.v[q], ab = ab_of(slot);  // a rep's slot reads 0
          const int width = dict ? ab : 2;
          const int v = bits_fetch(bits, hb, off, width);
          off += width;
          const int delta = dict_delta(slot, ab, v);
          if (dict) bad |= pb != 0 && (unsigned)delta >= (1u << pb);
          x.v[q] = dict ? wadd(lv, mmin_of(delta)) : lv;
          y.v[q] = dict ? delta : v;
        }
        x.store(X + swz(r0 + i0));
        y.store(Y + swz(r0 + i0));
      }
    }
    __syncthreads();

    // reps: the dict of rank d_rank - 1 - v, through DR or the window
    const unsigned rm = mm & ~dm;
    if (rm) {
      int dr = f3[1];  // the chunk's dicts before the slot
#pragma unroll 1
      for (int i0 = 0; i0 < SPT; i0 += V) {
        if (!((rm >> i0) & VM)) {
          dr += __popc((dm >> i0) & VM);
          continue;
        }
        Vec<V> x, y;
        x.load(X + swz(r0 + i0));
        y.load(Y + swz(r0 + i0));
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int i = i0 + q;
          if ((rm >> i) & 1u) {
            const int j = dr - 1 - y.v[q];  // chunk-relative, at least -4
            const int delta = j >= 0 ? Y[swz(DR[j])] : pick4(cw, -1 - j);
            x.v[q] = wadd(x.v[q], mmin_of(delta));
            y.v[q] = delta;
          }
          dr += (dm >> i) & 1u;
        }
        x.store(X + swz(r0 + i0));
        y.store(Y + swz(r0 + i0));
      }
    }

    // the warp's 32 runs as pairs, 16 bytes a store, as soon as its runs
    // are done (TP and c0 are even)
    __syncwarp();
    const int p0 = (t >> 5) * 16 * SPT, p1 = min(p0 + 16 * SPT, (TP - c0) >> 1);
    for (int p = p0 + (t & 31); p < p1; p += 32) {
      const int i = swz(2 * p);
      const int2 x = *(const int2*)(X + i), y = *(const int2*)(Y + i);
      *(int4*)(orow + c0 + 2 * p) = make_int4(x.x, y.x, x.y, y.y);
    }
    if (c0 + CH < Tc) {
      // the window for the next chunk: its dicts' latest four, then the
      // old (a rep of this chunk never rewrites a dict's distance)
      const int nd = t3[1];
      int nw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) nw[q] = nd > q ? Y[swz(DR[nd - 1 - q])] : pick4(cw, q - nd);
#pragma unroll
      for (int q = 0; q < 4; ++q) cw[q] = nw[q];
      __syncthreads();  // the next chunk's tok lands in X, its dicts in DR
    }
  }
  if (__syncthreads_or(bad))
    flagged_block<NTH>(P, b, ncmd, bits, hb, pb, (unsigned*)smem, orow);
}

struct Config {
  int nth, spt, bits_smem;
  size_t smem;
};

// threads: NT_SMALL up to SMALL slots, else NT; slots a thread: the least
// power of two whose chunk holds Tc, the chunk at most CHMAX; the chunk's
// two planes and its two rank-to-slot maps, and the raw-bit row while it
// fits
__host__ Config config_of(int Tc, int hb) {
  Config c = {Tc <= SMALL ? NT_SMALL : NT, 1, 0, 0};
  while (c.spt * c.nth < Tc && 2 * c.spt * c.nth <= CHMAX) c.spt <<= 1;
  const int CH = c.nth * c.spt;
  c.smem = 12 * (size_t)CH;
  const size_t row = ((size_t)2 * hb + 31) & ~(size_t)15;
  if (c.smem + row <= SMEM_MAX) {
    c.bits_smem = 1;
    c.smem += row;
  }
  return c;
}

// the dynamic shared-memory limit of a kernel (slot: its index in the
// dispatch), raised once a device to at least `bytes`, never lowered
cudaError_t smem_setup(const void* fn, int slot, size_t bytes, int device) {
  static size_t done[16][64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || done[slot][device] >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done[slot][device] = bytes;
  return e;
}

int slot_of(const Config& c) { return (c.nth == NT ? 8 : 0) + __builtin_ctz(c.spt); }

// the largest chunk of a thread count (its largest power-of-two SPT)
template <int NTH>
constexpr int chunk_max() { return NTH == NT ? CHMAX : SMALL; }

constexpr int widest_chunk(int nth, int spt = 1) {
  return 2 * nth * spt <= CHMAX ? widest_chunk(nth, 2 * spt) : nth * spt;
}
// a flagged block (Tc <= 32768) sorts its keys in the chunk's X, Y, DR and MAP
static_assert(3 * widest_chunk(NT) >= 32768, "a flagged block's keys must fit the chunk");

template <int NTH, int SPT = 1>
const void* kernel_of(int spt) {
  if constexpr (2 * NTH * SPT <= chunk_max<NTH>()) {
    if (spt > SPT) return kernel_of<NTH, 2 * SPT>(spt);
  }
  return (const void*)assemble_kernel<NTH, SPT>;
}

const void* kernel_of(const Config& c) {
  return c.nth == NT ? kernel_of<NT>(c.spt) : kernel_of<NT_SMALL>(c.spt);
}

template <int NTH, int SPT = 1>
void launch_spt(const Config& c, int B, cudaStream_t s, const Planes& P, const unsigned short* bh,
                int hb, const int* n_cmds, int2* cmds, int TP, int pb) {
  if constexpr (2 * NTH * SPT <= chunk_max<NTH>()) {
    if (c.spt > SPT) return launch_spt<NTH, 2 * SPT>(c, B, s, P, bh, hb, n_cmds, cmds, TP, pb);
  }
  assemble_kernel<NTH, SPT><<<B, NTH, c.smem, s>>>(P, bh, hb, c.bits_smem, n_cmds, cmds, TP,
                                                   pb);
}

}  // namespace

// tok/len/lex/lit/slot: [B, width] i32 plane symbols (row stride given);
// bit_half [B, hb] u16; n_cmds [B] i32; cmds [B, TP] (op_len, op_val) i32
// pairs, TP = Tc rounded up to even, Tc the tok width (slots from Tc on:
// -1, 0); pb: 15 or 16 on JAX's packed path (16 with a dictionary), 0
// above it.
NLZM_API int nlzm_assemble(const void* tok, const void* len, const void* lex, const void* lit,
                           const void* slot, const void* bit_half, const void* n_cmds, void* cmds,
                           int B, int tok_w, int tok_s, int len_w, int len_s, int lex_w, int lex_s,
                           int lit_w, int lit_s, int slot_w, int slot_s, int hb, int TP, int pb,
                           int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || tok_w == 0) return 0;
  if (hb < 1 || TP < tok_w || (TP & 1) || len_w < 1 || lex_w < 1 || lit_w < 1 || slot_w < 1 ||
      (pb != 0 && tok_w > 32768))
    return (int)cudaErrorInvalidValue;
  const Planes P{{(const int*)tok, tok_w, tok_s},
                 {(const int*)len, len_w, len_s},
                 {(const int*)lex, lex_w, lex_s},
                 {(const int*)lit, lit_w, lit_s},
                 {(const int*)slot, slot_w, slot_s}};
  const Config c = config_of(tok_w, hb);
  const cudaError_t e = smem_setup(kernel_of(c), slot_of(c), c.smem, device);
  if (e != cudaSuccess) return (int)e;
  const auto* bh = (const unsigned short*)bit_half;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c.nth == NT)
    launch_spt<NT>(c, B, s, P, bh, hb, (const int*)n_cmds, (int2*)cmds, TP, pb);
  else
    launch_spt<NT_SMALL>(c, B, s, P, bh, hb, (const int*)n_cmds, (int2*)cmds, TP, pb);
  return launch_status();
}

// The launch at this shape on this device, for reports: out[0..7] (host
// ints) = threads, slots a thread, dynamic shared bytes, registers a
// thread, resident CTAs an SM, SMs, 1 with the raw-bit row in shared
// memory, chunks a block.
NLZM_API int nlzm_assemble_shape(void* out, int Tc, int hb, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  const Config c = config_of(Tc, hb);
  const void* fn = kernel_of(c);
  cudaError_t e = smem_setup(fn, slot_of(c), c.smem, device);
  cudaFuncAttributes attr = {};
  int ctas = 0, sms = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, c.nth, c.smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int CH = c.nth * c.spt;
  const int v[8] = {c.nth, c.spt, (int)c.smem, attr.numRegs, ctas, sms, c.bits_smem,
                    Tc > 0 ? (Tc + CH - 1) / CH : 0};
  for (int i = 0; i < 8; ++i) ((int*)out)[i] = v[i];
  return 0;
}
