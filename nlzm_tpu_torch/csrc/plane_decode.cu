// One wide-profile plane's rANS decode with multi-row, multi-read context
// tables: the decoder side of plane_encode.cu for any plane spec.
//
// Replaces nlzm_tpu/ops/wide_decode.py::plane_scan (with _build_cdf_jnp and
// _uniform_tables; its windows come from stage_plane). On the TPU a step
// was a set of tensor ops over [B, L] with one-hot row selects and pair
// selects on the MXU.
//
// Bound: the latency of each lane's serial chain (steps x reads dependent
// table reads and renorms a block), with one warp a block issuing its
// steps and its table rebuilds alone; then bytes (the windows, the context
// rows where a read keys on them, the symbols written: a few KB a block).
// The design keeps each step's chain and each chunk's rebuild short.
// The warp path (L <= 64 lanes and tables that fit; ops/wide_decode.py
// plane_decode_layout chooses the path and each read's table at launch and
// passes the shared-memory layout):
// - One CTA of one warp a block; a plane of 33 to 64 lanes gives thread t
//   the lanes 2t and 2t + 1. A lane's renorm rank is the popc of the
//   read's ballots below it: no barrier wider than __syncwarp.
// - Only the block's live steps, ceil(n_sym / L) clamped to 0..steps, are
//   walked, its tables rebuilt only while steps remain; the rest of its
//   output is zero-filled (16-byte stores where aligned).
// - Pairs from shared memory: chunk c's window row wins[c, b, 0:min(WH,
//   8 R L)] is copied by cp.async RING - 1 chunks ahead into a ring slot. A
//   chunk of at most 8 steps renormalises at most 8 R L times, so the slot
//   holds every index the clamp min(rel + rank, WH - 1) can give. Where a
//   read keys on the context rows (a multi-row first read, or a dst plane's
//   multi-row later read) the chunk's rows ride a second ring; else no
//   context row is loaded.
// - No search loop. REG (one read, one row, at most 8 symbols: tok, len):
//   3 or 7 fences in registers, every lane the whole table, a symbol by as
//   many compares. BITMAP (other one-row reads: dst, lit, lex): a
//   bitmap of the fences over the 2^14 CDF values, each 32-bit word beside
//   the count of fences before it, and the spans (start | freq << 16): a
//   symbol is that count plus a popc, one 64-bit load, its span a second.
//   SEARCH (multi-row reads): a branch-free binary search over the row's
//   u16 fences (a bitmap a row costs a rebuild every chunk, more than its
//   shorter lookups save on the synthetic multi-row specs).
// - One read of one row and at most 256 symbols (every wire plane) has a
//   kernel of its own, its widths compile-time: the carries in registers (a
//   lane ceil(alph / 32) adjacent entries, rounded to a power of two; REG:
//   the whole table), a lane's symbols of the chunk in registers (8-bit
//   fields summed by redux.sync for REG; a byte each, added by shared
//   atomics at the chunk's end for BITMAP). Other planes keep carries and
//   counts in shared memory (a multi-row read's rows at an odd stride): with
//   one read a lane's keys (their index, u16) wait in registers for the
//   chunk's end; with more reads a shared atomic a symbol, its result
//   unused. Four or more SEARCH rows of at most 32 symbols rebuild a lane a
//   row.
// - Rebuild by the block's warp: carry = (carry >> 1) + counts, freq = 1 +
//   carry (2^14 - alph) / (tot + 1) with the quotient a multiply-high by
//   floor((2^32 - 1) / (tot + 1)) and one correction (exact: the wrapper
//   holds priors to u16 and a chunk adds at most 8 L to an entry, so carry
//   <= 65535 and the dividend < 2^30), one warp scan, then the bitmap or
//   the u16 fences.
// - The descriptors pass by value (a kernel parameter): nothing is uploaded
//   for a launch; the shared-memory limit is raised once per kernel and size.
// The general path (wider planes, or tables past the warp path's shared
// memory): one CTA of L threads (rounded up to a warp) a block; the rank
// across warps exchanged through shared memory, one __syncthreads a read;
// pairs and context rows from device memory; int fences (searched as
// SEARCH), carries and counts in shared memory (common.cuh plane_tables_*).
// It too walks only the live steps.
// Both: a row outside [0, rows) reads as JAX's all-zero one-hot row (symbol
// alph, start 0, freq 0, no count); a dst plane keys read r > 0 on row0 * 8
// + y_prev (i32 wraparound), other planes on y_prev; a single-row read
// ignores the row; the lane state is u32 with wraparound.
#include "common.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr int MAX_CLEN = 8;  // format/wide.py CHUNK_STEPS: the longest chunk
constexpr int RING = 4;      // ring slots; rows are copied RING - 1 chunks ahead
constexpr int NWORD = CDF_TOTAL / 32;   // fence bitmap words
constexpr int NTB = NWORD + NWORD / 8;  // with two words of padding every 16
constexpr int KIND_REG = 0, KIND_BITMAP = 1, KIND_SEARCH = 2;
constexpr int PD_FIELDS = 92;  // int64 fields of a launch (ops/wide_decode.py)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0xFFFFu;  // keys are below rows * (alph + 1) <= 28800

struct Read {
  const int* prior;  // [rows, alph] i32 counts, or null for uniform tables
  int* out;          // [B, steps * L] i32 symbols
  int alph, rows, kind;
  int car, cnt, tab, stride;  // bytes into shared memory: carries, counts, tables; a table row
};

struct Params {
  Read rd[MAX_R];
  const unsigned* seeds;  // [B, L]
  const int* wins;        // [NC, B, WH]
  const int* n_sym;       // [B]
  const int* ctx;         // [B, steps * L]
  int B, L, R, steps, NC, WH, is_dst;
  int ncopy;   // pairs of a chunk's row copied: min(WH, 8 R L)
  int slot;    // ints a ring slot (ncopy rounded up to 4)
  int ctx_at;  // byte offset of the context-row ring, -1 where no read keys on it
  int vec_win, vec_ctx, vec_out;  // 16-byte copies and stores allowed
};

__device__ __forceinline__ int chunk_len(int c) { return c < 2 ? 2 : (c == 2 ? 4 : MAX_CLEN); }

// chunk c's first step (format/wide.py chunk_schedule: 2, 2, 4, 8, then 8s)
__device__ __forceinline__ int chunk_start(int c) {
  return c < 4 ? (c ? 1 << c : 0) : MAX_CLEN * c - 16;
}

// block b's live steps, ceil(n_sym / L) clamped to 0..steps, and the lanes
// that decode at the last of them
__device__ __forceinline__ void live_steps(const Params& P, int nsym, int& live, int& last_n) {
  live = nsym <= 0 ? 0 : min(P.steps, (nsym - 1) / P.L + 1);
  last_n = live ? (int)min((long long)P.L, (long long)nsym - (long long)(live - 1) * P.L) : 0;
}

__device__ __forceinline__ int tb_index(int w) { return w + 2 * (w >> 4); }

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy but the latest N groups has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n ints from src to dst by the warp, 16 bytes a copy where vec
__device__ __forceinline__ void copy_async(int* dst, const int* src, int n, int vec) {
  const int t = threadIdx.x;
  if (vec) {
    for (int k = 4 * t; k < n; k += 128) cp_async16(dst + k, src + k);
  } else {
    for (int k = t; k < n; k += 32) cp_async4(dst + k, src + k);
  }
}

// the window row of chunk c (and its context rows, where staged) into its
// ring slots
__device__ __forceinline__ void fetch_chunk(const Params& P, unsigned char* sm, int b, int c) {
  copy_async(reinterpret_cast<int*>(sm) + (c % RING) * P.slot,
             P.wins + ((long long)c * P.B + b) * P.WH, P.ncopy, P.vec_win);
  if (P.ctx_at >= 0)
    copy_async(reinterpret_cast<int*>(sm + P.ctx_at) + (c % RING) * MAX_CLEN * P.L,
               P.ctx + ((long long)b * P.steps + chunk_start(c)) * P.L, chunk_len(c) * P.L,
               P.vec_ctx);
}

// floor(n / d) for n < 2^31 from m = floor((2^32 - 1) / d): n * m / 2^32
// lies in (n / d - 1/2, n / d], so the multiply-high is exact or one short
__device__ __forceinline__ unsigned quot(unsigned n, unsigned d, unsigned m) {
  unsigned q = __umulhi(n, m);
  if (n - q * d >= d) ++q;
  return q;
}

// a lane's N adjacent ints at p (p aligned to their size)
template <int N>
__device__ __forceinline__ void load_row(const int* p, int (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = p[0];
  } else if constexpr (N == 2) {
    const int2 w = *reinterpret_cast<const int2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4 w = *reinterpret_cast<const int4*>(p + i);
      v[i] = w.x;
      v[i + 1] = w.y;
      v[i + 2] = w.z;
      v[i + 3] = w.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_row(int* p, const int (&v)[N]) {
  if constexpr (N == 1) {
    p[0] = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<int4*>(p + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// The bitmap's word counts, once every fence bit is set: 16 adjacent words a
// lane, at tb_index(16 lane) = 18 lane, 16 bytes at a time, each word beside
// the count of fences before it. The whole warp calls.
__device__ __forceinline__ void word_counts(unsigned char* tab) {
  constexpr int PER = NWORD / 32;
  const int lane = threadIdx.x & 31;
  ulonglong2* tb2 = reinterpret_cast<ulonglong2*>(tab) + lane * (PER + 2) / 2;
  unsigned bits[PER];
  int loc = 0;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const ulonglong2 w = tb2[i / 2];
    bits[i] = (unsigned)w.x;
    bits[i + 1] = (unsigned)w.y;
    loc += __popc(bits[i]) + __popc(bits[i + 1]);
  }
  int before = warp_inclusive_sum(loc) - loc;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const int b1 = before + __popc(bits[i]);
    tb2[i / 2] = make_ulonglong2((unsigned long long)before << 32 | bits[i],
                                 (unsigned long long)b1 << 32 | bits[i + 1]);
    before = b1 + __popc(bits[i + 1]);
  }
  __syncwarp();
}

__device__ __forceinline__ void zero_bitmap(unsigned char* tab) {
  ulonglong2* tb2 = reinterpret_cast<ulonglong2*>(tab);
  for (int i = threadIdx.x & 31; i < NTB / 2; i += 32) tb2[i] = make_ulonglong2(0, 0);
}

// fence `start` (of symbol 1..a-1) into the bitmap (the word's low half)
__device__ __forceinline__ void set_fence(unsigned char* tab, int start) {
  atomicOr(reinterpret_cast<unsigned*>(tab) + 2 * tb_index(start >> 5), 1u << (start & 31));
}

// a read's carries and counts [rows, alph] lie `car_stride` ints a row: odd
// for multi-row reads, so that a lane a row reads them without bank
// conflicts
__device__ __forceinline__ int car_stride(const Read& rd) {
  return rd.rows > 1 ? rd.alph | 1 : rd.alph;
}

// Table row `row` of read rd from its carries, by the whole warp (the
// generic warp kernel). mode 0: uniform fences k * (2^14 / alph); 1: from
// the carries as they are (a prior); 2: carry = (carry >> 1) + counts
// first, counts zeroed. A lane takes the run of entries [lane E, lane E +
// E), E = ceil(alph / 32).
__device__ void build_row(const Read& rd, unsigned char* sm, int row, int mode) {
  const int lane = threadIdx.x, a = rd.alph;
  const int E = (a + 31) >> 5, k0 = min(lane * E, a), k1 = min(k0 + E, a);
  int* car = reinterpret_cast<int*>(sm + rd.car) + row * car_stride(rd);
  int* cnt = reinterpret_cast<int*>(sm + rd.cnt) + row * car_stride(rd);
  unsigned char* base = sm + rd.tab + row * rd.stride;
  const bool bitmap = rd.kind == KIND_BITMAP;
  if (bitmap) zero_bitmap(base);
  const int step = CDF_TOTAL / a;
  unsigned d = 1, m = FULL;
  int run = k0 * step;
  if (mode) {
    int tot = 0;
    for (int k = k0; k < k1; ++k) {
      int c = car[k];
      if (mode == 2) {
        c = (c >> 1) + cnt[k];
        car[k] = c;
        cnt[k] = 0;
      }
      tot += c;
    }
    d = __reduce_add_sync(FULL, (unsigned)tot) + 1u;
    m = FULL / d;
    int loc = 0;
    for (int k = k0; k < k1; ++k) loc += 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - a), d, m);
    run = warp_inclusive_sum(loc) - loc;
  }
  __syncwarp();  // the bitmap is zeroed
  if (bitmap) {
    unsigned* span = reinterpret_cast<unsigned*>(base + NTB * 8);
    for (int k = k0; k < k1; ++k) {
      const int fr = k == a - 1 ? CDF_TOTAL - run
                                : (mode ? 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - a), d, m)
                                        : step);
      span[k] = (unsigned)run | (unsigned)fr << 16;
      if (k >= 1) set_fence(base, run);
      run += fr;
    }
    __syncwarp();
    word_counts(base);
  } else {
    uint16_t* fen = reinterpret_cast<uint16_t*>(base);
    for (int k = k0; k < k1; ++k) {
      fen[k] = (uint16_t)run;
      run += mode ? 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - a), d, m) : step;
    }
    if (lane == 0) fen[a] = (uint16_t)CDF_TOTAL;
    __syncwarp();
  }
}

// SEARCH rows row0 .. row0 + 31 of read rd (alph <= 32), a lane a row, by
// the whole warp: the modes of build_row, each lane's entries in turn
__device__ void build_rows(const Read& rd, unsigned char* sm, int row0, int mode) {
  const int row = row0 + (threadIdx.x & 31), a = rd.alph, cs = car_stride(rd);
  if (row < rd.rows) {
    int* car = reinterpret_cast<int*>(sm + rd.car) + row * cs;
    int* cnt = reinterpret_cast<int*>(sm + rd.cnt) + row * cs;
    unsigned d = 1, m = FULL;
    if (mode) {
      int tot = 0;
      for (int k = 0; k < a; ++k) {
        int c = car[k];
        if (mode == 2) {
          c = (c >> 1) + cnt[k];
          car[k] = c;
          cnt[k] = 0;
        }
        tot += c;
      }
      d = (unsigned)tot + 1u;
      m = FULL / d;
    }
    uint16_t* fen = reinterpret_cast<uint16_t*>(sm + rd.tab) + row * (a + 1);
    int run = 0;
    for (int k = 0; k < a; ++k) {
      fen[k] = (uint16_t)run;
      run += mode ? 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - a), d, m) : CDF_TOTAL / a;
    }
    fen[a] = (uint16_t)CDF_TOTAL;
  }
  __syncwarp();
}

// every table row of read rd: a lane a row for four or more SEARCH rows of
// at most 32 symbols, else a warp a row
__device__ void build_read(const Read& rd, unsigned char* sm, int mode) {
  if (rd.kind == KIND_SEARCH && rd.rows >= 4 && rd.alph <= 32) {
    for (int row = 0; row < rd.rows; row += 32) build_rows(rd, sm, row, mode);
  } else {
    for (int row = 0; row < rd.rows; ++row) build_row(rd, sm, row, mode);
  }
}

// REG: fences 1..N in registers (CDF_TOTAL past alph - 1) from the
// carries of the alph <= N + 1 symbols, every lane
template <int N>
__device__ __forceinline__ void build_reg(int (&fen)[N + 1], const int (&car)[N + 1], int a,
                                          bool uniform) {
  if (uniform) {
#pragma unroll
    for (int k = 1; k <= N; ++k) fen[k] = k < a ? k * (CDF_TOTAL / a) : CDF_TOTAL;
    return;
  }
  int tot = 0;
#pragma unroll
  for (int k = 0; k <= N; ++k) tot += car[k];
  const unsigned d = (unsigned)tot + 1u, m = FULL / d;
  int run = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    run += 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - a), d, m);
    fen[k + 1] = k + 1 < a ? run : CDF_TOTAL;
  }
}

// BITMAP, one row: spans and bitmap from this lane's N carries (entries
// lane N .. lane N + N - 1; zero past alph - 1), or uniform
template <int N>
__device__ __forceinline__ void build_bitmap(unsigned char* tab, const int (&car)[N], int a,
                                             bool uniform) {
  const int k0 = (threadIdx.x & 31) * N;
  zero_bitmap(tab);
  int fr[N], loc = 0;
  if (uniform) {
#pragma unroll
    for (int e = 0; e < N; ++e) fr[e] = k0 + e < a ? CDF_TOTAL / a : 0;
  } else {
    int sum = 0;
#pragma unroll
    for (int e = 0; e < N; ++e) sum += car[e];
    const unsigned d = __reduce_add_sync(FULL, (unsigned)sum) + 1u, m = FULL / d;
#pragma unroll
    for (int e = 0; e < N; ++e)
      fr[e] = k0 + e < a ? 1 + (int)quot((unsigned)car[e] * (CDF_TOTAL - a), d, m) : 0;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) loc += fr[e];
  int run = warp_inclusive_sum(loc) - loc;
  int st[N], sp[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    st[e] = run;
    sp[e] = run | (k0 + e == a - 1 ? CDF_TOTAL - run : fr[e]) << 16;
    run += fr[e];
  }
  store_row<N>(reinterpret_cast<int*>(tab + NTB * 8) + k0, sp);
  __syncwarp();  // the bitmap is zeroed
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (k0 + e >= 1 && k0 + e < a) set_fence(tab, st[e]);
  }
  __syncwarp();
  word_counts(tab);
}

// The warp path's planes of one read of one row and at most 256 symbols
// (every wire plane): REG with N = 3 or 7 fences, else BITMAP with N
// carries a lane; LPT lanes a thread.
template <int LPT, bool REG, int N>
__global__ void __launch_bounds__(32) plane_decode_row(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int NE = REG ? N + 1 : N;  // carries a thread
  const int b = blockIdx.x, t = threadIdx.x;
  const int L = P.L, a = P.rd[0].alph;
  const unsigned lt = (1u << t) - 1u;
  int* cnt = reinterpret_cast<int*>(sm + P.rd[0].cnt);
  unsigned char* tab = sm + P.rd[0].tab;
  const unsigned long long* tb = reinterpret_cast<const unsigned long long*>(tab);
  const unsigned* span = reinterpret_cast<const unsigned*>(tab + NTB * 8);
  // the set-up's loads from device memory, all in flight at once
  const int nsym = P.n_sym[b];
  const int* prior = P.rd[0].prior;
  bool has[LPT], tail[LPT];  // tail: the lane decodes at the last live step
  unsigned x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    has[j] = t * LPT + j < L;
    x[j] = has[j] ? P.seeds[(long long)b * L + t * LPT + j] : 0u;
  }
  int car[NE], fen[REG ? N + 1 : 1];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int k = REG ? e : t * N + e;
    car[e] = prior && k < a ? prior[k] : 0;
  }
  int live, last_n;
  live_steps(P, nsym, live, last_n);
#pragma unroll
  for (int j = 0; j < LPT; ++j) tail[j] = t * LPT + j < last_n;
  for (int k = 0; k < RING - 1; ++k) {  // the first chunks' rows, while the tables are built
    if (k < P.NC && chunk_start(k) < live) fetch_chunk(P, sm, b, k);
    cp_async_commit();
  }
  if (live > 0) {
    if constexpr (REG) {
      build_reg<N>(fen, car, a, !prior);
    } else {
      int zero[N] = {};
      store_row<N>(cnt + t * N, zero);
      build_bitmap<N>(tab, car, a, !prior);
    }
  }

  unsigned long long pk = 0;        // REG: 8-bit counts of this thread's lanes
  unsigned long long sb[LPT] = {};  // BITMAP: a lane's symbols of the chunk, a byte each
  int* o = P.rd[0].out + (long long)b * P.steps * L + t * LPT;
  int s = 0;
  for (int c = 0; c < P.NC && s < live; ++c) {
    const int clen = chunk_len(c);
    if (c + RING - 1 < P.NC && chunk_start(c + RING - 1) < live)
      fetch_chunk(P, sm, b, c + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();
    __syncwarp();
    const int* win = reinterpret_cast<const int*>(sm) + (c % RING) * P.slot;
    int rel = 0;  // the window cursor restarts every chunk
    for (int i = 0; i < clen && s < live; ++i, ++s, o += L) {
      const bool all = s < live - 1;
      int y[LPT];
      unsigned x2[LPT];
      bool act[LPT], ren[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int f = (int)(x[j] & 0x3FFFu);
        int st, fr;
        if constexpr (REG) {
          bool ge[N + 1];
          int yy = 0, hi = CDF_TOTAL;
          st = 0;
#pragma unroll
          for (int k = 1; k <= N; ++k) {
            ge[k] = f >= fen[k];
            yy += ge[k];
            st = ge[k] ? fen[k] : st;
          }
#pragma unroll
          for (int k = N; k >= 1; --k) hi = ge[k] ? hi : fen[k];
          y[j] = yy;
          fr = hi - st;
        } else {
          const unsigned long long wd = tb[tb_index(f >> 5)];
          y[j] = (int)(wd >> 32) + __popc((unsigned)wd & ((2u << (f & 31)) - 1u));
          const unsigned sp = span[y[j]];
          st = (int)(sp & 0xFFFFu);
          fr = (int)(sp >> 16);
        }
        x2[j] = (unsigned)fr * (x[j] >> 14) + (unsigned)(f - st);
        act[j] = all ? has[j] : tail[j];
        ren[j] = act[j] && x2[j] < 65536u;
      }
      int h = rel;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const unsigned mj = __ballot_sync(FULL, ren[j]);
        h += __popc(mj & lt);
        rel += __popc(mj);
      }
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        // lane j's pair index: h plus the renorms of this thread's lower lanes
        const unsigned pair = (unsigned)win[min(j ? h + ren[0] : h, P.WH - 1)];
        x[j] = ren[j] ? (x2[j] << 16) | pair : (act[j] ? x2[j] : x[j]);
        if constexpr (REG) {
          pk += act[j] ? 1ull << (8 * y[j]) : 0ull;
        } else {
          sb[j] = sb[j] << 8 | (unsigned)y[j];
        }
        if (!act[j]) y[j] = 0;
      }
      if constexpr (LPT == 2) {
        if (P.vec_out) {
          if (has[0]) *reinterpret_cast<int2*>(o) = make_int2(y[0], y[1]);
        } else {
          if (has[0]) o[0] = y[0];
          if (has[1]) o[1] = y[1];
        }
      } else {
        if (has[0]) o[0] = y[0];
      }
    }
    if (s < live) {  // the tables of the next chunk; every lane was live in this one
      if constexpr (REG) {
        int cn[4 * ((NE + 3) / 4)];
#pragma unroll
        for (int w = 0; w < (NE + 3) / 4; ++w) {
          const unsigned v = (unsigned)(pk >> (32 * w));
          const unsigned ev = __reduce_add_sync(FULL, v & 0x00FF00FFu);
          const unsigned od = __reduce_add_sync(FULL, (v >> 8) & 0x00FF00FFu);
          cn[4 * w] = (int)(ev & 0xFFFFu);
          cn[4 * w + 1] = (int)(od & 0xFFFFu);
          cn[4 * w + 2] = (int)(ev >> 16);
          cn[4 * w + 3] = (int)(od >> 16);
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) car[e] = (car[e] >> 1) + cn[e];
        build_reg<N>(fen, car, a, false);
      } else {
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
#pragma unroll
          for (int q = 0; q < MAX_CLEN; ++q) {
            if (has[j] && q < clen) atomicAdd(cnt + ((sb[j] >> (8 * q)) & 0xFF), 1);
          }
        }
        __syncwarp();  // every count of the chunk is in, every search done
        int cn[N], zero[N] = {};
        load_row<N>(cnt + t * N, cn);
        store_row<N>(cnt + t * N, zero);
#pragma unroll
        for (int e = 0; e < N; ++e) car[e] = (car[e] >> 1) + cn[e];
        build_bitmap<N>(tab, car, a, false);
      }
    }
    pk = 0;
    __syncwarp();  // the ring slot of chunk c is free
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // steps past the live ones emit 0
  int* out = P.rd[0].out + (long long)b * P.steps * L;
  const long long from = (long long)s * L, to = (long long)P.steps * L;
  if (P.vec_out) {
    for (long long k = from + 4 * t; k < to; k += 128)
      *reinterpret_cast<int4*>(out + k) = make_int4(0, 0, 0, 0);
  } else {
    for (long long k = from + t; k < to; k += 32) out[k] = 0;
  }
}

// The warp path's other planes (several reads, several rows, or more than
// 256 symbols): one warp a block, LPT lanes a thread; ONE: a single read.
template <int LPT, bool ONE>
__global__ void __launch_bounds__(32) plane_decode_warp(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ Read s_rd[MAX_R];  // the descriptors, indexed by read without parameter loads
  const int b = blockIdx.x, t = threadIdx.x;
  const int L = P.L, R = ONE ? 1 : P.R, steps = P.steps;
  const unsigned lt = (1u << t) - 1u;
  if (t < R) s_rd[t] = P.rd[t];
  __syncwarp();
  const int* cring = P.ctx_at >= 0 ? reinterpret_cast<const int*>(sm + P.ctx_at) : nullptr;
  int live, last_n;
  live_steps(P, P.n_sym[b], live, last_n);
  const long long blk = (long long)b * steps * L;  // symbol / row offset of block b
  for (int k = 0; k < RING - 1; ++k) {  // the first chunks' rows, while the tables are built
    if (k < P.NC && chunk_start(k) < live) fetch_chunk(P, sm, b, k);
    cp_async_commit();
  }

  bool has[LPT];
  unsigned x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    has[j] = t * LPT + j < L;
    x[j] = has[j] ? P.seeds[(long long)b * L + t * LPT + j] : 0u;
  }
  if (live > 0) {
    for (int r = 0; r < R; ++r) {
      const Read& rd = s_rd[r];
      int* car = reinterpret_cast<int*>(sm + rd.car);
      int* cnt = reinterpret_cast<int*>(sm + rd.cnt);
      const int a = rd.alph, cs = car_stride(rd);
      for (int i = t; i < rd.rows * a; i += 32) {
        const int at = i / a * cs + i % a;
        car[at] = rd.prior ? rd.prior[i] : 0;
        cnt[at] = 0;
      }
      __syncwarp();
      build_read(rd, sm, rd.prior ? 1 : 0);
    }
  }

  unsigned long long kb[LPT][2] = {};  // one read: a lane's keys, u16 each, newest lowest
  int s = 0;
  for (int c = 0; c < P.NC && s < live; ++c) {
    const int clen = chunk_len(c);
    if (c + RING - 1 < P.NC && chunk_start(c + RING - 1) < live)
      fetch_chunk(P, sm, b, c + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();
    __syncwarp();
    const int* win = reinterpret_cast<const int*>(sm) + (c % RING) * P.slot;
    const int* crow = cring ? cring + (c % RING) * MAX_CLEN * L : nullptr;
    int rel = 0;  // the window cursor restarts every chunk
    for (int i = 0; i < clen && s < live; ++i, ++s) {
      const bool all = s < live - 1;
      int row0[LPT], yprev[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        row0[j] = crow && has[j] ? crow[i * L + t * LPT + j] : 0;
        yprev[j] = 0;
      }
      for (int r = 0; r < R; ++r) {
        const Read& rd = ONE ? P.rd[0] : s_rd[r];
        const int a = rd.alph;
        int y[LPT];
        unsigned x2[LPT], key[LPT];
        bool act[LPT], ren[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const int f = (int)(x[j] & 0x3FFFu);
          int yy, st, fr, row = 0;
          bool ok = true;
          act[j] = has[j] && (all || t * LPT + j < last_n);
          if (rd.rows > 1) {
            row = r == 0 ? row0[j]
                         : (P.is_dst ? (int)((unsigned)row0[j] * 8u + (unsigned)yprev[j])
                                     : yprev[j]);
            ok = (unsigned)row < (unsigned)rd.rows;
            row = ok ? row : 0;
          }
          if (rd.kind == KIND_BITMAP) {
            const unsigned char* base = sm + rd.tab + row * rd.stride;
            const unsigned long long wd =
                reinterpret_cast<const unsigned long long*>(base)[tb_index(f >> 5)];
            yy = (int)(wd >> 32) + __popc((unsigned)wd & ((2u << (f & 31)) - 1u));
            const unsigned sp = reinterpret_cast<const unsigned*>(base + NTB * 8)[yy];
            st = (int)(sp & 0xFFFFu);
            fr = (int)(sp >> 16);
          } else {  // fen[yy] <= f < fen[yy + 1]; fen[a] = 2^14 stops every probe past a - 1
            const uint16_t* fq = reinterpret_cast<const uint16_t*>(sm + rd.tab) + row * (a + 1);
            yy = 0;
            for (int h = a > 1 ? 1 << (31 - __clz(a - 1)) : 0; h > 0; h >>= 1) {
              const int n = min(yy + h, a);
              yy = (int)fq[n] <= f ? n : yy;
            }
            st = fq[yy];
            fr = (int)fq[yy + 1] - st;
          }
          if (!ok) {  // the all-zero row
            yy = a;
            st = 0;
            fr = 0;
          }
          key[j] = act[j] && ok ? (unsigned)(row * car_stride(rd) + yy) : NO_KEY;
          y[j] = yy;
          x2[j] = (unsigned)fr * (x[j] >> 14) + (unsigned)(f - st);
          ren[j] = act[j] && x2[j] < 65536u;
        }
        int h = rel;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const unsigned mj = __ballot_sync(FULL, ren[j]);
          h += __popc(mj & lt);
          rel += __popc(mj);
        }
        int* o = rd.out + blk + (long long)s * L + t * LPT;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          // lane j's pair index: h plus the renorms of this thread's lower lanes
          const unsigned pair = (unsigned)win[min(j ? h + ren[0] : h, P.WH - 1)];
          x[j] = ren[j] ? (x2[j] << 16) | pair : (act[j] ? x2[j] : x[j]);
          if (!act[j]) y[j] = 0;
          yprev[j] = y[j];
          if constexpr (ONE) {
            kb[j][1] = kb[j][1] << 16 | kb[j][0] >> 48;
            kb[j][0] = kb[j][0] << 16 | key[j];
          } else if (key[j] != NO_KEY) {
            atomicAdd(reinterpret_cast<int*>(sm + rd.cnt) + key[j], 1);
          }
          if (has[j]) o[j] = y[j];
        }
      }
    }
    if (s < live) {  // the tables of the next chunk
      if constexpr (ONE) {
        int* cnt = reinterpret_cast<int*>(sm + P.rd[0].cnt);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
#pragma unroll
          for (int q = 0; q < MAX_CLEN; ++q) {
            const unsigned k = (unsigned)(kb[j][q >> 2] >> (16 * (q & 3))) & 0xFFFFu;
            if (q < clen && k != NO_KEY) atomicAdd(cnt + k, 1);
          }
        }
      }
      __syncwarp();  // every count of the chunk is in, every search done
      for (int r = 0; r < R; ++r) build_read(ONE ? P.rd[0] : s_rd[r], sm, 2);
    }
    __syncwarp();  // the ring slot of chunk c is free
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // steps past the live ones emit 0
  const long long from = (long long)s * L, to = (long long)steps * L;
  for (int r = 0; r < R; ++r) {
    int* o = s_rd[r].out + blk;
    if (P.vec_out) {
      for (long long k = from + 4 * t; k < to; k += 128)
        *reinterpret_cast<int4*>(o + k) = make_int4(0, 0, 0, 0);
    } else {
      for (long long k = from + t; k < to; k += 32) o[k] = 0;
    }
  }
}

// The general path: one CTA of L threads (rounded up to a warp) a block.
__global__ void plane_decode_cta(const __grid_constant__ Params P) {
  extern __shared__ int smi[];
  __shared__ int s_fen[MAX_R], s_car[MAX_R], s_cnt[MAX_R], s_alph[MAX_R], s_rows[MAX_R];
  __shared__ long long s_pri[MAX_R];
  __shared__ int* s_out[MAX_R];
  __shared__ int warp_cnt[2][32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5, L = P.L, R = P.R, steps = P.steps;
  if (t == 0) {
    int off = 0;
    for (int r = 0; r < R; ++r) {
      const int a = P.rd[r].alph, nr = P.rd[r].rows;
      s_pri[r] = (long long)P.rd[r].prior;
      s_out[r] = P.rd[r].out;
      s_alph[r] = a;
      s_rows[r] = nr;
      s_fen[r] = off;
      off += nr * (a + 1);
      s_car[r] = off;
      off += nr * a;
      s_cnt[r] = off;
      off += nr * a;
    }
  }
  __syncthreads();
  int live_n, last_n;
  const int nsym = P.n_sym[b];
  live_steps(P, nsym, live_n, last_n);
  if (live_n > 0) plane_tables_init(smi, s_fen, s_car, s_cnt, s_alph, s_rows, s_pri, R);

  const bool live = t < L;
  const long long blk = (long long)b * steps * L;
  unsigned x = live ? P.seeds[(long long)b * L + t] : 0u;
  int s = 0, k = 0;  // k counts reads: the parity of warp_cnt
  for (int c = 0; c < P.NC && s < live_n; ++c) {
    const int clen = chunk_len(c);
    const int* wrow = P.wins + ((long long)c * P.B + b) * P.WH;
    int rel = 0;  // the window cursor restarts every chunk
    for (int i = 0; i < clen && s < live_n; ++i, ++s) {
      const long long idx = blk + (long long)s * L + t;
      const bool active = live && (long long)s * L + t < nsym;
      const int row0 = live && P.ctx_at >= 0 ? P.ctx[idx] : 0;
      int y_prev = 0;
      for (int r = 0; r < R; ++r, ++k) {
        const int a = s_alph[r], nr = s_rows[r];
        int row = r == 0 ? row0
                         : (P.is_dst ? (int)((unsigned)row0 * 8u + (unsigned)y_prev) : y_prev);
        const bool ok = nr == 1 || (row >= 0 && row < nr);
        if (nr == 1) row = 0;
        int y = a, start = 0, freq = 0;  // the all-zero row
        const unsigned f = x & 0x3FFFu;
        if (live && ok) {  // fen[y] <= f < fen[y + 1], branch-free as SEARCH
          const int* fen = smi + s_fen[r] + row * (a + 1);
          y = 0;
          for (int h = a > 1 ? 1 << (31 - __clz(a - 1)) : 0; h > 0; h >>= 1) {
            const int n = min(y + h, a);
            y = fen[n] <= (int)f ? n : y;
          }
          start = fen[y];
          freq = fen[y + 1] - start;
        }
        const unsigned x2 = (unsigned)freq * (x >> 14) + (f - (unsigned)start);
        const bool ren = active && x2 < 65536u;
        const unsigned m = __ballot_sync(FULL, ren);
        int rank = __popc(m & ((1u << lane) - 1u));
        if (lane == 0) warp_cnt[k & 1][warp] = __popc(m);
        __syncthreads();
        int total = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int cw = warp_cnt[k & 1][w];
          if (w < warp) rank += cw;
          total += cw;
        }
        if (ren) {
          x = (x2 << 16) | (unsigned)wrow[clampi(rel + rank, 0, P.WH - 1)];
        } else if (active) {
          x = x2;
        }
        rel += total;
        if (!active) y = 0;
        if (active && ok && y < a) atomicAdd(&smi[s_cnt[r] + row * a + y], 1);
        if (live) s_out[r][idx] = y;
        y_prev = y;
      }
    }
    if (s < live_n) plane_tables_rebuild(smi, s_fen, s_car, s_cnt, s_alph, s_rows, R);
  }
  // steps past the live ones emit 0
  for (int r = 0; r < R; ++r) {
    int* o = s_out[r] + blk;
    for (long long q = (long long)s * L + t; q < (long long)steps * L; q += blockDim.x) o[q] = 0;
  }
}

// The kernels, by variant: 0 the general path; 1-4 the generic warp path
// (1 + 2 (LPT - 1) + ONE); 5-8 one-row REG (5 + 2 (LPT - 1) + (N == 7));
// 9-16 one-row BITMAP (9 + 4 (LPT - 1) + log2 N).
constexpr int N_VARIANTS = 17;

const void* kernel_of(int v) {
  switch (v) {
    case 1: return (const void*)plane_decode_warp<1, false>;
    case 2: return (const void*)plane_decode_warp<1, true>;
    case 3: return (const void*)plane_decode_warp<2, false>;
    case 4: return (const void*)plane_decode_warp<2, true>;
    case 5: return (const void*)plane_decode_row<1, true, 3>;
    case 6: return (const void*)plane_decode_row<1, true, 7>;
    case 7: return (const void*)plane_decode_row<2, true, 3>;
    case 8: return (const void*)plane_decode_row<2, true, 7>;
    case 9: return (const void*)plane_decode_row<1, false, 1>;
    case 10: return (const void*)plane_decode_row<1, false, 2>;
    case 11: return (const void*)plane_decode_row<1, false, 4>;
    case 12: return (const void*)plane_decode_row<1, false, 8>;
    case 13: return (const void*)plane_decode_row<2, false, 1>;
    case 14: return (const void*)plane_decode_row<2, false, 2>;
    case 15: return (const void*)plane_decode_row<2, false, 4>;
    case 16: return (const void*)plane_decode_row<2, false, 8>;
    default: return (const void*)plane_decode_cta;
  }
}

// The variant for a launch's descriptors
int variant_of(const Params& P, int warp, int lpt) {
  if (!warp) return 0;
  const Read& rd = P.rd[0];
  if (P.R == 1 && rd.rows == 1 && rd.alph <= 256) {
    if (rd.kind == KIND_REG) return 5 + 2 * (lpt - 1) + (rd.alph > 4);
    const int e = (rd.alph + 31) >> 5;
    return 9 + 4 * (lpt - 1) + (e > 1) + (e > 2) + (e > 4);
  }
  return 1 + 2 * (lpt - 1) + (P.R == 1);
}

constexpr int MAX_DEV = 64;
int smem_set[N_VARIANTS][MAX_DEV];  // the dynamic shared bytes each kernel was allowed

// raise a kernel's dynamic shared-memory limit to `bytes` once
cudaError_t allow_smem(int v, int bytes, int device) {
  int* set = device >= 0 && device < MAX_DEV ? &smem_set[v][device] : nullptr;
  if (bytes <= 48 * 1024 || (set && *set >= bytes)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel_of(v), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && set) *set = bytes;
  return e;
}

// A launch's fields (see nlzm_plane_decode) into P; the kernel variant,
// threads a CTA and shared bytes, or -1 where the fields are out of range.
int parse_fields(const long long* f, Params& P, int& threads, int& smem) {
  P = Params{};
  for (int r = 0; r < MAX_R; ++r) {
    const long long* g = f + 9 * r;
    Read& rd = P.rd[r];
    rd.prior = reinterpret_cast<const int*>(g[0]);
    rd.out = reinterpret_cast<int*>(g[1]);
    rd.alph = (int)g[2];
    rd.rows = (int)g[3];
    rd.kind = (int)g[4];
    rd.car = (int)g[5];
    rd.cnt = (int)g[6];
    rd.tab = (int)g[7];
    rd.stride = (int)g[8];
  }
  const long long* h = f + 9 * MAX_R;
  P.seeds = reinterpret_cast<const unsigned*>(h[0]);
  P.wins = reinterpret_cast<const int*>(h[1]);
  P.n_sym = reinterpret_cast<const int*>(h[2]);
  P.ctx = reinterpret_cast<const int*>(h[3]);
  const long long* v = h + 4;
  P.B = (int)v[0];
  P.L = (int)v[1];
  P.R = (int)v[2];
  P.steps = (int)v[3];
  P.NC = (int)v[4];
  P.WH = (int)v[5];
  P.is_dst = (int)v[6];
  P.ncopy = (int)v[7];
  P.slot = (int)v[8];
  P.ctx_at = (int)v[9];
  P.vec_win = (int)v[10];
  P.vec_ctx = (int)v[11];
  P.vec_out = (int)v[12];
  const int warp = (int)v[13], lpt = (int)v[14];
  smem = (int)v[15];
  static_assert(9 * MAX_R + 4 + 16 == PD_FIELDS, "field count");
  if (P.R < 1 || P.R > MAX_R || P.L < 1 || P.L > 1024 || P.WH < 1 || P.steps < 1 ||
      (warp && (lpt < 1 || lpt > 2 || P.L > 32 * lpt || P.ncopy < 1 || P.slot < P.ncopy)))
    return -1;
  for (int r = 0; r < P.R; ++r) {
    const Read& rd = P.rd[r];
    if (rd.alph < 1 || rd.rows < 1 || (warp && rd.alph > CDF_TOTAL) ||
        (warp && (rd.kind < KIND_REG || rd.kind > KIND_SEARCH ||
                  (rd.kind == KIND_REG && (P.R != 1 || rd.rows != 1 || rd.alph > 8)))))
      return -1;
  }
  threads = warp ? 32 : (P.L + 31) / 32 * 32;
  return variant_of(P, warp, lpt);
}

}  // namespace

// fields [PD_FIELDS] i64, read on the host: per read r < 8 at 9 r: prior
// pointer (or 0), output pointer, alph, rows, kind, carries, counts,
// tables, table row stride (bytes into shared memory; warp path); then
// seeds [B, L] u32, wins [NC, B, WH] i32, n_sym [B] i32, ctx [B, steps *
// L] i32 pointers; B, L, R, steps, NC, WH, is_dst, ncopy, slot, ctx_at,
// vec_win, vec_ctx, vec_out, warp, lanes a thread, smem_bytes.
NLZM_API int nlzm_plane_decode(const void* fields, int device, void* stream) {
  cudaSetDevice(device);
  Params P;
  int threads = 0, smem = 0;
  const int v = parse_fields(static_cast<const long long*>(fields), P, threads, smem);
  if (P.B == 0) return 0;
  if (v < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(v, smem, device);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&P};
  e = cudaLaunchKernel(kernel_of(v), dim3(P.B), dim3(threads), args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

// The launch shape of these fields, for reports: out[0..5] (host ints) =
// the kernel variant, threads a CTA, static shared bytes, registers a
// thread, resident CTAs an SM at the fields' dynamic shared bytes, SMs.
NLZM_API int nlzm_pd_shape(const void* fields, void* out, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  Params P;
  int threads = 0, smem = 0;
  const int v = parse_fields(static_cast<const long long*>(fields), P, threads, smem);
  if (v < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(v, smem, device);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel_of(v));
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel_of(v), threads, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int o[6] = {v, threads, (int)attr.sharedSizeBytes, attr.numRegs, ctas, sms};
  for (int i = 0; i < 6; ++i) static_cast<int*>(out)[i] = o[i];
  return 0;
}
