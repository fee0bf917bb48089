// Fused rANS decode of the five wide-profile symbol planes.
//
// Replaces nlzm_tpu/ops/wide_decode.py::plane_scan_fused (with _seg_ranks
// and _build_cdf_jnp). On the TPU every step was a dozen dispatched tensor
// ops: grouped fence compares, one-hot MXU selects standing in for
// gathers, a cumsum for the renorm ranks.
//
// Bound: the latency of each lane's serial step chain (a few hundred steps
// per block, each dependent on the last), not bytes or operations: a
// block's whole stream is a few KB. The five planes share nothing (a
// plane's renorm ranks, window cursor, counts and tables are its own), so
// the design keeps each step's chain short and the planes apart:
// - One CTA of one warp per (block, plane): grid [B, 5], no barrier wider
//   than __syncwarp. Slot order tok|len|dst|lit|lex for the seeds and
//   priors. A 64-lane plane (tok, lit) gives thread t the adjacent lanes
//   2t and 2t + 1, two independent chains; lex uses threads 0-15. A
//   lane's renorm rank is the popc of its plane's ballots below it.
// - A plane decodes only its live steps, ceil(n_sym / L) clamped to
//   0..steps, rebuilds its tables only while steps remain, then fills the
//   rest of its output with zeros (16-byte stores).
// - The renorm pairs come from shared memory: the plane's warp copies each
//   chunk's window row wins[p][c, b, 0:min(WH_p, 8 L_p)] (a chunk of at
//   most 8 steps renormalises at most 8 L_p times) RING - 1 chunks ahead
//   into a ring of 8 L_p-int slots (cp.async, 16 bytes a copy when the rows
//   allow it, else 4). Every lane loads its pair from the ring with no
//   branch, clamp or check in the step: a chunk's pair indices are
//   0..n - 1 for its n renorms, so the chunk was exact unless n passed the
//   copied row. If it did (only a corrupt stream gets there), the chunk
//   runs again from its saved states, and a pair index past the row reads
//   JAX's index from device memory: the chunk's five rows concatenated in
//   wire order and zero-padded to a multiple of 64, the index clamped to
//   its end.
// - Symbol search without a loop: tok's 3 and len's 7 fences in registers
//   (every lane holds the whole table). dst, lit and lex keep a bitmap of
//   their fences over the 2^14 CDF values, each 32-bit word beside the
//   count of fences before it: a symbol is that count plus the popc of the
//   word's bits up to f, one 64-bit shared load; its span (start | freq <<
//   16) is a second.
// - Counts, off the chain: tok and len in 8-bit register fields, summed by
//   redux.sync; dst, lit and lex keep a lane's symbols in a 64-bit register
//   and add them with shared atomics at the end of the chunk (at most 8
//   steps at a time), not behind each step's loads.
// - Rebuild, by the plane's warp alone: carry = (carry >> 1) + counts in
//   registers (a lane holds alph / 32 adjacent entries, or the whole table
//   for tok and len), freq = 1 + carry * (2^14 - alph) / (tot + 1) with
//   the quotient a multiply-high by floor((2^32 - 1) / (tot + 1)) and one
//   correction (exact: priors are u16 and a chunk adds at most 8 L_p, so
//   carry <= 65535 and the dividend < 2^30), one warp scan, the last fence
//   pinned at 2^14; then the bitmap by atomicOr and its word counts by a
//   second scan (a lane 16 adjacent words, two words of padding every 16 so
//   that 16-byte accesses of a quarter warp share no bank).
// - The lane state is u32 with wraparound, exactly as the JAX decoder.
// Build option, for scan_compare.py's split of the time only:
// NLZM_PS_ONLY=mask (only the CTAs of the slots in the bit mask run; the
// other planes' outputs are left unwritten).
#include "common.cuh"

namespace {

constexpr int NP = 5;
constexpr int LTOT = 208;
constexpr int MAX_CLEN = 8;  // format/wide.py CHUNK_STEPS: the longest chunk
constexpr int RING = 4;      // ring slots; windows are copied RING - 1 chunks ahead
constexpr int NWORD = CDF_TOTAL / 32;     // fence bitmap words
constexpr int NTB = NWORD + NWORD / 8;   // with two words of padding every 16
constexpr unsigned FULL = 0xffffffffu;
// wire order tok, lit, len, lex, dst
constexpr int WIRE_LANES[NP] = {64, 64, 32, 16, 32};

// slot order tok|len|dst|lit|lex: lanes, alphabet, wire plane, first seed
// lane, first prior entry
template <int Q>
struct Slot;
template <>
struct Slot<0> { static constexpr int L = 64, A = 4, P = 0, LANE0 = 0, SYM0 = 0; };
template <>
struct Slot<1> { static constexpr int L = 32, A = 8, P = 2, LANE0 = 64, SYM0 = 4; };
template <>
struct Slot<2> { static constexpr int L = 32, A = 64, P = 4, LANE0 = 96, SYM0 = 12; };
template <>
struct Slot<3> { static constexpr int L = 64, A = 256, P = 1, LANE0 = 128, SYM0 = 76; };
template <>
struct Slot<4> { static constexpr int L = 16, A = 256, P = 3, LANE0 = 192, SYM0 = 332; };

struct Args {
  const unsigned* seeds;  // [B, 208] slot order
  const int* n_syms;      // [B, 5] wire order
  const int* sched;       // [NC] chunk lengths
  const int* priors;      // [588] slot order, or null
  int B, NC, steps;
};

struct Planes {
  const int* win[NP];  // wire order, [NC, B, WH_p] renorm windows
  int* out[NP];        // wire order, [B, steps * L_p] symbols
  int wh[NP];
  int base[NP];    // plane p's first column in JAX's concatenation
  int whc;         // its width, zero-padded to a multiple of 64
  int ncopy[NP];   // ints of a chunk's row copied to the ring: min(WH_p, 8 L_p)
  int vec[NP];     // rows 16-byte aligned: 16-byte copies
  int out_vec;     // outputs 16-byte aligned: vector stores
};

// dst, lit and lex: spans (start | freq << 16), the fence bitmap (word w at
// tb_index(w): fences before it << 32 | its bits) and the chunk's counts
struct __align__(16) Tables {
  unsigned span[256];
  unsigned long long tb[NTB];
  int cnt[256];
};

__device__ __forceinline__ int tb_index(int w) { return w + 2 * (w >> 4); }

// a lane's E adjacent ints at p (E = 2 or a multiple of 4; p aligned to
// their size), in 8- or 16-byte accesses
template <int E>
__device__ __forceinline__ void load_row(const int* p, int (&v)[E]) {
  if constexpr (E == 2) {
    const int2 w = *reinterpret_cast<const int2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const int4 w = *reinterpret_cast<const int4*>(p + i);
      v[i] = w.x;
      v[i + 1] = w.y;
      v[i + 2] = w.z;
      v[i + 3] = w.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_row(int* p, const int (&v)[E]) {
  if constexpr (E == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      *reinterpret_cast<int4*>(p + i) = make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// the tag of a chunk's pass: FAST (pairs from the ring only) or exact
template <bool B>
struct Mode {
  static constexpr bool value = B;
};

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

// floor(n / d) for n < 2^31 from m = floor((2^32 - 1) / d): n * m / 2^32
// lies in (n / d - 1/2, n / d], so the multiply-high is exact or one short
__device__ __forceinline__ unsigned quot(unsigned n, unsigned d, unsigned m) {
  unsigned q = __umulhi(n, m);
  if (n - q * d >= d) ++q;
  return q;
}

// chunk c's row of wire plane p into a ring slot
template <int p>
__device__ __forceinline__ void fetch(const Planes& P, int* dst, int c, int b, int B) {
  const int n = P.ncopy[p];
  const int* row = P.win[p] + ((long long)c * B + b) * P.wh[p];
  if (P.vec[p]) {
    for (int k = 4 * threadIdx.x; k < n; k += 128) cp_async16(dst + k, row + k);
  } else {
    for (int k = threadIdx.x; k < n; k += 32) cp_async4(dst + k, row + k);
  }
}

// JAX's pair: column g of chunk c's five rows concatenated in wire order and
// zero-padded, g clamped to the last column
__device__ __forceinline__ int cat_pair(const Planes& P, int c, int b, int B, int g) {
  g = min(g, P.whc - 1);
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (g >= P.base[q] && g < P.base[q] + P.wh[q])
      return P.win[q][((long long)c * B + b) * P.wh[q] + (g - P.base[q])];
  }
  return 0;
}

// dst, lit and lex: spans and fence bitmap from the fences; start holds
// fences lane * E .. lane * E + E - 1
template <int A, int E>
__device__ __forceinline__ void set_tables(Tables& T, const int (&start)[E]) {
  const int lane = threadIdx.x;
  const int next0 = __shfl_down_sync(FULL, start[0], 1);
  int sp[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane * E + e;
    const int end = k == A - 1 ? CDF_TOTAL : (e + 1 < E ? start[e + 1] : next0);
    sp[e] = start[e] | (end - start[e]) << 16;
  }
  store_row<E>(reinterpret_cast<int*>(T.span) + lane * E, sp);
  ulonglong2* tb2 = reinterpret_cast<ulonglong2*>(T.tb);
  for (int i = lane; i < NTB / 2; i += 32) tb2[i] = make_ulonglong2(0, 0);
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {  // fences 1..A-1, each at its own value
    if (lane * E + e >= 1)
      atomicOr(reinterpret_cast<unsigned*>(&T.tb[tb_index(start[e] >> 5)]),  // the low word
               1u << (start[e] & 31));
  }
  __syncwarp();
  // 16 adjacent words a lane, at tb_index(16 lane) = 18 lane, 16 bytes at a
  // time (no two lanes of a quarter warp on one bank)
  constexpr int PER = NWORD / 32;
  unsigned bits[PER];
  int loc = 0;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const ulonglong2 w = tb2[lane * (PER + 2) / 2 + i / 2];
    bits[i] = (unsigned)w.x;
    bits[i + 1] = (unsigned)w.y;
    loc += __popc(bits[i]) + __popc(bits[i + 1]);
  }
  int run = warp_inclusive_sum(loc) - loc;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const int r1 = run + __popc(bits[i]);
    tb2[lane * (PER + 2) / 2 + i / 2] = make_ulonglong2(
        (unsigned long long)run << 32 | bits[i], (unsigned long long)r1 << 32 | bits[i + 1]);
    run = r1 + __popc(bits[i + 1]);
  }
  __syncwarp();
}

// dst, lit and lex: spans and fence bitmap from the carries
template <int A, int E>
__device__ __forceinline__ void build_large(Tables& T, const int (&car)[E]) {
  int sum = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) sum += car[e];
  const unsigned d = __reduce_add_sync(FULL, (unsigned)sum) + 1u, m = FULL / d;
  int fr[E], loc = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    fr[e] = 1 + (int)quot((unsigned)car[e] * (CDF_TOTAL - A), d, m);
    loc += fr[e];
  }
  int run = warp_inclusive_sum(loc) - loc;
  int start[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    start[e] = run;
    run += fr[e];
  }
  set_tables<A, E>(T, start);
}

// tok and len: fences 1..A-1 from the carries, on every lane
template <int A>
__device__ __forceinline__ void build_small(int (&fen)[A], const int (&car)[A]) {
  int tot = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) tot += car[k];
  const unsigned d = (unsigned)tot + 1u, m = FULL / d;
  int run = 0;
#pragma unroll
  for (int k = 0; k + 1 < A; ++k) {
    run += 1 + (int)quot((unsigned)car[k] * (CDF_TOTAL - A), d, m);
    fen[k + 1] = run;
  }
}

// tok and len: add the packed 8-bit counts of the whole warp into cnt
template <int A>
__device__ __forceinline__ void flush_small(int (&cnt)[A], unsigned long long& pk) {
#pragma unroll
  for (int w = 0; w < A / 4; ++w) {
    const unsigned v = (unsigned)(pk >> (32 * w));
    const unsigned ev = __reduce_add_sync(FULL, v & 0x00FF00FFu);
    const unsigned od = __reduce_add_sync(FULL, (v >> 8) & 0x00FF00FFu);
    cnt[4 * w] += (int)(ev & 0xFFFFu);
    cnt[4 * w + 1] += (int)(od & 0xFFFFu);
    cnt[4 * w + 2] += (int)(ev >> 16);
    cnt[4 * w + 3] += (int)(od >> 16);
  }
  pk = 0;
}

template <int Q>
__device__ __forceinline__ void scan_plane(const Args& g, const Planes& P, int* ring, Tables& T) {
  using S = Slot<Q>;
  constexpr int L = S::L, A = S::A, p = S::P;
  constexpr int LPT = L >= 64 ? 2 : 1;  // lanes a thread
  constexpr bool SMALL = A <= 8;
  constexpr int E = SMALL ? A : A / 32;  // table entries a lane holds
  const int b = blockIdx.x, t = threadIdx.x;
  const bool has = t * LPT < L;
  const unsigned lt = (1u << t) - 1u;

  const int nsym = g.n_syms[b * NP + p];
  const int live = nsym <= 0 ? 0 : min(g.steps, (nsym - 1) / L + 1);
  // lanes that decode at the last live step
  const int last_n = live ? (int)min((long long)L, (long long)nsym - (long long)(live - 1) * L)
                          : 0;
  int* outp = P.out[p] + (long long)b * g.steps * L;
  // a ring slot holds the 8 L pair indices a chunk of at most MAX_CLEN steps
  // can reach
  constexpr int SLOT = MAX_CLEN * L;
  const int ncopy = P.ncopy[p], nlast = max(ncopy - 1, 0);

  // the first chunks' windows, while the tables are built
  for (int k = 0; k < RING - 1; ++k) {
    if (live > 0 && k < g.NC) fetch<p>(P, ring + k * SLOT, k, b, g.B);
    cp_async_commit();
  }

  unsigned x[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) x[j] = has ? g.seeds[b * LTOT + S::LANE0 + t * LPT + j] : 0u;

  int car[E];
  int fen[SMALL ? A : 1];
  int cnt[SMALL ? A : 1];
  unsigned long long pk = 0;   // tok, len: 8-bit counts of this thread's lanes
  unsigned long long sb[LPT] = {};  // dst, lit, lex: a lane's last symbols, a byte each
  int nbuf = 0;                // steps held in pk or sb
  // add the held symbols to the chunk's counts
  auto flush = [&]() {
    if constexpr (SMALL) {
      flush_small<A>(cnt, pk);
    } else if (has) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
#pragma unroll
        for (int k = 0; k < MAX_CLEN; ++k) {
          if (k < nbuf) atomicAdd(&T.cnt[(sb[j] >> (8 * k)) & 0xFF], 1);
        }
      }
    }
    pk = 0;
    nbuf = 0;
  };
  if constexpr (SMALL) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      car[k] = g.priors ? g.priors[S::SYM0 + k] : 0;
      cnt[k] = 0;
    }
    if (g.priors) {
      build_small<A>(fen, car);
    } else {
#pragma unroll
      for (int k = 1; k < A; ++k) fen[k] = k * (CDF_TOTAL / A);
    }
  } else if (live > 0) {
    int zero[E] = {};
    store_row<E>(T.cnt + t * E, zero);
#pragma unroll
    for (int e = 0; e < E; ++e) car[e] = g.priors ? g.priors[S::SYM0 + t * E + e] : 0;
    if (g.priors) {
      build_large<A, E>(T, car);
    } else {
      int start[E];
#pragma unroll
      for (int e = 0; e < E; ++e) start[e] = (t * E + e) * (CDF_TOTAL / A);
      set_tables<A, E>(T, start);
    }
  }

  int s = 0;
  int clen_next = (live > 0 && g.NC > 0) ? g.sched[0] : 0;
  for (int c = 0; c < g.NC && s < live; ++c) {
    const int clen = clen_next;
    if (c + 1 < g.NC) clen_next = g.sched[c + 1];
    if (c + RING - 1 < g.NC)
      fetch<p>(P, ring + ((c + RING - 1) % RING) * SLOT, c + RING - 1, b, g.B);
    cp_async_commit();
    cp_async_wait<RING - 1>();
    __syncwarp();
    const int* win = ring + (c % RING) * SLOT;
    int rel = 0;  // the window cursor restarts every chunk

    // The chunk's steps. FAST reads every pair from the ring; the chunk's
    // pair indices are 0..rel - 1, so it was exact unless rel > ncopy at
    // the end, and then the chunk runs again reading JAX's index past the
    // ring (a corrupt stream, or a chunk longer than MAX_CLEN, which also
    // adds its counts every MAX_CLEN steps).
    auto run = [&](auto fast_tag) {
      constexpr bool FAST = decltype(fast_tag)::value;
      for (int i = 0; i < clen && s < live; ++i, ++s) {
        const bool all = s < live - 1;
        int y[LPT];
        unsigned x2[LPT];
        bool act[LPT], ren[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const int f = (int)(x[j] & 0x3FFFu);
          int st, fr;
          if constexpr (SMALL) {
            int yy = 0, lo = 0, hi = CDF_TOTAL;
#pragma unroll
            for (int k = 1; k < A; ++k) {
              const bool ge = f >= fen[k];
              yy += ge;
              lo = ge ? fen[k] : lo;
            }
#pragma unroll
            for (int k = A - 1; k >= 1; --k) hi = f < fen[k] ? fen[k] : hi;
            y[j] = yy;
            st = lo;
            fr = hi - lo;
          } else {
            const unsigned long long wd = T.tb[tb_index(f >> 5)];
            y[j] = (int)(wd >> 32) + __popc((unsigned)wd & ((2u << (f & 31)) - 1u));
            const unsigned sp = T.span[y[j]];
            st = (int)(sp & 0xFFFFu);
            fr = (int)(sp >> 16);
          }
          x2[j] = (unsigned)fr * (x[j] >> 14) + (unsigned)(f - st);
          act[j] = has && (all || t * LPT + j < last_n);
          ren[j] = act[j] && x2[j] < 65536u;
        }
        int h = rel;
        int total = 0;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          const unsigned mj = __ballot_sync(FULL, ren[j]);
          h += __popc(mj & lt);
          total += __popc(mj);
        }
        // lane j's pair index is h + (renorms of this thread's lower lanes)
        int hj[LPT], pair[LPT];
        bool far = false;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          hj[j] = j ? hj[j - 1] + ren[j - 1] : h;
          pair[j] = win[FAST ? hj[j] : min(hj[j], nlast)];
          far |= ren[j] && hj[j] >= ncopy;
        }
        if constexpr (!FAST) {
          if (__any_sync(FULL, far)) {
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              if (ren[j] && hj[j] >= ncopy) pair[j] = cat_pair(P, c, b, g.B, P.base[p] + hj[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          x[j] = ren[j] ? (x2[j] << 16) | (unsigned)pair[j] : (act[j] ? x2[j] : x[j]);
          if constexpr (SMALL) {
            pk += 1ull << (8 * y[j]);
          } else {
            sb[j] = sb[j] << 8 | (unsigned)y[j];
          }
          if (!act[j]) y[j] = 0;
        }
        rel += total;
        if (has) {
          int* o = outp + (long long)s * L + t * LPT;
          if constexpr (LPT == 2) {
            if (P.out_vec) {
              *reinterpret_cast<int2*>(o) = make_int2(y[0], y[1]);
            } else {
              o[0] = y[0];
              o[1] = y[1];
            }
          } else {
            o[0] = y[0];
          }
        }
        ++nbuf;
        if constexpr (!FAST) {
          if (nbuf == MAX_CLEN && s + 1 < live) flush();
        }
      }
    };
    if (clen <= MAX_CLEN) {
      unsigned x0[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) x0[j] = x[j];
      const int s0 = s;
      run(Mode<true>{});
      if (rel > ncopy) {  // warp-uniform
#pragma unroll
        for (int j = 0; j < LPT; ++j) x[j] = x0[j];
        s = s0;
        rel = 0;
        pk = 0;
        nbuf = 0;
        run(Mode<false>{});
      }
    } else {
      run(Mode<false>{});
    }
    if (s < live) {  // the tables of the next chunk
      // every step before the last live one decodes on every lane
      flush();
      if constexpr (SMALL) {
#pragma unroll
        for (int k = 0; k < A; ++k) {
          car[k] = (car[k] >> 1) + cnt[k];
          cnt[k] = 0;
        }
        build_small<A>(fen, car);
      } else {
        __syncwarp();  // every count of the chunk is in, every search done
        int cn[E], zero[E] = {};
        load_row<E>(T.cnt + t * E, cn);
        store_row<E>(T.cnt + t * E, zero);
#pragma unroll
        for (int e = 0; e < E; ++e) car[e] = (car[e] >> 1) + cn[e];
        build_large<A, E>(T, car);
      }
    }
    __syncwarp();  // the ring slot of chunk c is free
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // steps past the decoded ones emit 0
  const long long from = (long long)s * L, to = (long long)g.steps * L;
  if (P.out_vec) {
    for (long long k = from + 4 * t; k < to; k += 128)
      *reinterpret_cast<int4*>(outp + k) = make_int4(0, 0, 0, 0);
  } else {
    for (long long k = from + t; k < to; k += 32) outp[k] = 0;
  }
}

__global__ void __launch_bounds__(32) plane_scan_kernel(Args g, Planes P) {
  __shared__ __align__(16) int ring[RING * MAX_CLEN * 64];
  __shared__ Tables T;
#ifdef NLZM_PS_ONLY
  if (!((NLZM_PS_ONLY >> blockIdx.y) & 1)) return;
#endif
  switch (blockIdx.y) {
    case 0: scan_plane<0>(g, P, ring, T); break;
    case 1: scan_plane<1>(g, P, ring, T); break;
    case 2: scan_plane<2>(g, P, ring, T); break;
    case 3: scan_plane<3>(g, P, ring, T); break;
    default: scan_plane<4>(g, P, ring, T); break;
  }
}

// The windows' layout: widths, JAX's concatenation, the ints a chunk
// copies to the ring.
void window_layout(Planes& P, const int* wh) {
  int col = 0;
  for (int q = 0; q < NP; ++q) {
    P.wh[q] = wh[q];
    P.base[q] = col;
    col += wh[q];
    P.ncopy[q] = wh[q] < MAX_CLEN * WIRE_LANES[q] ? wh[q] : MAX_CLEN * WIRE_LANES[q];
    if (P.ncopy[q] < 0) P.ncopy[q] = 0;
  }
  P.whc = (col + 63) / 64 * 64;
}

}  // namespace

// seeds [B, 208] u32, slot order; n_syms [B, 5] i32, wire order; sched
// [NC] i32 chunk lengths (sum = steps, each at most 8); priors [588] i32 in
// slot order, each in 0..65535, or null for uniform initial tables; win_p
// [NC, B, WH_p] i32; out_p [B, steps * L_p] i32.
NLZM_API int nlzm_plane_scan(const void* seeds, const void* n_syms, const void* sched,
                             const void* priors, const void* win0, const void* win1,
                             const void* win2, const void* win3, const void* win4, void* out0,
                             void* out1, void* out2, void* out3, void* out4, int B, int NC,
                             int steps, int wh0, int wh1, int wh2, int wh3, int wh4, int device,
                             void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  const int wh[NP] = {wh0, wh1, wh2, wh3, wh4};
  const void* wins[NP] = {win0, win1, win2, win3, win4};
  void* outs[NP] = {out0, out1, out2, out3, out4};
  Planes P;
  window_layout(P, wh);
  P.out_vec = 1;
  for (int q = 0; q < NP; ++q) {
    P.win[q] = (const int*)wins[q];
    P.out[q] = (int*)outs[q];
    P.vec[q] = ((uintptr_t)wins[q] % 16 == 0) && (wh[q] % 4 == 0);
    if ((uintptr_t)outs[q] % 16 != 0) P.out_vec = 0;
  }
  const Args g{(const unsigned*)seeds, (const int*)n_syms, (const int*)sched, (const int*)priors,
               B, NC, steps};
  plane_scan_kernel<<<dim3(B, NP), 32, 0, (cudaStream_t)stream>>>(g, P);
  return launch_status();
}

// The launch shape, for reports: out[0..4] (host ints) = threads a CTA,
// shared bytes a CTA, registers a thread, resident CTAs an SM, SMs. The
// grid is B x 5 CTAs.
NLZM_API int nlzm_ps_shape(void* out, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  cudaFuncAttributes attr = {};
  cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)plane_scan_kernel);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)plane_scan_kernel, 32,
                                                      0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[5] = {32, (int)attr.sharedSizeBytes, attr.numRegs, ctas, sms};
  for (int i = 0; i < 5; ++i) ((int*)out)[i] = v[i];
  return 0;
}
