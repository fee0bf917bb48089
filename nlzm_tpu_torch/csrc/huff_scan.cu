// Batched canonical-Huffman decode of the huff0 block container: T symbols
// a block, 14-bit code length limit, left-justified tables.
//
// Replaces nlzm_tpu/research/huff0.py::_huff_scan_body. On the TPU every
// step was a dozen tensor ops over [B]: a 3-word window gather, 14 dense
// limit compares, one-hot selects of the length's base and offset and a
// one-hot contraction over the 256-entry symbol table.
//
// What a step computes. JAX refills a 22-bit window with up to two bytes a
// step and peeks at its top 14 bits: that is exactly the 14 bits at bit
// offset cb (the lengths decoded so far) of the stream, where byte q is
// byte q & 3 of u32 word min(q >> 2, W - 1) of the row zero-padded to W =
// ceil(S / 4) words. L = clip(1 + #{l : peek >= limit_l[l]}, 1, 14) and
// the symbol is syms[clip(offs[L] + ((peek - base_l[L]) >> (14 - L)), 0,
// 255)], the index arithmetic in wrapping int32 as JAX's.
//
// Bound: one thread walking a block's T steps was a chain of dependent
// loads (~250 ns a step at 32 KiB blocks); the bytes moved (streams in,
// symbols out) bound the card at ~0.004 ms for 8 MB, the table decode's
// ~10 operations a symbol less. Design: split the chain.
// The decode is a function of the bit offset alone and a codeword is at
// most 14 bits, so a chain enters a span of K bits at one of 14 offsets
// past its start (its entry) and leaves it at one of 14 past its end (its
// exit). A span's map takes each entry to (exit, count), and maps compose
// exactly. Per block, one CTA of NT threads (1024 when every block has an
// SM of its own, else 512, two CTAs an SM):
// - finds E, the first bit past which every word the decode reads is word
//   W - 1 (the zero padding of a short block's row ends there too), so the
//   bits from E repeat with period 32 and a step past E depends on cb mod
//   32 alone;
// - builds a 2^14-entry decode table peek -> (symbol, L) in shared memory;
// - stages the row's bits [0, min(E, 14 T)) (the first T codewords start
//   below 14 T) as big-endian u32 words in shared memory, a page at a time
//   (a step reads two words and funnel-shifts), and cuts the page into at
//   most NT spans of K = 32 KW bits, KW the least odd count of words, at
//   least KW_MIN, that does it (odd: neighbouring threads' spans start in
//   other banks; at least KW_MIN: chains that start apart meet within a
//   span, ~9 codewords on the corpus; NLZM_HUFF_KW fixes it, for
//   comparison);
// - phase A: each thread runs its span's chain from entry 0 and marks its
//   codeword starts in the page's mark bits; then, from e1, the entry the
//   span most likely has (the previous span's entry-0 exit; the carried
//   entry for the first), a chain that stops where it lands on a mark: the
//   chains agree from there, so its count is its steps plus the marks from
//   there on;
// - phase B: each span's true entry and first output index. The spans
//   fall into NT / 14 chunks. A thread a chunk walks it from its likely
//   entry (its first span's e1), recording its entry at every span (nibble
//   x of the span's path word for a walk from x). One thread walks the
//   chunks while their guesses hold. From the first chunk entered off its
//   guess, a thread for each later chunk and each other entry walks the
//   chunk from there, so those chunks' maps are whole and one thread walks
//   the rest. Each span then reads its true entry from its path word and
//   its count there, and a block scan of the counts gives the first output
//   indices. A map entry phase A did not compute is computed where it is
//   needed, from the marks, as phase A computes e1's: on codes whose chains
//   never merge (7-bit data, where K is no multiple of 7) that is a whole
//   span's decode, so no thread walks more than one chunk from one entry;
// - phase C: each span decodes again from its true entry and writes its
//   symbols below T, a 4-byte store where it owns the whole word;
// - the tail: a block still short of T at E walks 64 residues from its
//   entry, and the cycle (its length the first return to the 32nd residue)
//   fills the rest of the row in parallel.
// Phase A's work grows with the row's bits, never with T. Every address
// the data decides is clamped: the stream word (to W - 1, in staging), the
// symbol index (0..255), the output index (below T); shared reads stay in
// the staged page by construction (p < the page's bits).
#include "common.cuh"

#ifndef NLZM_HUFF_KW
#define NLZM_HUFF_KW 0  // words a span; 0: the least odd count >= KW_MIN giving <= NT spans
#endif
#ifndef NLZM_HUFF_THREADS
#define NLZM_HUFF_THREADS 0  // 512 or 1024: the CTA's threads whatever B
#endif

namespace {

constexpr int LIMIT = 14;
constexpr int KW_MIN = 9;  // words a span at least: 288 bits
constexpr int TAB_BYTES = 2 << LIMIT;  // u16 a peek
constexpr int SPAN_BYTES = 20;  // m0 | m1 << 16, e1 | entry << 8, first output index, path
constexpr int WORD_BYTES = 8;   // a page word: the row and its marks
static_assert(NLZM_HUFF_KW == 0 || 32 * NLZM_HUFF_KW < 4096, "a span's count fits 12 bits");

// A CTA of NT threads: 512 with two CTAs an SM (dynamic shared bytes with
// the ~1.8 KB static part under half the SM's), or 1024 alone on an SM.
template <int NT>
struct Shape {
  static constexpr int SMEM = NT == 512 ? 108 * 1024 : 216 * 1024;
  static constexpr int WORDS = (SMEM - TAB_BYTES - NT * SPAN_BYTES - 16) / WORD_BYTES - 2;
  // bits a page: at most NT spans
  static constexpr int PAGE = 32 * (NLZM_HUFF_KW && NLZM_HUFF_KW * NT < WORDS ? NLZM_HUFF_KW * NT
                                                                               : WORDS);
  static_assert(PAGE < 4096 * NT, "a span's count fits 12 bits");
};

struct Small {
  int base[LIMIT + 1], off[LIMIT + 1], lim[LIMIT + 1], sorted[LIMIT];
  unsigned char cx[1024 / LIMIT * LIMIT];  // chunk c's exit at entry x: cx[c * 14 + x]
  unsigned char cent[1024 / LIMIT];        // each chunk's true entry
  unsigned wsum[32];                       // the block scan's warp sums
  int fail, xfail;  // the first chunk entered off its guess; the walk's entry there, then its exit
  long long nout;  // symbols before the carried entry
  int entry;       // the chain's entry into the next page
  int z;           // E / 32
  int lam;         // the tail's cycle length
  unsigned char pre[32], pat[32];
  unsigned char sym[256];  // syms & 255
};

// offs[L] + ((peek - base_l[L]) >> (14 - L)) in wrapping int32
__device__ __forceinline__ int sym_index(int off, int base, int peek, int L) {
  const int d = (int)((unsigned)peek - (unsigned)base);
  return (int)((unsigned)off + (unsigned)(d >> (LIMIT - L)));
}

// peek -> symbol | L << 8, from the decode table
struct Decoder {
  const uint16_t* tab;
  __device__ explicit Decoder(const uint16_t* t) : tab(t) {}
  __device__ __forceinline__ unsigned operator()(unsigned peek) const { return tab[peek]; }
};

// big-endian word i of the stream as the decode reads it: word min(i, W - 1)
// of the row, bytes at or past S zero
__device__ __forceinline__ unsigned vword(const uint8_t* row, int S, long long W, long long i) {
  const long long q = 4 * min(i, W - 1);
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) v = v << 8 | (q + k < S ? (unsigned)__ldg(row + q + k) : 0u);
  return v;
}

// consecutive bytes to global memory: a 4-byte store for a word whose four
// bytes this thread writes, byte stores at a range's ragged ends
struct Bytes {
  uint8_t* w;
  unsigned acc;
  int lo, hi;  // bytes lo..hi of word w are in acc
  __device__ explicit Bytes(uint8_t* p)
      : w(p - ((uintptr_t)p & 3)), acc(0), lo((int)((uintptr_t)p & 3)), hi(lo - 1) {}
  __device__ __forceinline__ void flush() {
    if (lo == 0 && hi == 3) {
      *reinterpret_cast<unsigned*>(w) = acc;
    } else {
      for (int k = lo; k <= hi; ++k) w[k] = (uint8_t)(acc >> (8 * k));
    }
  }
  __device__ __forceinline__ void put(unsigned v) {
    acc |= v << (8 * ++hi);
    if (hi == 3) {
      flush();
      w += 4;
      acc = 0;
      lo = 0;
      hi = -1;
    }
  }
  __device__ __forceinline__ void done() {
    if (hi >= lo) flush();
  }
};

// A page in shared memory: its row words and the marks of each span's
// entry-0 chain; per span its maps at entry 0 and at e1 (exit | count << 4),
// e1, its path word and, after phase B, its true entry and first output
// index.
struct Page {
  const unsigned* rw;
  unsigned* mark;
  unsigned* m;   // m0 | m1 << 16
  unsigned* e;   // e1 | entry << 8
  unsigned* at;  // first output index (at most T)
  unsigned long long* path;  // nibble x: the entry here of the chunk's walk from entry x
  int bits, K;

  __device__ __forceinline__ unsigned peek(int p) const {
    return __funnelshift_l(rw[(p >> 5) + 1], rw[p >> 5], p & 31) >> (32 - LIMIT);
  }
  __device__ __forceinline__ int len(int s) const { return min(K, bits - s * K); }

  // phase A's first chain: span s from entry 0, marking its starts; m0
  __device__ __forceinline__ unsigned chain0(int s, const Decoder& dec) const {
    const int a = s * K, n = len(s), w1 = (a + n + 31) >> 5;
    int q = 0, c = 0, w = a >> 5;
    unsigned cur = 0;
    while (q < n) {  // a step is < 32 bits: no word is skipped
      if (((a + q) >> 5) != w) {
        mark[w++] = cur;
        cur = 0;
      }
      cur |= 1u << (q & 31);
      ++c;
      q += dec(peek(a + q)) >> 8;
    }
    mark[w] = cur;
    while (++w < w1) mark[w] = 0;
    return (unsigned)(q - n) | (unsigned)c << 4;
  }

  // span s's map at entry x (exit | count << 4): the chain from x until it
  // ends or, after c steps, lands on a start of entry 0's chain at bit p;
  // from there on it is entry 0's chain: its exit, and its count less its
  // starts before p
  __device__ __forceinline__ unsigned map_at(int s, int x, const Decoder& dec) const {
    const unsigned m0 = m[s] & 0xFFFFu;
    if (!x) return m0;
    const int a = s * K, n = len(s);
    int q = x, c = 0;
    while (q < n) {
      const int p = a + q;
      if ((mark[p >> 5] >> (p & 31)) & 1u) {
        int before = __popc(mark[p >> 5] & ((1u << (p & 31)) - 1u));
        for (int w = a >> 5; w < p >> 5; ++w) before += __popc(mark[w]);
        return (m0 & 15u) | (unsigned)(c + (int)(m0 >> 4) - before) << 4;
      }
      ++c;
      q += dec(peek(p)) >> 8;
    }
    return (unsigned)(q - n) | (unsigned)c << 4;
  }

  // the map at entry x, from phase A's where it has it
  __device__ __forceinline__ unsigned map(int s, int x, const Decoder& dec) const {
    if (!x) return m[s] & 0xFFFFu;
    if (x == (int)(e[s] & 0xFFu)) return m[s] >> 16;
    return map_at(s, x, dec);
  }

  // spans [s0, s1) walked from entry x0, each span's entry on the way in
  // nibble x0 of its path word; the exit
  __device__ __forceinline__ int walk(int s0, int s1, int x0, const Decoder& dec) const {
    int x = x0;
    for (int s = s0; s < s1; ++s) {
      atomicOr(&path[s], (unsigned long long)x << (4 * x0));
      x = (int)(map(s, x, dec) & 15u);
    }
    return x;
  }
};

// phase B: every span's true entry and first output index (at most T); the
// page's exit and count carried in sh
template <int NT>
__device__ __forceinline__ void compose(const Page& pg, const Decoder& dec, Small& sh, int nsp,
                                        int T) {
  constexpr int NCH = NT / LIMIT;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int C = (nsp + NCH - 1) / NCH, nch = (nsp + C - 1) / C;
  // chunk c's likely entry: its first span's e1 (the carried entry for chunk 0)
  const auto guess = [&](int c) { return c ? (int)(pg.e[c * C] & 0xFFu) : sh.entry; };
  if (tid < nch) sh.cx[tid * LIMIT + guess(tid)] = (unsigned char)pg.walk(
      tid * C, min(tid * C + C, nsp), guess(tid), dec);
  __syncthreads();
  if (tid == 0) {  // the walk over the chunks while their guesses hold
    int x = sh.entry, c = 0;
    for (; c < nch && x == guess(c); ++c) {
      sh.cent[c] = (unsigned char)x;
      x = sh.cx[c * LIMIT + x];
    }
    sh.fail = c;
    sh.xfail = x;
  }
  __syncthreads();
  const int c0 = sh.fail;
  if (c0 < nch) {  // from the first chunk entered off its guess: every entry
    const int c = c0 + tid / LIMIT, x0 = tid % LIMIT;
    if (c < nch && x0 != guess(c))
      sh.cx[c * LIMIT + x0] = (unsigned char)pg.walk(c * C, min(c * C + C, nsp), x0, dec);
    __syncthreads();
    if (tid == 0) {
      int x = sh.xfail;
      for (int k = c0; k < nch; ++k) {
        sh.cent[k] = (unsigned char)x;
        x = sh.cx[k * LIMIT + x];
      }
      sh.xfail = x;
    }
    __syncthreads();
  }
  unsigned n = 0;  // each span's entry and its count there
  if (tid < nsp) {
    const int x = (int)(pg.path[tid] >> (4 * sh.cent[tid / C])) & 15;
    n = pg.map(tid, x, dec) >> 4;
    pg.e[tid] = (pg.e[tid] & 0xFFu) | (unsigned)x << 8;
  }
  unsigned v = n;  // the block's inclusive scan of the counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) sh.wsum[wp] = v;
  __syncthreads();
  if (wp == 0) {
    unsigned w = lane < NT / 32 ? sh.wsum[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < NT / 32) sh.wsum[lane] = w;
  }
  __syncthreads();
  if (tid < nsp)
    pg.at[tid] = (unsigned)min(sh.nout + (wp ? sh.wsum[wp - 1] : 0u) + v - n, (long long)T);
  __syncthreads();
  if (tid == 0) {
    sh.nout += sh.wsum[NT / 32 - 1];
    sh.entry = sh.xfail;
  }
  __syncthreads();
}

template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
    huff_scan_kernel(const uint8_t* __restrict__ streams, const int* __restrict__ base_l,
                     const int* __restrict__ limit_l, const int* __restrict__ offs,
                     const int* __restrict__ syms, uint8_t* __restrict__ out, int S, int T) {
  using Sh = Shape<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Small sh;
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  Page pg;
  pg.path = reinterpret_cast<unsigned long long*>(smem + TAB_BYTES);
  unsigned* rw = reinterpret_cast<unsigned*>(pg.path + NT);
  pg.rw = rw;
  pg.mark = rw + Sh::WORDS + 2;
  pg.m = pg.mark + Sh::WORDS;
  pg.e = pg.m + NT;
  pg.at = pg.e + NT;
  const int b = blockIdx.x, tid = threadIdx.x;
  const uint8_t* row = streams + (long long)b * S;
  uint8_t* o = out + (long long)b * T;
  const long long W = (S + 3) >> 2;
  const unsigned last = vword(row, S, W, W - 1);

  for (int i = tid; i < 256; i += NT) sh.sym[i] = (unsigned char)syms[b * 256 + i];
  if (tid <= LIMIT) {
    sh.base[tid] = base_l[b * (LIMIT + 1) + tid];
    sh.off[tid] = offs[b * (LIMIT + 1) + tid];
    sh.lim[tid] = limit_l[b * (LIMIT + 1) + tid];
  }
  if (tid == 0) {
    sh.entry = 0;
    sh.nout = 0;
    sh.z = 0;
  }
  __syncthreads();
  // z: one past the last word before W - 1 that is not word W - 1, from the end
  for (long long hi = W - 1; hi > 0; hi -= NT) {
    const long long i = hi - 1 - tid;
    const bool other = i >= 0 && vword(row, S, W, i) != last;
    if (other) atomicMax(&sh.z, (int)(i + 1));
    if (__syncthreads_or(other)) break;
  }
  if (tid < LIMIT) {  // the limits in order, clamped to the peeks' range
    const int v = sh.lim[tid + 1];
    int r = 0;
    for (int m = 0; m < LIMIT; ++m) {
      const int u = sh.lim[m + 1];
      r += u < v || (u == v && m < tid);
    }
    sh.sorted[r] = clampi(v, 0, 1 << LIMIT);
  }
  __syncthreads();
  {  // j: the limits at or below p; L, its offset and base change only where j does
    int j = 0, nxt = sh.sorted[0], L = 1, off = sh.off[1], base = sh.base[1];
    for (int p = tid; p < 1 << LIMIT; p += NT) {
      if (nxt <= p) {
        do nxt = ++j < LIMIT ? sh.sorted[j] : 1 << LIMIT;
        while (nxt <= p);
        L = min(1 + j, LIMIT);
        off = sh.off[L];
        base = sh.base[L];
      }
      tab[p] = (uint16_t)(sh.sym[clampi(sym_index(off, base, p, L), 0, 255)] | L << 8);
    }
  }
  __syncthreads();
  const Decoder dec(tab);
  const long long R = min(32LL * sh.z, (long long)LIMIT * T);

  for (long long pa = 0; pa < R && sh.nout < T; pa += Sh::PAGE) {
    pg.bits = (int)min((long long)Sh::PAGE, R - pa);
    const int pw = (pg.bits + 31) >> 5;
    int kw = NLZM_HUFF_KW ? NLZM_HUFF_KW : max(KW_MIN, (pw + NT - 1) / NT);
    if (!NLZM_HUFF_KW && !(kw & 1)) ++kw;
    pg.K = 32 * kw;
    const int nsp = (pg.bits + pg.K - 1) / pg.K;  // at most NT: a span a thread
#pragma unroll 4
    for (int i = tid; i < pw + 2; i += NT) rw[i] = vword(row, S, W, (pa >> 5) + i);
    __syncthreads();
    if (tid < nsp) {  // phase A
      pg.m[tid] = pg.chain0(tid, dec);
      pg.path[tid] = 0;
    }
    __syncthreads();
    if (tid < nsp) {
      const int e1 = tid ? (int)(pg.m[tid - 1] & 15u) : sh.entry;
      pg.m[tid] |= pg.map_at(tid, e1, dec) << 16;
      pg.e[tid] = e1;
    }
    __syncthreads();
    compose<NT>(pg, dec, sh, nsp, T);
    if (tid < nsp) {  // phase C
      int idx = (int)pg.at[tid], p = tid * pg.K + (int)(pg.e[tid] >> 8);
      const int end = tid * pg.K + pg.len(tid);
      Bytes w(o + idx);
      while (p < end && idx < T) {
        const unsigned v = dec(pg.peek(p));
        w.put(v & 255);
        ++idx;
        p += v >> 8;
      }
      w.done();
    }
    __syncthreads();
  }
  if (sh.nout >= T) return;

  // the tail: bits from E repeat with period 32 (every read is word W - 1)
  if (tid < 32) {
    const unsigned v = dec(__funnelshift_l(last, last, tid) >> (32 - LIMIT));
    const unsigned s = v & 255;
    const int nx = (tid + (int)(v >> 8)) & 31;
    int r = sh.entry, rlo = 0, rhi = 0;
    for (int j = 0; j < 64; ++j) {  // residues 0..63 of the walk
      if (j == tid) rlo = r;
      if (j == tid + 32) rhi = r;
      r = __shfl_sync(0xffffffffu, nx, r);
    }
    sh.pre[tid] = (unsigned char)__shfl_sync(0xffffffffu, s, rlo);
    sh.pat[tid] = (unsigned char)__shfl_sync(0xffffffffu, s, rhi);
    const unsigned back =
        __ballot_sync(0xffffffffu, rhi == __shfl_sync(0xffffffffu, rhi, 0)) & ~1u;
    if (tid == 0) sh.lam = back ? __ffs(back) - 1 : 32;
  }
  __syncthreads();
  // symbol j past n0: pre[j] below 32, then pat[(j - 32) mod lam]; a thread
  // a word of the output (word k holds indices 4k - al .. 4k - al + 3)
  const int n0 = (int)sh.nout, lam = sh.lam, al = (int)((uintptr_t)o & 3);
  for (int k = ((al + n0) >> 2) + tid, k1 = (al + T - 1) >> 2; k <= k1; k += NT) {
    const int i0 = max(4 * k - al, n0), i1 = min(4 * k - al + 3, T - 1);
    int m = i0 - n0 - 32;
    if (m >= 0) m %= lam;
    Bytes bw(o + i0);
    for (int i = i0; i <= i1; ++i, ++m) {
      if (m == lam) m = 0;
      bw.put(m < 0 ? sh.pre[m + 32] : sh.pat[m]);
    }
    bw.done();
  }
}

// the dynamic shared-memory limit of NT's kernel, set once a device
template <int NT>
cudaError_t smem_setup(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute((const void*)huff_scan_kernel<NT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Shape<NT>::SMEM);
  if (e == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return e;
}

// NT: 1024 when every block has an SM of its own, else 512 (two CTAs an
// SM). The SM count is read once a device.
int threads_a_cta(int B, int device) {
  static int sms[64] = {};
  int n = device >= 0 && device < 64 ? sms[device] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) sms[device] = n;
  }
  return NLZM_HUFF_THREADS ? NLZM_HUFF_THREADS : B <= n ? 1024 : 512;
}

template <int NT>
int launch(const void* streams, const void* base_l, const void* limit_l, const void* offs,
           const void* syms, void* out, int B, int S, int T, int device, cudaStream_t s) {
  const cudaError_t e = smem_setup<NT>(device);
  if (e != cudaSuccess) return (int)e;
  huff_scan_kernel<NT><<<B, NT, Shape<NT>::SMEM, s>>>(
      (const uint8_t*)streams, (const int*)base_l, (const int*)limit_l, (const int*)offs,
      (const int*)syms, (uint8_t*)out, S, T);
  return launch_status();
}

// NT's kernel on this device: out[0..6] = NLZM_HUFF_KW, NT, dynamic shared
// bytes, registers a thread, resident CTAs an SM, SMs, bits a page.
template <int NT>
int shape_of(int* out, int device) {
  cudaError_t e = smem_setup<NT>(device);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, (const void*)huff_scan_kernel<NT>);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)huff_scan_kernel<NT>,
                                                      NT, Shape<NT>::SMEM);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {NLZM_HUFF_KW, NT, Shape<NT>::SMEM, attr.numRegs, ctas, sms, Shape<NT>::PAGE};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads_a_cta(B, device) == 1024)
    return launch<1024>(streams, base_l, limit_l, offs, syms, out, B, S, T, device, s);
  return launch<512>(streams, base_l, limit_l, offs, syms, out, B, S, T, device, s);
}

// The launch at B blocks on this device, for reports: out[0..6] (host
// ints) as shape_of.
NLZM_API int nlzm_huff_shape(void* out, int B, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  return threads_a_cta(B, device) == 1024 ? shape_of<1024>((int*)out, device)
                                          : shape_of<512>((int*)out, device);
}
