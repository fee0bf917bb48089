// Rep-slot replay over a command stream.
//
// Replaces nlzm_tpu/ops/encode_ops.py::repify. Per block, a 4-slot table
// of distances starting at {1, 2, 3, 4}: a match (op_len > 0) whose
// distance is in the table gets the index of its first equal slot; a fresh
// distance is pushed to the front (the last slot drops). Every other row
// gives -1. op_len / op_val / op_rep are [T, B].
//
// Bound: bytes (op_len read and op_rep written once, op_val read only at
// the matches), once the table's chain of T steps a block is broken up. Only a match changes the table, and a
// run of rows acts on it in closed form: with k = min(inserts, 4), the
// exit table is the run's last k inserts (newest first), then the entry's
// first 4 - k slots. Such summaries compose.
//
// Design: a CTA takes G adjacent blocks (8, or 4 where B / 8 CTAs would
// leave most SMs idle), S = 64 threads each; thread (s, g) owns segment s
// of block g, rows [s * seg, (s + 1) * seg), seg = ceil(T / S), and walks
// it with the table in registers, U rows a chunk, the next chunk loaded
// while this one is walked. The G threads of a segment read and write G
// adjacent words of a row, so a row's 32-byte sectors serve the CTA.
//  1. Run 0: segment 0 starts from {1, 2, 3, 4}, the others from the
//     guess {0, -1, -2, -3}. Each loads op_len and op_val, notes its
//     matches in a bit mask in shared memory (32 KiB a CTA: the first
//     32 * 8192 / (S * G) rows of each segment, all of them up to T =
//     32768 at G = 8), and keeps its summary (k, exit table).
//  2. Each later run: every thread composes the summaries of the segments
//     before its own into its entry, and a segment walks again, writing
//     op_rep, if it has not written yet or its entry changed; the mask
//     spares it op_len and op_val off the matches. If no summary of a
//     block changed, every entry is exact: segment 0's is, and each next
//     one composes exact summaries. Otherwise the segments up to the
//     first changed one, f, have exact entries.
//  3. After R runs, a block that still changed is finished by its warp
//     from segment f + 1 on, f's exit table being exact: 32 rows a group,
//     K groups loaded ahead, a ballot of the matches, their distances in
//     order in shared memory. Its chain is rows / 32 plus the matches.
// So the serial part is seg rows a run (two runs on most corpus blocks),
// at most R runs plus the fallback. The table's step is selects only: a
// branch there was the fallback's largest cost. The guess may equal a real
// distance: exactness comes from the verification alone. Nothing is
// indexed by data: distances are compared, never used as addresses.
#include "common.cuh"

namespace {

// Build options, for comparisons (repify_compare.py): NLZM_REPIFY_RUNS = 0
// leaves out the segments (each block's warp replays it from row 0, step 3
// alone); NLZM_REPIFY_BLOCKS = 4 or 8 fixes G.
#ifndef NLZM_REPIFY_RUNS
#define NLZM_REPIFY_RUNS 3
#endif
#ifndef NLZM_REPIFY_BLOCKS
#define NLZM_REPIFY_BLOCKS 0  // 0: chosen from B and the SM count
#endif

// S, R and the guess are also chip_smoke.REP_S / REP_R / REP_GUESS, which
// nlzm_repify_scheme reports for chip_smoke to check.
constexpr int S = 64;                  // segments a block
constexpr int R = NLZM_REPIFY_RUNS;    // runs before the fallback
// Run 0's entry table but in segment 0: slot i holds -i, i.e. (0, -1, -2, -3).
__host__ __device__ constexpr int guess(int i) { return -i; }
constexpr int U = 16;  // rows a chunk of a segment's walk (half a mask word)
constexpr int K = 8;   // groups of 32 rows the fallback loads ahead

struct Tab {
  int t0, t1, t2, t3;
};

__device__ __forceinline__ bool operator!=(const Tab& a, const Tab& b) {
  return a.t0 != b.t0 || a.t1 != b.t1 || a.t2 != b.t2 || a.t3 != b.t3;
}

// One row of distance v on table t, a match if `match`: returns the first
// equal slot or -1, and pushes v to the front on a match that misses.
// Selects only, no branch: the table's chain is the compares, their OR
// and one select.
__device__ __forceinline__ int step(Tab& t, int v, bool match) {
  const bool h0 = v == t.t0, h1 = v == t.t1, h2 = v == t.t2, h3 = v == t.t3;
  const bool miss = match && !(h0 || h1 || h2 || h3);
  t.t3 = miss ? t.t2 : t.t3;
  t.t2 = miss ? t.t1 : t.t2;
  t.t1 = miss ? t.t0 : t.t1;
  t.t0 = miss ? v : t.t0;
  return h0 ? 0 : (h1 ? 1 : (h2 ? 2 : (h3 ? 3 : -1)));
}

// e <- x[0:k] ++ e[0:4 - k]: the table after a run with summary (k, x).
__device__ __forceinline__ void compose(Tab& e, int k, const Tab& x) {
  const Tab o = e;
  e.t0 = k >= 1 ? x.t0 : o.t0;
  e.t1 = k >= 2 ? x.t1 : (k == 1 ? o.t0 : o.t1);
  e.t2 = k >= 3 ? x.t2 : (k == 2 ? o.t0 : (k == 1 ? o.t1 : o.t2));
  e.t3 = k >= 4 ? x.t3 : (k == 3 ? o.t0 : (k == 2 ? o.t1 : (k == 1 ? o.t2 : o.t3)));
}

// Whether summaries (k, x) and (k2, y) differ: k, then the first k slots.
__device__ __forceinline__ bool differ(int k, const Tab& x, int k2, const Tab& y) {
  return k != k2 || (k >= 1 && x.t0 != y.t0) || (k >= 2 && x.t1 != y.t1) ||
         (k >= 3 && x.t2 != y.t2) || (k >= 4 && x.t3 != y.t3);
}

// Rows [c, c + U) of a segment of n rows: which are matches (bit u) and
// their distances. Run 0 (FIRST) loads op_len and op_val and notes the
// matches in the thread's mask words (mask[w * NTHREADS], rows up to
// MASK_ROWS); a later run takes them from there and loads op_val at the
// matches alone.
template <int G, bool FIRST>
__device__ __forceinline__ unsigned load_chunk(const int* __restrict__ len,
                                               const int* __restrict__ val, long long B, int n,
                                               int c, unsigned* mask, int (&V)[U]) {
  constexpr int NTHREADS = S * G, MASK_ROWS = 32 * (8192 / NTHREADS);
  unsigned bits = 0;
  if (FIRST || c >= MASK_ROWS) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = c + u;
      const bool live = r < n;
      bits |= (live && len[r * B] > 0 ? 1u : 0u) << u;
      V[u] = live ? val[r * B] : 0;
    }
    if (FIRST && c < MASK_ROWS) {
      unsigned* w = mask + (c >> 5) * NTHREADS;
      *w = (c & 16) ? (*w | bits << 16) : bits;
    }
  } else {
    bits = (mask[(c >> 5) * NTHREADS] >> (c & 16)) & 0xffffu;
#pragma unroll
    for (int u = 0; u < U; ++u) V[u] = (bits >> u & 1) ? val[(c + u) * B] : 0;
  }
  return bits;
}

// One segment's walk: n rows from len / val / rep (this block's column,
// rows B apart), the table t updated in place, inserts counted in k,
// op_rep written unless FIRST. The next chunk loads while this one is
// walked.
template <int G, bool FIRST>
__device__ __forceinline__ void walk(const int* __restrict__ len, const int* __restrict__ val,
                                     int* __restrict__ rep, long long B, int n, unsigned* mask,
                                     Tab& t, int& k) {
  int V[U];
  unsigned bits = n > 0 ? load_chunk<G, FIRST>(len, val, B, n, 0, mask, V) : 0;
  for (int c = 0; c < n; c += U) {
    int Vn[U];
    const unsigned next = c + U < n ? load_chunk<G, FIRST>(len, val, B, n, c + U, mask, Vn) : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool match = bits >> u & 1;
      const int idx = step(t, V[u], match);
      if (!FIRST && c + u < n) rep[(c + u) * B] = match ? idx : -1;
      k += match && idx < 0;
      V[u] = Vn[u];
    }
    bits = next;
  }
}

// The fallback: one warp replays rows [r0, T) of its block from table t,
// 32 rows a group, K groups loaded ahead, matches only: a ballot finds
// them, their distances go in order to cv (32 ints of shared memory), and
// the warp steps through those, each lane keeping its own match's slot.
__device__ __forceinline__ void replay_matches(const int* __restrict__ len,
                                               const int* __restrict__ val,
                                               int* __restrict__ rep, long long B, int r0, int T,
                                               Tab t, int* cv) {
  const int lane = threadIdx.x & 31;
  int L[K], V[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int r = r0 + 32 * i + lane;
    L[i] = r < T ? len[r * B] : -1;
    V[i] = r < T ? val[r * B] : 0;
  }
  for (int base = r0; base < T; base += 32 * K) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int row = base + 32 * i + lane;
      const unsigned m = __ballot_sync(0xffffffffu, L[i] > 0);
      const int rank = __popc(m & ((1u << lane) - 1)), cnt = __popc(m);
      if (L[i] > 0) cv[rank] = V[i];
      __syncwarp();
      int mine = -1;
      for (int j = 0; j < cnt; j += 8) {
        int v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = cv[(j + q) & 31];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int idx = step(t, v[q], j + q < cnt);
          mine = rank == j + q ? idx : mine;
        }
      }
      __syncwarp();
      if (row < T) rep[row * B] = L[i] > 0 ? mine : -1;
      const int r = row + 32 * K;
      L[i] = r < T ? len[r * B] : -1;
      V[i] = r < T ? val[r * B] : 0;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(S * G)
    repify_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                  int* __restrict__ op_rep, int T, int B) {
  constexpr int NTHREADS = S * G;
  __shared__ int sk[S][G];                     // each segment's k
  __shared__ Tab sx[S][G];                     // and exit table
  __shared__ int first[G];                     // each block's first changed segment, or S
  __shared__ unsigned masks[8192 / NTHREADS][NTHREADS];  // each thread's matches, a bit a row
  __shared__ int cv[G][32];                    // the fallback's distances, a warp each
  const int g = threadIdx.x % G, s = threadIdx.x / G;
  const int b = blockIdx.x * G + g;
  const bool live = b < B;
  const int seg = (T + S - 1) / S;
  const int row0 = s * seg;
  const int n = live ? max(0, min(seg, T - row0)) : 0;
  const long long off = n > 0 ? (long long)row0 * B + b : 0;
  const int *len = op_len + off, *val = op_val + off;
  int* rep = op_rep + off;
  unsigned* mask = &masks[0][threadIdx.x];
  if (R == 0) {  // step 3 alone, from row 0
    const int w = threadIdx.x >> 5, bw = blockIdx.x * G + w;
    if (w < G && bw < B)
      replay_matches(op_len + bw, op_val + bw, op_rep + bw, B, 0, T, Tab{1, 2, 3, 4}, cv[w]);
    return;
  }

  Tab e = s == 0 ? Tab{1, 2, 3, 4} : Tab{guess(0), guess(1), guess(2), guess(3)};
  Tab x = e;
  int k = 0;
  walk<G, true>(len, val, rep, B, n, mask, x, k);
  k = min(k, 4);
  sk[s][g] = k;
  sx[s][g] = x;
  bool written = false, done = false;
  for (int run = 1; run < R; ++run) {
    if (threadIdx.x < G) first[threadIdx.x] = S;
    __syncthreads();
    Tab ne{1, 2, 3, 4};
    for (int q = 0; q < S - 1; ++q) {
      if (q < s) compose(ne, sk[q][g], sx[q][g]);
    }
    const bool rerun = live && !done && (!written || ne != e);
    __syncthreads();
    if (rerun) {
      e = ne;
      Tab y = e;
      int k2 = 0;
      walk<G, false>(len, val, rep, B, n, mask, y, k2);
      k2 = min(k2, 4);
      if (differ(k, x, k2, y)) atomicMin(&first[g], s);
      k = k2;
      x = y;
      written = true;
      sk[s][g] = k;
      sx[s][g] = x;
    }
    __syncthreads();
    done = first[g] == S;
    if (!__syncthreads_or(!done)) return;
  }
  const int w = threadIdx.x >> 5;
  if (w >= G) return;
  const int f = first[w], bw = blockIdx.x * G + w;
  if (bw >= B || f == S) return;
  replay_matches(op_len + bw, op_val + bw, op_rep + bw, B, (f + 1) * seg, T, sx[f][w], cv[w]);
}

}  // namespace

// Blocks a CTA: 8, so that a CTA's rows fill 32-byte sectors, unless
// that leaves more than half the SMs without a CTA; then 4. The SM count is
// read once a device.
static int blocks_a_cta(int B, int device) {
  if (NLZM_REPIFY_BLOCKS) return NLZM_REPIFY_BLOCKS;
  static int sms[64] = {};
  int n = device >= 0 && device < 64 ? sms[device] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) sms[device] = n;
  }
  return (B + 7) / 8 >= n / 2 ? 8 : 4;
}

// op_len, op_val [T, B] i32; op_rep [T, B] i32 out.
NLZM_API int nlzm_repify(const void* op_len, const void* op_val, void* op_rep, int T, int B,
                         int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || T == 0) return 0;
  const int *len = (const int*)op_len, *val = (const int*)op_val;
  int* rep = (int*)op_rep;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks_a_cta(B, device) == 8)
    repify_kernel<8><<<(B + 7) / 8, S * 8, 0, st>>>(len, val, rep, T, B);
  else
    repify_kernel<4><<<(B + 3) / 4, S * 4, 0, st>>>(len, val, rep, T, B);
  return launch_status();
}

// The scheme's constants, for checks: out[0..5] = S, R, the guess.
NLZM_API int nlzm_repify_scheme(void* out, int device, void* stream) {
  (void)device, (void)stream;
  int* o = (int*)out;
  o[0] = S;
  o[1] = R;
  for (int i = 0; i < 4; ++i) o[2 + i] = guess(i);
  return 0;
}
