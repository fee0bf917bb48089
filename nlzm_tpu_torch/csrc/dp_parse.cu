// Optimal-parse DP: a backward shortest-path relaxation per block over the
// match candidates of find_matches, with per-block static bit costs.
//
// Replaces nlzm_tpu/ops/encode_ops.py::dp_parse. From the last position
// back, cost[i] = 0 at or past n_valid, else the cheaper of the literal
// edge c_lit + cost[i + 1] and the cheapest match edge over (length n of
// DP_LENS up to max_len, candidate c): cmd_m + dist_slot + 16 * ab(d) +
// (len_base + slope * lv if lv < 7 else len_esc) + cost[i + n], with lv =
// n - mmin(d). An edge is valid when lv >= 0, n <= mlen and d > 0, else it
// costs DP_BIG; the least cost wins, ties to the first (length, candidate)
// in flat order (len_idx * C + c), and the match is taken only when
// strictly cheaper than the literal. Every sum wraps as i32 (two's
// complement), as the JAX scan's sums do. Outputs choice_len (0 = literal)
// and choice_cand (the best edge's candidate, also where the literal wins),
// [B, N].
//
// Bound: latency. Position i needs cost[i + 1 .. i + 264], so a block is
// one serial chain of N relaxations of 73 x C edges each. Design: one warp
// per block, four blocks per CTA. Lane j takes length indices j, j + 32 and
// j + 64 (lanes 0-8 have three of the 73), each with every candidate; the
// costs of the next 512 positions sit in a circular buffer in shared
// memory, zero-initialised (positions past N cost 0, and no slot is
// rewritten while a position that reads it is pending: 512 > 264). A lane
// works out what depends on the candidate alone (distance cost, mmin) once
// per candidate, and prices only the valid edges, stopping at the first of
// its lengths above every candidate's mlen: the invalid ones all cost
// DP_BIG, and the first of them in flat order is always flat 0 (length 1,
// below every mmin), which seeds lane 0. Edges come in flat order, so a
// strict compare keeps the first of equal costs. The first minimum over
// the warp takes two redux.sync reductions:
// the least cost, then the least flat index among the lanes that hold it.
// delta and mlen are staged 32 positions at a time in shared memory with
// coalesced loads; lane j keeps the choice of the position congruent to j
// mod 32, and the warp stores 32 choices at once. The candidate count is
// the calibrated parse's 3, a constant, so the candidate loops unroll.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // blocks per CTA
constexpr int NTHREADS = 32 * WARPS;
constexpr int WIN = 512;  // the circular cost buffer: a power of two above 264
constexpr int C = 3;  // candidates a position: find_matches(num_cands=3)
constexpr int NLENS = 73;
constexpr int DP_BIG = 1 << 28;

// DP_LENS of ops/encode_ops.py: 1..64, then the reference's sampled lengths
__constant__ int kLens[NLENS] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,  17,  18,  19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,  35,  36,  37,  38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,  51,  52,  53,  54,  55,  56,  57,
    58, 59, 60, 61, 62, 63, 64, 72, 80, 96, 112, 128, 160, 192, 224, 264};

__device__ __forceinline__ int add32(int a, int b) {  // i32 add that wraps
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

__global__ void __launch_bounds__(NTHREADS)
    dp_parse_kernel(const int* __restrict__ delta, const int* __restrict__ mlen,
                    const int* __restrict__ n_valid, const int* __restrict__ costs,
                    int* __restrict__ choice_len, int* __restrict__ choice_cand, int B, int N,
                    int L) {
  __shared__ int s_cost[WARPS][WIN];
  __shared__ int s_d[WARPS][32 * C];
  __shared__ int s_m[WARPS][32 * C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps only
  int* cost = s_cost[warp];
  int* sd = s_d[warp];
  int* sm = s_m[warp];
  for (int k = lane; k < WIN; k += 32) cost[k] = 0;

  const int* cr = costs + (long long)b * 6;
  const int c_lit = cr[0], c_base = cr[2], c_slope = cr[3], c_esc = cr[4];
  const int c_cmd_slot = add32(cr[1], cr[5]);
  const int nv = n_valid[b];
  int lens[3];  // this lane's lengths, 0 = none
#pragma unroll
  for (int k = 0; k < 3; ++k) lens[k] = lane + 32 * k < L ? kLens[lane + 32 * k] : 0;

  const long long row = (long long)b * N;
  int my_len = 0, my_cand = 0;
  for (int i = N - 1; i >= 0; --i) {
    const int base = i & ~31, j = i - base;
    if (i == N - 1 || j == 31) {  // stage positions base .. base + j
      const long long off = (row + base) * C;
      for (int k = lane; k < (j + 1) * C; k += 32) {
        sd[k] = delta[off + k];
        sm[k] = mlen[off + k];
      }
    }
    __syncwarp();  // the staged batch, and the cost written at i + 1

    int dist_c[C], mm[C], ml[C];
    int reach = 0;  // the longest valid length of any candidate here
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = sd[j * C + c];
      const int dv = max(d, 1) - 1;
      const int ab = dv >= 4 ? 30 - __clz(dv) : 0;  // bit length of dv, less 2
      dist_c[c] = add32(c_cmd_slot, ab * 16);
      mm[c] = mmin_of(d);
      ml[c] = d > 0 ? sm[j * C + c] : 0;  // no candidate: no valid length
      reach = max(reach, ml[c]);
    }
    // Every invalid edge costs DP_BIG, and flat 0 (length 1, below every
    // mmin) is always invalid: so (DP_BIG, 0) stands for all of them, and
    // only valid edges are visited. They come in flat order, so a strict
    // compare keeps the first of equal costs; no valid edge past lane 0's
    // seed can displace it at an equal or larger cost.
    int best_tot = lane == 0 ? DP_BIG : 0x7fffffff;
    unsigned best_flat = lane == 0 ? 0u : 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int n = lens[k];
      if (n == 0 || n > reach) break;  // lengths rise with k
      const int w = cost[(i + n) & (WIN - 1)];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int lv = n - mm[c];
        if (lv < 0 || n > ml[c]) continue;
        const int len_c =
            lv < 7 ? add32(c_base, (int)((unsigned)lv * (unsigned)c_slope)) : c_esc;
        const int tot = add32(add32(dist_c[c], len_c), w);
        if (tot < best_tot) {
          best_tot = tot;
          best_flat = (unsigned)((lane + 32 * k) * C + c);
        }
      }
    }
    const int mc = __reduce_min_sync(0xffffffffu, best_tot);
    const unsigned am = __reduce_min_sync(0xffffffffu, best_tot == mc ? best_flat : 0xFFFFFFFFu);
    const int lit_c = add32(c_lit, cost[(i + 1) & (WIN - 1)]);
    const bool use = mc < lit_c;
    const bool active = i < nv;
    // every lane's loads of i fed the reductions, so the write below
    // cannot overtake them; it goes to a slot no pending position reads
    if (lane == 0) cost[i & (WIN - 1)] = active ? (use ? mc : lit_c) : 0;
    if (lane == j) {
      my_len = active && use ? kLens[am / C] : 0;
      my_cand = (int)(am % C);
    }
    if (j == 0 && base + lane < N) {
      choice_len[row + base + lane] = my_len;
      choice_cand[row + base + lane] = my_cand;
    }
  }
}

}  // namespace

// delta, mlen [B, N, 3] i32; n_valid [B] i32; costs [B, 6] i32;
// choice_len, choice_cand [B, N] i32 out; L = how many of the 73 DP_LENS
// are at most max_len (1..73).
NLZM_API int nlzm_dp_parse(const void* delta, const void* mlen, const void* n_valid,
                           const void* costs, void* choice_len, void* choice_cand, int B, int N,
                           int num_cands, int L, int device, void* stream) {
  cudaSetDevice(device);
  if (num_cands != C || L < 1 || L > NLENS) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  dp_parse_kernel<<<(B + WARPS - 1) / WARPS, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)delta, (const int*)mlen, (const int*)n_valid, (const int*)costs,
      (int*)choice_len, (int*)choice_cand, B, N, L);
  return launch_status();
}
