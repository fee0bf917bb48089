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
// one serial chain of N relaxations. Most positions of real data have no
// valid edge (55-70% at 8-32 KiB blocks) and nearly all the rest reach at
// most 16 bytes, so the chain pays only for what a position holds. A CTA
// of two warps takes one block (the blocks spread over every SM), 32
// positions (a tile) at a time, last first, through two tile buffers in
// shared memory and named barriers:
//
// 1. The producer warp works out a tile ahead of the chain, lane j
//    position base + j: each candidate's distance cost, mmin and top
//    length (min(mlen, largest length), 0 without a distance), kept for a
//    long relaxation, and the reach, the longest valid length. In a tame
//    row (every cost 0..2^20, N * LIT <= 2^27) no sum can wrap or reach
//    DP_BIG (a cost is at most N * LIT, an edge's own cost at most
//    9 * 2^20 + 464), so adding cost[i + n] keeps the order of a length's
//    candidates: a position of reach 2..SHORT there is short and fills
//    one slot per length n = 2..reach, the first candidate of the least
//    cost at n (cost without the window, n | c << 16, or -1 without one);
//    a reach up to FEW fills all four slots n = 2..5. Every other edged
//    position, and every one of a row that is not tame, is long. Ballots
//    mark the positions with an edge, the FEW ones and the long ones. The
//    next tile's candidates are loaded into registers meanwhile, with
//    coalesced loads.
// 2. The chain warp, warp-uniform (every lane computes the same costs),
//    takes the positions between two marked ones as one run: lane l of the
//    run writes cost = cur + m * c_lit, m its distance from the run's top,
//    as the literal edge does step by step (an i32 sum that wraps). Without
//    an edge the match side is (DP_BIG, flat 0), so where a literal sum
//    passes DP_BIG the position takes cost DP_BIG and length 1 (kLens[0]);
//    outside a tame row a ballot finds the first such lane and the run
//    restarts below it. Positions at or past n_valid cost 0 and take the
//    literal. A short position prices its slots four at a time, their
//    window costs at places known from the slot index alone, so the loads
//    overlap, in flat order: the first minimum with a strict compare,
//    seeded with (DP_BIG, flat 0), which stands for every invalid edge
//    (flat 0 is length 1, below every mmin). A long position takes the
//    whole warp: lane j prices length indices j, j + 32 and j + 64 with
//    every candidate, and two redux.sync reductions give the least cost and
//    then the least flat index among the lanes that hold it. A position at
//    or past n_valid is relaxed too (its window is all 0): JAX returns its
//    best candidate.
//
// The costs of the next 512 positions sit in a circular buffer in shared
// memory, zero-initialised: positions past N cost 0, and no slot is
// rewritten while a position that reads it is pending (512 > 264). Lane j
// of the chain keeps the choice of tile position j, and the warp stores
// the tile's 32 choices at once. The candidate count is the calibrated
// parse's 3, a constant.
#include "common.cuh"

namespace {

constexpr int WIN = 512;  // the circular cost buffer: a power of two above 264
constexpr int C = 3;  // candidates a position: find_matches(num_cands=3)
constexpr int NLENS = 73;
constexpr int DP_BIG = 1 << 28;
constexpr int SHORT = 16;  // the longest reach priced from a position's slots
constexpr int SLOTS = SHORT - 1;  // slots a position: n = 2..SHORT
constexpr int FEW = 5;  // a tame position of reach <= FEW: slots n = 2..FEW, all written
constexpr int TAME_COST = 1 << 20;  // a tame row's entries, at most
constexpr int TAME_SUM = 1 << 27;  // a tame row's N * LIT, at most
constexpr unsigned FULL = 0xffffffffu;

// DP_LENS of ops/encode_ops.py: 1..64, then the reference's sampled lengths
__constant__ int kLens[NLENS] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,  17,  18,  19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,  35,  36,  37,  38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,  51,  52,  53,  54,  55,  56,  57,
    58, 59, 60, 61, 62, 63, 64, 72, 80, 96, 112, 128, 160, 192, 224, 264};

__device__ __forceinline__ int add32(int a, int b) {  // i32 add that wraps
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int mul32(int a, int b) {  // i32 product that wraps
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

// cmd_m + dist_slot + 16 * ab(d), ab the bit length of max(d, 1) - 1 less
// 2 (0 below 4)
__device__ __forceinline__ int dist_cost(int c_cmd_slot, int d) {
  const int dv = max(d, 1) - 1;
  return add32(c_cmd_slot, dv >= 4 ? (30 - __clz(dv)) * 16 : 0);
}

__device__ __forceinline__ int len_cost(int lv, int c_base, int c_slope, int c_esc) {
  return lv < 7 ? add32(c_base, mul32(lv, c_slope)) : c_esc;
}

// lane's share (indices lane, lane + 32, lane + 64) of the candidates of
// tile positions base .. base + 31 below N, coalesced; 0 past N
__device__ __forceinline__ void load_tile(const int* __restrict__ delta,
                                          const int* __restrict__ mlen, long long row, int base,
                                          int N, int (&pd)[C], int (&pm)[C]) {
  const int lane = threadIdx.x & 31, cnt = min(32, N - base) * C;
  const long long off = (row + base) * C;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int k = lane + 32 * q;
    pd[q] = k < cnt ? delta[off + k] : 0;
    pm[q] = k < cnt ? mlen[off + k] : 0;
  }
}

// One tile's work for the chain, written by the producer warp
struct Tile {
  int dc[32 * C], mm[32 * C], top[32 * C];  // each candidate's distance cost, mmin, top
  int2 slot[32 * SLOTS];  // at n: (cost without the window, n | c << 16, or -1: none)
  int n_slot[32];  // a short position's slots
  unsigned marked, few, lng;  // positions with an edge; tame ones of reach <= FEW; long ones
};

// named barriers of the two warps (0 is __syncthreads), immediates: tile
// buffer k is full at 1 + k and free again at 3 + k
__device__ __forceinline__ void wait_full(int k) {
  if (k) asm volatile("bar.sync 2, 64;" ::: "memory");
  else asm volatile("bar.sync 1, 64;" ::: "memory");
}
__device__ __forceinline__ void mark_full(int k) {
  if (k) asm volatile("bar.arrive 2, 64;" ::: "memory");
  else asm volatile("bar.arrive 1, 64;" ::: "memory");
}
__device__ __forceinline__ void wait_free(int k) {
  if (k) asm volatile("bar.sync 4, 64;" ::: "memory");
  else asm volatile("bar.sync 3, 64;" ::: "memory");
}
__device__ __forceinline__ void mark_free(int k) {
  if (k) asm volatile("bar.arrive 4, 64;" ::: "memory");
  else asm volatile("bar.arrive 3, 64;" ::: "memory");
}

__global__ void __launch_bounds__(64)
    dp_parse_kernel(const int* __restrict__ delta, const int* __restrict__ mlen,
                    const int* __restrict__ n_valid, const int* __restrict__ costs,
                    int* __restrict__ choice_len, int* __restrict__ choice_cand, int N, int L) {
  __shared__ int cost[WIN];
  __shared__ Tile tiles[2];
  __shared__ int raw_d[32 * C], raw_m[32 * C];  // the producer's staged candidates
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int* cr = costs + (long long)b * 6;
  const int c_lit = cr[0], c_base = cr[2], c_slope = cr[3], c_esc = cr[4];
  const int c_cmd_slot = add32(cr[1], cr[5]);
  bool tame = (long long)c_lit * N <= TAME_SUM;
#pragma unroll
  for (int k = 0; k < 6; ++k) tame = tame && cr[k] >= 0 && cr[k] <= TAME_COST;
  const long long row = (long long)b * N;
  const int n_tiles = (N + 31) / 32;  // tile t holds positions from (n_tiles - 1 - t) * 32

  // the warp index through a shuffle, so the compiler sees each role's
  // code as warp-uniform
  if (__shfl_sync(FULL, threadIdx.x >> 5, 0)) {  // the producer: step 1, a tile ahead
    const int top_len = kLens[L - 1];
    int pd[C], pm[C];  // this lane's share of the next tile's candidates
    load_tile(delta, mlen, row, (n_tiles - 1) * 32, N, pd, pm);
    for (int t = 0; t < n_tiles; ++t) {
      const int base = (n_tiles - 1 - t) * 32, cnt = min(32, N - base);
      Tile& tl = tiles[t & 1];
      if (t >= 2) wait_free(t & 1);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < C; ++q) {
        raw_d[lane + 32 * q] = pd[q];
        raw_m[lane + 32 * q] = pm[q];
      }
      if (base > 0) load_tile(delta, mlen, row, base - 32, N, pd, pm);
      __syncwarp();

      int dc[C], mm[C], top[C];
      int reach = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = raw_d[lane * C + c];
        dc[c] = dist_cost(c_cmd_slot, d);
        mm[c] = mmin_of(d);
        top[c] = d > 0 ? min(raw_m[lane * C + c], top_len) : 0;
        if (top[c] >= mm[c]) reach = max(reach, top[c]);
        tl.dc[lane * C + c] = dc[c];
        tl.mm[lane * C + c] = mm[c];
        tl.top[lane * C + c] = top[c];
      }
      if (lane >= cnt) reach = 0;
      const bool short_pos = tame && reach > 0 && reach <= SHORT;
      const bool few_pos = short_pos && reach <= FEW;
      const int n_end = few_pos ? FEW : short_pos ? reach : 0;  // the last n to write
      const int n_top = __reduce_max_sync(FULL, n_end);
      int2* slot = tl.slot + lane * SLOTS;
      for (int n = 2; n <= n_top; ++n) {
        if (n > n_end) continue;
        int bp = 0, bc = -1;  // the first candidate of the least cost at n
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (n < mm[c] || n > top[c]) continue;
          const int pre = add32(dc[c], len_cost(n - mm[c], c_base, c_slope, c_esc));
          if (bc < 0 || pre < bp) {
            bp = pre;
            bc = c;
          }
        }
        slot[n - 2] = make_int2(bp, bc < 0 ? -1 : n | bc << 16);
      }
      tl.n_slot[lane] = reach - 1;
      const unsigned marked = __ballot_sync(FULL, reach > 0);
      const unsigned few = __ballot_sync(FULL, few_pos);
      const unsigned lng = __ballot_sync(FULL, reach > 0 && !short_pos);
      if (lane == 0) {
        tl.marked = marked;
        tl.few = few;
        tl.lng = lng;
      }
      __threadfence_block();
      mark_full(t & 1);
    }
    return;
  }

  // the chain: step 2, a tile at a time from the top position down
  for (int k = lane; k < WIN; k += 32) cost[k] = 0;
  __syncwarp();
  const int nv = clampi(n_valid[b], 0, N);
  int lens[3];  // this lane's lengths of a long relaxation, 0 = none
#pragma unroll
  for (int k = 0; k < 3; ++k) lens[k] = lane + 32 * k < L ? kLens[lane + 32 * k] : 0;
  int cur = 0;  // the cost of the position above the one being relaxed
  for (int t = 0; t < n_tiles; ++t) {
    const int base = (n_tiles - 1 - t) * 32, cnt = min(32, N - base);
    const Tile& tl = tiles[t & 1];
    wait_full(t & 1);
    const unsigned marked = tl.marked, few = tl.few, lng = tl.lng;
    const int act = nv - base;  // tile positions at or above act are inactive
    int my_len = 0, my_cand = 0;
    int hi = cnt - 1;  // the highest position not yet relaxed
    while (hi >= 0) {
      const unsigned below = marked & (FULL >> (31 - hi));
      const int e = below ? 31 - __clz(below) : -1;  // the next marked position
      if (e < hi) {  // the run e + 1 .. hi
        const bool in_run = lane > e && lane <= hi;
        if (in_run && lane >= act) {
          cost[(base + lane) & (WIN - 1)] = 0;
          my_len = my_cand = 0;
        }
        int r = min(hi, act - 1);  // the run's top active position; cur is 0 above it
        if (tame && r > e) {  // no literal sum passes DP_BIG
          if (lane > e && lane <= r) {
            cost[(base + lane) & (WIN - 1)] = add32(cur, mul32(r - lane + 1, c_lit));
            my_len = my_cand = 0;
          }
          cur = add32(cur, mul32(r - e, c_lit));
        }
        while (!tame && r > e) {
          const bool in = lane > e && lane <= r;
          const int v = add32(cur, mul32(r - lane + 1, c_lit));
          const unsigned past = __ballot_sync(FULL, in && v > DP_BIG);
          const int f = past ? 31 - __clz(past) : e;  // the first, walking down
          if (lane > f && lane <= r) {
            cost[(base + lane) & (WIN - 1)] = v;
            my_len = my_cand = 0;
          }
          if (!past) {
            cur = add32(cur, mul32(r - e, c_lit));
            break;
          }
          if (lane == f) {
            cost[(base + lane) & (WIN - 1)] = DP_BIG;
            my_len = 1;
            my_cand = 0;
          }
          cur = DP_BIG;
          r = f - 1;
        }
        __syncwarp();  // the run's costs, for the relaxations below
      }
      if (e < 0) break;

      const int i = base + e;
      int best = DP_BIG, best_nc = 1;  // flat 0: length 1, candidate 0
      if (!(lng >> e & 1)) {  // short: its slots in flat order, four at a time
        int n_s = FEW - 1;
        if (!(few >> e & 1)) n_s = tl.n_slot[e];
        const int2* ed = tl.slot + e * SLOTS;
        for (int k = 0; k < n_s; k += 4) {
          int2 en[4];
          int w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int s = k + u;
            en[u] = s < n_s ? ed[s] : make_int2(0, -1);
            w[u] = cost[(i + s + 2) & (WIN - 1)];  // slot s's n
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int tot = add32(en[u].x, w[u]);
            if (en[u].y >= 0 && tot < best) {
              best = tot;
              best_nc = en[u].y;
            }
          }
        }
      } else {  // long: the warp over lengths, every candidate
        int ldc[C], lmm[C], lml[C];
        int lreach = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          ldc[c] = tl.dc[e * C + c];
          lmm[c] = tl.mm[e * C + c];
          lml[c] = tl.top[e * C + c];
          lreach = max(lreach, lml[c]);
        }
        int w[3];  // loaded together (a length 0 reads a slot it ignores)
#pragma unroll
        for (int k = 0; k < 3; ++k) w[k] = cost[(i + lens[k]) & (WIN - 1)];
        int tot_l = lane == 0 ? DP_BIG : 0x7fffffff;
        unsigned flat_l = lane == 0 ? 0u : 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int n = lens[k];
          if (n == 0 || n > lreach) break;  // lengths rise with k
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int lv = n - lmm[c];
            if (lv < 0 || n > lml[c]) continue;
            const int tot = add32(add32(ldc[c], len_cost(lv, c_base, c_slope, c_esc)), w[k]);
            if (tot < tot_l) {
              tot_l = tot;
              flat_l = (unsigned)((lane + 32 * k) * C + c);
            }
          }
        }
        best = __reduce_min_sync(FULL, tot_l);
        const unsigned am = __reduce_min_sync(FULL, tot_l == best ? flat_l : 0xFFFFFFFFu);
        best_nc = kLens[am / C] | (int)(am % C) << 16;
      }
      const int lit = add32(c_lit, cur);
      const bool use = best < lit;
      const bool active = e < act;
      // every lane writes the same value: each sees its own store, and
      // the slot is read by no pending position
      cur = active ? (use ? best : lit) : 0;
      cost[i & (WIN - 1)] = cur;
      if (lane == e) {
        my_len = active && use ? best_nc & 0xFFFF : 0;
        my_cand = best_nc >> 16;
      }
      hi = e - 1;
    }
    if (lane < cnt) {
      choice_len[row + base + lane] = my_len;
      choice_cand[row + base + lane] = my_cand;
    }
    __syncwarp();
    if (t + 2 < n_tiles) mark_free(t & 1);  // the producer may refill it
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
  // once a device: as many blocks resident as fit. The attribute belongs
  // to the current device, so a process that launches on several cards
  // sets it on each. It is a hint: bytes cannot show it missing, only time.
  static bool carveout_set[64] = {};
  if (device < 0 || device >= 64 || !carveout_set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        dp_parse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (device >= 0 && device < 64) carveout_set[device] = true;
  }
  dp_parse_kernel<<<B, 64, 0, (cudaStream_t)stream>>>(
      (const int*)delta, (const int*)mlen, (const int*)n_valid, (const int*)costs,
      (int*)choice_len, (int*)choice_cand, N, L);
  return launch_status();
}
