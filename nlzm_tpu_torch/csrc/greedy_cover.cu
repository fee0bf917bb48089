// Command covers: one LZ command per step per block, walking a per-position
// step from the start of the block. Two entries share the walk:
//
// - nlzm_greedy_cover replaces nlzm_tpu/ops/encode_ops.py::greedy_cover:
//   at the write head the JAX scan takes the match (delta d, length l) of
//   find_matches' one candidate if d > 0 and l >= mmin(d), else a literal,
//   and advances by max(length, 1);
// - nlzm_dp_cover replaces nlzm_tpu/ops/encode_ops.py::dp_cover: it follows
//   dp_parse's choices, advancing by max(choice_len, 1); a position with
//   choice_len > 0 is a match of that length at delta[choice_cand], 0 when
//   choice_cand is outside [0, C) (the JAX one-hot select), else a literal.
//
// Steps past n_valid emit (-1, the byte at the head clamped to N - 1).
// op_len / op_val are [T, B].
//
// Bound: the chain of command starts, each start depending on the last
// (up to one a position), and the [T, B] stores, 4 bytes a block a row.
// Design: a cluster of G = 8 CTAs takes 8 adjacent blocks, a CTA a block,
// cut into segments of 32 positions, one mask word each, so that no thread
// follows the whole chain:
// 1. next: every position's next start, min(p + step, N), by a streaming
//    pass (every thread's loads in flight), into shared memory (u16, N <=
//    32768: 64 KiB, three CTAs an SM) or a global scratch row;
// 2. jump, in place: J[p], the first position of the walk from p at or
//    past the end of p's segment, five rounds of pointer doubling over a
//    warp's 32 next positions (shuffles);
// 3. crossing: thread 0 follows q <- J[q] from 0 while q < n_valid and
//    records each q as its segment's entry, the segment's first start: at
//    most min(ceil(n_valid / 32), num_steps) dependent loads, whatever the
//    command count. Segments a step jumps over get no entry. 1-3 run a
//    chunk at a time (2048 positions, then each chunk twice the last), and
//    a chunk the crossing never reaches (past n_valid, after num_steps
//    entries, or jumped over) is never loaded;
// 4. marks: a warp a segment with an entry reloads its next positions and
//    runs five more rounds of doubling that carry each position's start
//    bits along; the entry's lane gives the segment's mask word, and the
//    warp whose walk crosses n_valid records the end;
// 5. a block scan of the bit counts gives each start its step index; the
//    first num_steps starts' positions replace the jumps;
// 6. writes, by tiles of rows x the cluster's 8 blocks: warp w gathers 32
//    consecutive starts of one block (their positions from that CTA's
//    shared memory, the commands' loads nearly coalesced), the tile is
//    turned in shared memory, and 8 lanes store one 32-byte run of a row
//    of op_len / op_val, where a column store pays a sector for 4 bytes.
// n_valid is clamped to [0, N] and next to N, so the walk stays inside the
// block, however far a step jumps.
#include "common.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int G = 8;  // blocks a cluster, one a CTA
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int FIRST_CHUNK = 2048;  // positions of 1-3's first chunk
constexpr int UNROLL = 4;          // 4: segments a warp loads at once
constexpr int WUNROLL = 4;         // 6: tiles a thread gathers at once
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_ENTRY = 0xffffffffu;  // a segment's mask word before the marks

__device__ __forceinline__ int mmin_of(int d) {
  return 2 + (d > 0xFF) + (d > 0xFFF) + (d > 0xFFFFF);
}

// The parse's inputs: greedy (DP false) reads delta [B, N] and mlen as
// `len`; dp (DP true) reads delta [B, N, C], choice_len as `len` and
// choice_cand as `cand`.
template <bool DP>
struct Choices {
  const uint8_t* __restrict__ data;
  const int* __restrict__ delta;
  const int* __restrict__ len;
  const int* __restrict__ cand;
  int C;

  __device__ __forceinline__ int step(long long at) const {  // at = b * N + p
    const int l = len[at];
    if constexpr (DP) return max(l, 1);
    const int d = delta[at];
    return (d > 0 && l >= mmin_of(d)) ? l : 1;  // a match has l >= 2
  }
  // the start after p: min(p + step, N), without overflow
  __device__ __forceinline__ int next(long long rowoff, int p, int N) const {
    const int st = step(rowoff + p);
    return st >= N - p ? N : p + st;
  }
  // the command at a start: (length, distance), or (0, the byte) for a
  // literal; every load is made, so a warp's loads for several starts are
  // in flight together
  __device__ __forceinline__ int2 command(long long at) const {
    const int l = len[at], byte = data[at];
    if constexpr (DP) {
      const int c = cand[at];
      const int d = delta[at * C + clampi(c, 0, C - 1)];
      return l > 0 ? make_int2(l, (c >= 0 && c < C) ? d : 0) : make_int2(0, byte);
    } else {
      const int d = delta[at];
      return (d > 0 && l >= mmin_of(d)) ? make_int2(l, d) : make_int2(0, byte);
    }
  }
};

// Pos: u16 positions in shared memory, i32 in the global scratch rows.
// 32 registers a thread, so four CTAs fit an SM.
template <bool SMEM, bool DP>
__global__ void __cluster_dims__(G, 1, 1) __launch_bounds__(NTHREADS, 4)
    cover_kernel(Choices<DP> ch, const int* __restrict__ n_valid, int* __restrict__ op_len,
                 int* __restrict__ op_val, int* gjump, unsigned* gmask, int B, int N,
                 int num_steps) {
  using Pos = std::conditional_t<SMEM, uint16_t, int>;
  extern __shared__ __align__(16) unsigned sdyn[];
  __shared__ int scan_scratch[32][1];
  __shared__ int s_end, s_ncmd, s_tail, s_q, s_k;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), base = blockIdx.x - rank;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nseg = (N + 31) >> 5;
  unsigned* mask;  // a segment's entry after 3, its start bits after 4
  Pos* jump;       // the jumps until 4, then the starts' positions
  if constexpr (SMEM) {
    mask = sdyn;
    jump = reinterpret_cast<uint16_t*>(sdyn + nseg);
  } else {
    mask = gmask + (long long)b * nseg;
    jump = gjump + (long long)b * N;
  }
  const long long rowoff = (long long)b * N;

  if (b < B) {  // CTA-uniform: the grid is rounded up to whole clusters
    const int nv = clampi(n_valid[b], 0, N);

    for (int s = t; s < nseg; s += NTHREADS) mask[s] = NO_ENTRY;
    if (t == 0) {
      s_end = 0;  // n_valid 0: the walk ends at 0
      s_q = s_k = 0;
    }
    __syncthreads();

    // 1-3, a chunk at a time; the crossing's head and entry count carry
    // over in s_q, s_k
    for (int c0 = 0, len = FIRST_CHUNK; c0 < N; c0 += len, len *= 2) {
      const int c1 = min(c0 + len, N), q0 = s_q;  // CTA-uniform
      if (q0 >= nv || s_k >= num_steps) break;
      if (q0 >= c1) continue;
      // 1. next
      for (int p = c0 + t; p < c1; p += NTHREADS) jump[p] = (Pos)ch.next(rowoff, p, N);
      __syncthreads();
      // 2. jump
      for (int s = (c0 >> 5) + warp; s < (c1 + 31) >> 5; s += NWARPS) {
        const int lo = s << 5, hi = min(lo + 32, N);
        int j = lo + lane < N ? (int)jump[lo + lane] : N;
        // after round r, j = next^(2^(r+1))(p), absorbed at hi; a
        // segment's walk leaves it within 32 steps
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          const int via = __shfl_sync(FULL, j, (j - lo) & 31);
          if (j < hi) j = via;
        }
        if (lo + lane < N) jump[lo + lane] = (Pos)j;
      }
      __syncthreads();
      // 3. crossing, through this chunk. Every entry is a start, so past
      // num_steps entries every later start is dropped (and no dead row is
      // written, so the end is not needed)
      if (t == 0) {
        int q = q0, k = s_k;
        for (; q < c1 && q < nv && k < num_steps; ++k, q = jump[q]) mask[q >> 5] = (unsigned)q;
        s_q = q;
        s_k = k;
      }
      __syncthreads();
    }

    // 4. marks, a warp a segment: lane p - lo ends with the starts of the
    // walk from p inside the segment
    for (int s0 = warp; s0 < nseg; s0 += UNROLL * NWARPS) {
      unsigned e[UNROLL];
      int nx[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u * NWARPS;
        e[u] = s < nseg ? mask[s] : NO_ENTRY;
        const int p = (s << 5) + lane;
        nx[u] = (e[u] != NO_ENTRY && p < N) ? ch.next(rowoff, p, N) : N;
      }
      __syncwarp();  // every lane has read its entries before lane 0 rewrites them
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int s = s0 + u * NWARPS;
        if (s >= nseg) break;
        unsigned bits = 0;
        if (e[u] != NO_ENTRY) {  // warp-uniform
          const int lo = s << 5, hi = min(lo + 32, N);
          int f = nx[u];
          unsigned m = 1u << lane;
          // after round r: m = the walk's positions f^k(p) inside the
          // segment for k < 2^(r+1), f = f^(2^(r+1))(p), absorbed at hi
#pragma unroll
          for (int r = 0; r < 5; ++r) {
            const int src = (f - lo) & 31;
            const unsigned mv = __shfl_sync(FULL, m, src);
            const int fv = __shfl_sync(FULL, f, src);
            if (f < hi) {
              m |= mv;
              f = fv;
            }
          }
          const int el = (int)e[u] - lo;
          const unsigned all = __shfl_sync(FULL, m, el);
          const int out = __shfl_sync(FULL, f, el);  // J[entry]
          bits = nv - lo >= 32 ? all : all & ((1u << (nv - lo)) - 1);  // the starts < n_valid
          const unsigned past = all & ~bits;
          const int end = past ? lo + __ffs(past) - 1 : out;
          if (end >= nv && lane == 0) s_end = end;  // the walk's first position >= n_valid
        }
        if (lane == 0) mask[s] = bits;
      }
    }
    __syncthreads();

    // 5. step index of every start: exclusive prefix count of the mask
    // bits, each thread over a contiguous run of words; the first
    // num_steps starts' positions replace the jumps
    const int per = (nseg + NTHREADS - 1) / NTHREADS;
    const int w0 = min(t * per, nseg), w1 = min(w0 + per, nseg);
    int mine[1] = {0}, total[1];
    for (int w = w0; w < w1; ++w) mine[0] += __popc(mask[w]);
    block_exclusive_scan<1>(mine, total, scan_scratch);
    int s = mine[0];
    for (int w = w0; w < w1 && s < num_steps; ++w) {
      for (unsigned m = mask[w]; m && s < num_steps; m &= m - 1) {
        jump[s++] = (Pos)((w << 5) + __ffs(m) - 1);
      }
    }
    if (t == 0) {
      s_ncmd = min(total[0], num_steps);
      s_tail = (int)ch.data[rowoff + min(s_end, N - 1)];  // the head of a finished block
    }
  } else if (t == 0) {
    s_ncmd = s_tail = 0;
  }
  cluster.sync();  // every block's starts, count and tail byte are in

  // 6. writes, a tile of R rows x G blocks at a time: warp w gathers 32
  // rows of block w % G, thread t stores row t / G of block t % G
  constexpr int R = NTHREADS / G;
  __shared__ int tl[G][R + 4], tv[G][R + 4];  // padded: the stores' reads avoid bank conflicts
  const int gw = warp % G, rw = warp / G * 32 + lane;  // gather: block, tile row
  const int gs = t % G, rs = t / G;                     // store: block, tile row
  const int bw = base + gw, bs = base + gs;
  const Pos* pos = nullptr;
  int ncmd = 0, tail = 0;
  if (bw < B) {
    if constexpr (SMEM) {
      pos = cluster.map_shared_rank(jump, gw);
    } else {
      pos = gjump + (long long)bw * N;
    }
    ncmd = *cluster.map_shared_rank(&s_ncmd, gw);
    tail = *cluster.map_shared_rank(&s_tail, gw);
  }
  const long long off = (long long)bw * N;
  for (int r0 = rank * R; r0 < num_steps; r0 += WUNROLL * G * R) {
    int2 cmd[WUNROLL];  // WUNROLL tiles' loads in flight at once
#pragma unroll
    for (int u = 0; u < WUNROLL; ++u) cmd[u] = make_int2(-1, tail);  // a dead row
    if (bw < B) {      // warp-uniform
      int p[WUNROLL];  // a dead row reads position 0, and drops what it read
#pragma unroll
      for (int u = 0; u < WUNROLL; ++u) {
        const int r = r0 + u * G * R + rw;
        p[u] = r < ncmd ? pos[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < WUNROLL; ++u) {
        const int2 c = ch.command(off + p[u]);
        if (r0 + u * G * R + rw < ncmd) cmd[u] = c;
      }
    }
#pragma unroll
    for (int u = 0; u < WUNROLL; ++u) {
      const int r1 = r0 + u * G * R;  // CTA-uniform
      if (r1 >= num_steps) break;
      tl[gw][rw] = cmd[u].x;
      tv[gw][rw] = cmd[u].y;
      __syncthreads();
      if (bs < B && r1 + rs < num_steps) {
        op_len[(long long)(r1 + rs) * B + bs] = tl[gs][rs];
        op_val[(long long)(r1 + rs) * B + bs] = tv[gs][rs];
      }
      __syncthreads();
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

size_t smem_bytes(int N) {  // mask words, then the u16 jumps
  return (size_t)((N + 31) >> 5) * sizeof(unsigned) + (size_t)N * sizeof(uint16_t);
}

// the shared-memory kernel's limit and carveout, set before each launch
template <bool DP>
cudaError_t smem_setup(int N) {
  const void* kern = (const void*)cover_kernel<true, DP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes(N));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

int grid(int B) { return (B + G - 1) / G * G; }  // whole clusters

template <bool DP>
int launch_cover(Choices<DP> ch, const void* n_valid, void* op_len, void* op_val, void* gjump,
                 void* gmask, int B, int N, int num_steps, cudaStream_t s) {
  if (N <= 32768) {
    const cudaError_t e = smem_setup<DP>(N);
    if (e != cudaSuccess) return (int)e;
    cover_kernel<true, DP><<<grid(B), NTHREADS, smem_bytes(N), s>>>(
        ch, (const int*)n_valid, (int*)op_len, (int*)op_val, nullptr, nullptr, B, N,
        num_steps);
  } else {
    cover_kernel<false, DP><<<grid(B), NTHREADS, 0, s>>>(
        ch, (const int*)n_valid, (int*)op_len, (int*)op_val, (int*)gjump, (unsigned*)gmask, B,
        N, num_steps);
  }
  return launch_status();
}

}  // namespace

// data [B, N] u8; delta, mlen [B, N] i32; n_valid [B] i32; op_len, op_val
// [num_steps, B] i32 out; gstep [B, N] i32 and gmask [B, ceil(N / 32)] u32
// scratch when N > 32768 (the jumps, then the starts' positions; the mask
// words), else unused (may be null).
NLZM_API int nlzm_greedy_cover(const void* data, const void* delta, const void* mlen,
                               const void* n_valid, void* op_len, void* op_val, void* gstep,
                               void* gmask, int B, int N, int num_steps, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0 || N == 0 || num_steps == 0) return 0;
  const Choices<false> ch{(const uint8_t*)data, (const int*)delta, (const int*)mlen, nullptr, 1};
  return launch_cover(ch, n_valid, op_len, op_val, gstep, gmask, B, N, num_steps,
                      (cudaStream_t)stream);
}

// data [B, N] u8; delta [B, N, C] i32; choice_len, choice_cand [B, N] i32;
// n_valid [B] i32; op_len, op_val [num_steps, B] i32 out; gstep, gmask as
// for nlzm_greedy_cover.
NLZM_API int nlzm_dp_cover(const void* data, const void* delta, const void* choice_len,
                           const void* choice_cand, const void* n_valid, void* op_len,
                           void* op_val, void* gstep, void* gmask, int B, int N, int C,
                           int num_steps, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || N == 0 || num_steps == 0) return 0;
  const Choices<true> ch{(const uint8_t*)data, (const int*)delta, (const int*)choice_len,
                         (const int*)choice_cand, C};
  return launch_cover(ch, n_valid, op_len, op_val, gstep, gmask, B, N, num_steps,
                      (cudaStream_t)stream);
}

// CTAs of the cover kernel resident on the whole device at block length N
// (dp != 0: the dp_cover entry), in clusters of G, as the occupancy
// calculator gives them; negative: a CUDA error.
NLZM_API int nlzm_cover_ctas_resident(int N, int dp, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  const bool smem = N <= 32768;
  cudaError_t e = cudaSuccess;
  if (smem) e = dp ? smem_setup<true>(N) : smem_setup<false>(N);
  if (e != cudaSuccess) return -(int)e;
  const void* kern = dp ? (smem ? (const void*)cover_kernel<true, true>
                                : (const void*)cover_kernel<false, true>)
                        : (smem ? (const void*)cover_kernel<true, false>
                                : (const void*)cover_kernel<false, false>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem ? smem_bytes(N) : 0;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return e == cudaSuccess ? clusters * G : -(int)e;
}
