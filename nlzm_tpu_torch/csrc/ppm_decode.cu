// NLZC decode: 32 segment lanes a block, two nibble reads a byte against
// 2 x 4096-row chunk-static tables built from halved carries, group
// backoff and the container prior.
//
// Replaces nlzm_tpu/research/ppm_tpu.py::_decode_blocks (run, chunk_body,
// step_body, read_one, build_jnp). On the TPU each chunk rebuilt all 8,192
// rows of a block's tables, a read selected each lane's row with a one-hot
// [B, 32, 4096] contraction on the MXU and accumulated counts with another.
//
// Bound: each block's serial chain (steps x 2 dependent reads and renorms,
// the ballot that ranks a read's renorms) and the rows a chunk reads. A
// chunk reads at most 2 x 32 x 16 = 1,024 rows of its block (about 320 at
// the bench, ~4% of 8,192), and a row's fences matter only in a chunk
// that reads it. Design: one CTA of 256 threads a block, two CTAs an SM.
// - Carries live in device memory as u16 [8192, 16] (scratch); a row's
//   stamp (shared memory) is the chunk + 1 of its last fold. A carry no
//   chunk added to only halves, so the carries a chunk c builds from are
//   K >> (c - stamp), exact for integers, and 0 (not loaded) once c -
//   stamp >= 10, as every carry is at most 1023; a row never folded has
//   stamp -10. A row is folded (K = (K >> (c + 1 - stamp)) + counts,
//   stamp c + 1) only at the end of a chunk that read it: no chunk writes
//   a row it did not read.
// - Warp 0 decodes, one lane a segment. A read looks its row up in a map
//   (row -> slot of this chunk). Live lanes whose row has no slot yet are
//   a batch: distinct rows get slots (one lane a row leads, by a mark in
//   shared memory; leaders in lane order), then the rows are built by the
//   warps that have one (the eight wait at a named barrier), a
//   quarter-warp a row, a lane two symbols as u16 pairs: the group sum of its 16 rows (once a chunk a group; a
//   group first seen in this batch is summed by every quarter-warp that
//   needs it, identical values), eff = K + gs / 2 + 8 * prior + 2, the
//   row total by shuffles, freq = 1 + eff * (2^14 - 16) / (tot + 1) as a
//   float quotient corrected by one step each way (exact: eff * 16368 <
//   2^26, eff <= tot and tot + 1 <= 34,207 for a prior in 0..255, which
//   the wrapper checks), fences by an 8-lane scan, as u16.
// - A slot's 15 inner fences (and 2^14) are 32 bytes: the first CACHE
//   slots in shared memory, the rest in device memory (scratch), read
//   through one generic pointer. The read counts the fences <= f = x &
//   0x3FFF, reads the two around f again, ranks its renorm among the block's
//   lanes by ballot + popc, reads the big-endian pair from the window (34
//   words at the step's cursor >> 2, clamped to the stream as JAX clamps
//   it) in shared memory - or, for a stream longer than the CTA's budget,
//   in device memory - and logs (slot, symbol) as one u16.
// - At a chunk's end every warp folds the slots: the halved carries into
//   the slot's 32 bytes (fences no longer read), the log's counts added by
//   shared atomics on u16 pairs, the carries stored back. The fold after
//   the last chunk, which no output reads, is skipped.
#include "common.cuh"

#ifndef NLZM_PPM_CACHE
#define NLZM_PPM_CACHE 576  // slots in shared memory; the bench reads at most ~520 rows a chunk
#endif

namespace {

constexpr int LANES = 32;
constexpr int ROWS = 4096;
constexpr int KEYS = 2 * ROWS;  // (table, row)
constexpr int GROUP = 16;
constexpr int GROUPS = KEYS / GROUP;
constexpr int NS = 16;  // symbols (nibbles) a row
constexpr int PRIOR_W = 8;
constexpr int BLEND = 2;
constexpr int WIN_H = 2 * ((2 * LANES * 2) / 4 + 2);  // JAX's window, in halfwords
constexpr int THREADS = 256;
static_assert(THREADS / 8 >= LANES, "a quarter-warp a row of a batch");
constexpr int MARK = 0x8000;  // a lane's claim on a row, in the row's slot + 1 word
constexpr int MAX_CHUNK = 16;  // CHUNK_STEPS: the longest chunk of chunk_schedule
constexpr int SLOTS = 2 * LANES * MAX_CHUNK;  // the most rows a chunk can read
constexpr int CACHE = NLZM_PPM_CACHE;
constexpr unsigned FULL = 0xffffffffu;
// halvings that take any carry (at most 1023) to 0: a row halved this
// often reads as 0 and is not loaded; a row never folded has stamp
// -HALVINGS
constexpr int HALVINGS = 10;
static_assert(CACHE >= 1 && CACHE <= SLOTS, "cache slots");
// the tables scratch of a block, in ints: every slot's 32 bytes (those
// past CACHE are used) and the counters of BuiltCounter
constexpr int TABLES_INTS = SLOTS * NS / 2 + 8;

// shared memory, in bytes
constexpr int OFF_STAMP = 0;                      // int [KEYS]
constexpr int OFF_GTAG = OFF_STAMP + 4 * KEYS;    // int [GROUPS]: batch that summed the group
constexpr int OFF_CTRL = OFF_GTAG + 4 * GROUPS;   // int [16]: command, counters
constexpr int OFF_SLOT1 = OFF_CTRL + 64;          // u16 [KEYS]: slot + 1 in this chunk, 0 none
constexpr int OFF_GSUM = OFF_SLOT1 + 2 * KEYS;    // u16 [GROUPS, NS]
constexpr int OFF_SKEY = OFF_GSUM + 2 * KEYS;     // u16 [SLOTS]: a slot's key
constexpr int OFF_LOG = OFF_SKEY + 2 * SLOTS;     // u16 [SLOTS]: (slot << 4 | symbol) a lane read
constexpr int OFF_BKEY = OFF_LOG + 2 * SLOTS;     // u16 [LANES]: the batch's keys
constexpr int OFF_CACHE = OFF_BKEY + 2 * LANES;   // u16 [CACHE, NS]
constexpr int OFF_WORDS = OFF_CACHE + 2 * NS * CACHE;
constexpr int SMEM_MAX = 113 * 1024;  // two CTAs an SM
constexpr int SW_MAX = (SMEM_MAX - OFF_WORDS) / 16 * 4;  // stream words in shared memory
static_assert(OFF_CACHE % 16 == 0 && OFF_WORDS % 16 == 0 && SW_MAX >= LANES, "layout");

enum Cmd { CMD_BUILD = 1, CMD_FOLD = 2, CMD_DONE = 3 };
// per-block counters, at the end of the block's tables scratch
enum BuiltCounter { N_ROWS, N_GROUPS, N_GSUMS, N_BATCHES, N_SPILLED, N_COUNTERS };

int smem_bytes(int W) { return OFF_WORDS + (W <= SW_MAX ? (W + 3) / 4 * 16 : 0); }

__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// floor(n / d) for 0 <= n < 2^26 and n / d < 2^14 (here n = eff * 16368
// and d = tot + 1 > eff): the fast float quotient (__fdividef, its
// relative error a few 2^-24) is within one of the floor, and one step
// each way makes it exact
__device__ __forceinline__ int quot(int n, int d) {
  int q = __float2int_rz(__fdividef(__int2float_rn(n), __int2float_rn(d)));
  const int r = n - q * d;
  q += (r >= d) - (r < 0);
  return q;
}

struct Block {
  int* stamp;
  int* gtag;
  int* ctrl;
  uint16_t* slot1;
  uint16_t* gsum;
  uint16_t* skey;
  uint16_t* log;
  uint16_t* bkey;
  uint16_t* cache;
  uint16_t* K;      // the block's carries [KEYS, NS] (device memory)
  uint16_t* spill;  // the slots past CACHE (device memory)
  const int* prior;

  __device__ __forceinline__ uint16_t* area(int j) const {
    return j < CACHE ? cache + j * NS : spill + (j - CACHE) * NS;
  }
};

// Build the rows of slots [lo, hi) (a batch, at most 32) for chunk c:
// quarter-warp q takes slot lo + q (its key bkey[q]), a lane two symbols
// 2k, 2k + 1 as u16 pairs. Every thread of the CTA calls. batch: this batch's id; b0: the
// chunk's first. n_groups, n_gsums: the caller's counts of distinct
// groups summed this chunk and of group sums.
__device__ __forceinline__ void build_rows(const Block& t, int lo, int hi, int c, int batch, int b0,
                                           int& n_groups, int& n_gsums) {
  const int k = threadIdx.x & 7, i0 = threadIdx.x >> 3;
  // a warp none of whose quarters has a row skips the build
  if ((i0 & ~3) < hi - lo) {
    const bool act = i0 < hi - lo;
    const int key = t.bkey[act ? i0 : 0];
    const int g = key >> 4, ri = key & 15;
    const unsigned* Kg = reinterpret_cast<const unsigned*>(t.K + g * (GROUP * NS)) + k;
    const int2 p = __ldg(reinterpret_cast<const int2*>(t.prior + key * NS) + k);
    const int tag = t.gtag[g];
    // a group summed by an earlier batch of this chunk needs only the row
    const bool have = tag >= b0 && tag < batch;
    // the group's rows (none where the group is summed), then the row
    int sh[GROUP];
#pragma unroll
    for (int i4 = 0; i4 < GROUP; i4 += 4) {
      const int4 st = reinterpret_cast<const int4*>(t.stamp + g * GROUP)[i4 >> 2];
      sh[i4] = min(c - st.x, 31);
      sh[i4 + 1] = min(c - st.y, 31);
      sh[i4 + 2] = min(c - st.z, 31);
      sh[i4 + 3] = min(c - st.w, 31);
    }
    const int lim = have ? 0 : HALVINGS;
    unsigned v[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) v[i] = sh[i] < lim ? Kg[i * (NS / 2)] : 0u;
    const int shr = min(c - t.stamp[key], 31);
    const unsigned vr = shr < HALVINGS ? Kg[ri * (NS / 2)] : 0u;
    // u16 pairs: a carry is at most 1023 and a group sum at most 16368
    unsigned gs = 0;
#pragma unroll
    for (int i = 0; i < GROUP; ++i) gs += (v[i] >> sh[i]) & ((0xFFFFu >> sh[i]) * 0x10001u);
    const unsigned kr = (vr >> shr) & ((0xFFFFu >> shr) * 0x10001u);
    if (have) gs = reinterpret_cast<const unsigned*>(t.gsum + g * NS)[k];
    if (act && !have) {
      reinterpret_cast<unsigned*>(t.gsum + g * NS)[k] = gs;
      if (k == 0) {
        n_groups += atomicExch(&t.gtag[g], batch) < b0;
        ++n_gsums;
      }
    }
    const int e0 = (int)(kr & 0xFFFFu) + (int)((gs & 0xFFFFu) >> 1) + PRIOR_W * p.x + BLEND;
    const int e1 = (int)(kr >> 16) + (int)(gs >> 17) + PRIOR_W * p.y + BLEND;
    int tot = e0 + e1;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) tot += __shfl_xor_sync(FULL, tot, o);
    const int f0 = 1 + quot(e0 * (CDF_TOTAL - NS), tot + 1);
    const int f1 = 1 + quot(e1 * (CDF_TOTAL - NS), tot + 1);
    int inc = f0 + f1;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const int w = __shfl_up_sync(FULL, inc, o, 8);
      if (k >= o) inc += w;
    }
    // fences 2k + 1 and 2k + 2, the last pinned at 2^14
    if (act)
      reinterpret_cast<unsigned*>(t.area(lo + i0))[k] =
          (unsigned)(inc - f1) | (unsigned)(k < 7 ? inc : CDF_TOTAL) << 16;
  }
}

// The end of chunk c (clen steps, nsl slots): every slot's row gets K =
// (K >> (c + 1 - stamp)) + its counts and stamp c + 1. All threads call;
// a thread takes slots tid, tid + THREADS, ..., a row as two 16-byte
// words of u16 pairs.
__device__ __forceinline__ void fold(const Block& t, int nsl, int clen, int c) {
  constexpr int PER = SLOTS / THREADS;
  uint4 v[PER][2];
#pragma unroll
  for (int u = 0; u < PER; ++u) {  // every load in flight at once
    const int j = threadIdx.x + u * THREADS;
    const int key = j < nsl ? t.skey[j] : 0;
    const int sh = min(c + 1 - t.stamp[key], 31);
    const uint4* src = reinterpret_cast<const uint4*>(t.K + key * NS);
    const uint4 z = make_uint4(0, 0, 0, 0);
    v[u][0] = j < nsl && sh < HALVINGS ? src[0] : z;
    v[u][1] = j < nsl && sh < HALVINGS ? src[1] : z;
    const unsigned m = (0xFFFFu >> sh) * 0x10001u;  // halves of u16 pairs, shifted apart
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      v[u][q].x = (v[u][q].x >> sh) & m;
      v[u][q].y = (v[u][q].y >> sh) & m;
      v[u][q].z = (v[u][q].z >> sh) & m;
      v[u][q].w = (v[u][q].w >> sh) & m;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = threadIdx.x + u * THREADS;
    if (j < nsl) {
      uint4* a = reinterpret_cast<uint4*>(t.area(j));
      a[0] = v[u][0];
      a[1] = v[u][1];
    }
  }
  team_sync();
  for (int e = threadIdx.x; e < 2 * LANES * clen; e += THREADS) {
    const int l = t.log[e];
    if (l != 0xFFFF)
      atomicAdd(reinterpret_cast<unsigned*>(t.area(l >> 4)) + ((l & 15) >> 1),
                1u << (16 * (l & 1)));
  }
  team_sync();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = threadIdx.x + u * THREADS;
    if (j < nsl) {
      const int key = t.skey[j];
      const uint4* a = reinterpret_cast<const uint4*>(t.area(j));
      uint4* dst = reinterpret_cast<uint4*>(t.K + key * NS);
      dst[0] = a[0];
      dst[1] = a[1];
      t.stamp[key] = c + 1;
      t.slot1[key] = 0;
    }
  }
}

// f's symbol y in a row of u16 fences F[0..15] (F[j] = fence j + 1, F[15]
// = 2^14, increasing): the count of F[0..14] <= f; then start = F[y - 1]
// (0 at y = 0) and end = F[y] are read again from the row.
__device__ __forceinline__ void find_symbol(const uint16_t* Fp, int f, int& y, int& start,
                                            int& end) {
  const uint4 q0 = reinterpret_cast<const uint4*>(Fp)[0];
  const uint4 q1 = reinterpret_cast<const uint4*>(Fp)[1];
  const unsigned w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  int n = 0;
#pragma unroll
  for (int j = 0; j < 15; ++j) n += f >= (int)((w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu);
  y = n;
  end = Fp[n];
  start = n ? Fp[n - 1] : 0;
}

template <bool SW>
__global__ void __launch_bounds__(THREADS, 2)
    ppm_decode_kernel(const unsigned* __restrict__ words, const int* __restrict__ seg_lens,
                      const int* __restrict__ prior, const int* __restrict__ sched,
                      uint16_t* __restrict__ carry_all, int* __restrict__ tables_all,
                      uint8_t* __restrict__ out, int W, int steps, int NC) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* tables = tables_all + (size_t)b * TABLES_INTS;
  Block t;
  t.stamp = reinterpret_cast<int*>(sm + OFF_STAMP);
  t.gtag = reinterpret_cast<int*>(sm + OFF_GTAG);
  t.ctrl = reinterpret_cast<int*>(sm + OFF_CTRL);
  t.slot1 = reinterpret_cast<uint16_t*>(sm + OFF_SLOT1);
  t.gsum = reinterpret_cast<uint16_t*>(sm + OFF_GSUM);
  t.skey = reinterpret_cast<uint16_t*>(sm + OFF_SKEY);
  t.log = reinterpret_cast<uint16_t*>(sm + OFF_LOG);
  t.bkey = reinterpret_cast<uint16_t*>(sm + OFF_BKEY);
  t.cache = reinterpret_cast<uint16_t*>(sm + OFF_CACHE);
  t.K = carry_all + (size_t)b * KEYS * NS;
  t.spill = reinterpret_cast<uint16_t*>(tables);
  t.prior = prior;
  const unsigned* wb = words + (size_t)b * W;
  unsigned* sw = reinterpret_cast<unsigned*>(sm + OFF_WORDS);

  for (int i = tid; i < KEYS; i += THREADS) {
    t.stamp[i] = -HALVINGS;
    t.slot1[i] = 0;
  }
  for (int i = tid; i < GROUPS; i += THREADS) t.gtag[i] = 0;
  if (tid < 16) t.ctrl[tid] = 0;
  if (SW) {  // the stream into shared memory, 16 bytes a load where aligned
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(wb) & 15) == 0) {
      const int n4 = W >> 2;
      for (int i = tid; i < n4; i += THREADS)
        reinterpret_cast<uint4*>(sw)[i] = __ldg(reinterpret_cast<const uint4*>(wb) + i);
      done = n4 << 2;
    }
    for (int i = done + tid; i < W; i += THREADS) sw[i] = __ldg(wb + i);
  }
  __syncthreads();
  const unsigned* ws = SW ? sw : wb;
  int n_groups = 0, n_gsums = 0;  // this thread's counts (lanes k = 0 of a build)

  if (warp != 0) {  // the team: build batches and fold chunks on warp 0's command
    for (;;) {
      team_sync();
      const int cmd = t.ctrl[0];
      if (cmd == CMD_DONE) break;
      if (cmd == CMD_BUILD)
        build_rows(t, t.ctrl[1], t.ctrl[2], t.ctrl[4], t.ctrl[3], t.ctrl[5], n_groups, n_gsums);
      else
        fold(t, t.ctrl[1], t.ctrl[2], t.ctrl[4]);
      team_sync();
    }
  } else {  // the chain
    const int seg = seg_lens[b * LANES + lane];
    unsigned x = ws[lane];
    int cursor = 4 * LANES, prev = 0, prev2 = 0, s = 0, nsl = 0, batch = 0;
    int n_rows = 0, n_spilled = 0;
    uint8_t* ob = out + (size_t)b * steps * LANES + lane;
    for (int c = 0; c < NC; ++c) {
      const int clen = sched[c];
      const int b0 = batch + 1;
      for (int i = 0; i < clen; ++i, ++s) {
        const bool a = s < seg;
        const int base = cursor >> 2;
        int sym[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = r == 0 ? (prev << 4) | (prev2 >> 4) : ROWS + ((sym[0] << 8) | prev);
          int sp = a ? t.slot1[key] : 1;
          if (__ballot_sync(FULL, sp == 0)) {  // a batch: rows without a slot
            // one lane a distinct row leads: each marks the row, the last
            // mark stands (slot + 1 is at most SLOTS, a mark above it)
            if (sp == 0) t.slot1[key] = (uint16_t)(MARK + lane);
            __syncwarp();
            const int leader = sp == 0 ? t.slot1[key] - MARK : lane;
            const bool lead = sp == 0 && leader == lane;
            const unsigned lm = __ballot_sync(FULL, lead);
            const int j = nsl + __popc(lm & ((1u << lane) - 1u));
            if (lead) {
              t.skey[j] = (uint16_t)key;
              t.bkey[j - nsl] = (uint16_t)key;
              t.slot1[key] = (uint16_t)(j + 1);
            }
            const int jl = __shfl_sync(FULL, j, leader);  // the row's slot, from its leader
            if (sp == 0) sp = jl + 1;
            const int lo = nsl, n = __popc(lm);
            nsl += n;
            ++batch;
            n_rows += n;
            n_spilled += max(0, nsl - max(lo, CACHE));
            if (lane == 0) {
              t.ctrl[0] = CMD_BUILD;
              t.ctrl[1] = lo;
              t.ctrl[2] = nsl;
              t.ctrl[3] = batch;
              t.ctrl[4] = c;
              t.ctrl[5] = b0;
            }
            team_sync();
            build_rows(t, lo, nsl, c, batch, b0, n_groups, n_gsums);
            team_sync();
          }
          const int f = (int)(x & 0x3FFFu);
          int y, start, end;
          find_symbol(t.area(sp - 1), f, y, start, end);
          const unsigned x2 = (unsigned)(end - start) * (x >> 14) + (unsigned)(f - start);
          const bool ren = a && x2 < 65536u;
          const unsigned m = __ballot_sync(FULL, ren);
          if (ren) {
            const int rank = __popc(m & ((1u << lane) - 1u));
            const int h = clampi((cursor + 2 * rank - 4 * base) >> 1, 0, WIN_H - 1);
            const unsigned w = ws[clampi(base + (h >> 1), 0, W - 1)];
            const unsigned half = (w >> (16 * (h & 1))) & 0xFFFFu;
            x = (x2 << 16) | ((half & 0xFFu) << 8) | (half >> 8);
          } else if (a) {
            x = x2;
          }
          cursor += 2 * __popc(m);
          sym[r] = a ? y : 0;
          t.log[(2 * i + r) * LANES + lane] = a ? (uint16_t)(((sp - 1) << 4) | y) : 0xFFFF;
        }
        const int byte = (sym[0] << 4) | sym[1];
        ob[(size_t)s * LANES] = (uint8_t)byte;
        if (a) {
          prev2 = prev;
          prev = byte;
        }
      }
      if (c + 1 < NC) {  // the fold; none after the last chunk
        __syncwarp();
        if (lane == 0) {
          t.ctrl[0] = CMD_FOLD;
          t.ctrl[1] = nsl;
          t.ctrl[2] = clen;
          t.ctrl[4] = c;
        }
        team_sync();
        fold(t, nsl, clen, c);
        team_sync();
        nsl = 0;
      }
    }
    if (lane == 0) {
      t.ctrl[0] = CMD_DONE;
      t.ctrl[8 + N_ROWS] = n_rows;
      t.ctrl[8 + N_BATCHES] = batch;
      t.ctrl[8 + N_SPILLED] = n_spilled;
    }
    team_sync();
  }
  n_groups = warp_sum(n_groups);
  n_gsums = warp_sum(n_gsums);
  if (lane == 0) {
    atomicAdd(&t.ctrl[8 + N_GROUPS], n_groups);
    atomicAdd(&t.ctrl[8 + N_GSUMS], n_gsums);
  }
  __syncthreads();
  if (tid < N_COUNTERS) tables[SLOTS * NS / 2 + tid] = t.ctrl[8 + tid];
}

// the dynamic shared-memory limit of both kernels, set once a device
cudaError_t smem_setup(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute((const void*)ppm_decode_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)ppm_decode_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return e;
}

}  // namespace

// words [B, W] u32 (W >= 32); seg_lens [B, 32] i32; prior [2, 4096, 16]
// i32, every value in 0..255 (the wrapper checks); sched [NC] i32 chunk
// lengths of chunk_schedule (sum = steps, each at most 16); carry [B, 8192,
// 16] u16 and tables [B, TABLES_INTS] i32 scratch, read only where this
// call wrote them (no initial value); out [B, steps, 32] u8. After the
// call a block's first N_COUNTERS ints past its slots in tables hold its
// counters: rows built, distinct groups summed, group sums, batches, rows
// in device-memory slots.
NLZM_API int nlzm_ppm_decode(const void* words, const void* seg_lens, const void* prior,
                             const void* sched, void* carry, void* tables, void* out, int B, int W,
                             int steps, int NC, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (W < LANES) return (int)cudaErrorInvalidValue;
  const cudaError_t e = smem_setup(device);
  if (e != cudaSuccess) return (int)e;
  const auto kernel = W <= SW_MAX ? ppm_decode_kernel<true> : ppm_decode_kernel<false>;
  kernel<<<B, THREADS, smem_bytes(W), (cudaStream_t)stream>>>(
      (const unsigned*)words, (const int*)seg_lens, (const int*)prior, (const int*)sched,
      (uint16_t*)carry, (int*)tables, (uint8_t*)out, W, steps, NC);
  return launch_status();
}

// The launch at B blocks of W words on this device: out[0..8] = threads,
// dynamic shared bytes, registers a thread (cudaFuncGetAttributes),
// resident CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs,
// stream words that fit shared memory (SW_MAX), cache slots, tables ints a
// block, and whether the stream is in shared memory.
NLZM_API int nlzm_ppm_shape(void* out_, int B, int W, int device, void* stream) {
  (void)B;
  (void)stream;
  cudaSetDevice(device);
  int* out = (int*)out_;
  const bool in_smem = W <= SW_MAX;
  const void* fn = in_smem ? (const void*)ppm_decode_kernel<true>
                           : (const void*)ppm_decode_kernel<false>;
  cudaError_t e = smem_setup(device);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, THREADS, smem_bytes(W));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[9] = {THREADS, smem_bytes(W), attr.numRegs, ctas, sms, SW_MAX, CACHE, TABLES_INTS,
                    in_smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
