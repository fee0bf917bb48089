// v1 model emission: the CDF spans and raw-bit fields of a command stream.
//
// Replaces nlzm_tpu/ops/encode_ops.py::emit_model (with _span_of, _adapt,
// _fam_row, _fam_set). The TPU version carries every family of CDF rows
// per block through a scan over the commands, with one-hot contractions
// for the row reads and writes.
//
// Bound: the longest chain of dependent row updates, and the bytes. A
// bank row changes only on a read of that row, toward a target set by the
// read's symbol, and the encoder knows every symbol; so the 72 rows of a
// block are 72 independent chains. The longest are row 0 (the command)
// and rows 1/18 (R1), one read per command: at the 8 MiB bench shape (8
// KiB blocks, 1024 blocks, T = 8192 steps) the longest block has 5,702
// commands. The commands are read once and the spans and fields written
// once: 436 MB, 0.130 ms at 3.35 TB/s.
//
// Design: a CTA holds NB = 8 adjacent blocks and walks the steps in
// chunks of C = 512, in phases separated by barriers.
// 1. All 512 threads, lane-adjacent blocks: thread (t, b) loads command
//    t of block b (coalesced: a step's 8 blocks are one 32-byte sector),
//    works out from it alone what its six reads code, stores the four
//    raw-bit fields (coalesced the same way), adds its coded items to
//    nops, clears its spans in the chunk's span tile, and writes one
//    entry per read group into shared memory: group A (R0 and R1, every
//    active command), B (R2), C (R3), D (R4 and R5, dictionary matches),
//    each with the step and the rows and symbols it reads. A read of the
//    JAX zero row (a literal above 255, a length extension above 255)
//    needs no state and gets no entry: its span is 0.
// 2. Each warp compacts two of the 32 entry lists in step order by a
//    ballot. Then each warp replays one read slot for several blocks: a
//    group of G lanes a block (G = 4 for R0's 4-symbol row, 16 for R1,
//    R2 and R3, 8 for R4 and R5), lane j owning fence j of the slot's rows
//    and walking its block's entries. A read costs each lane one fence:
//    adapt it toward the mixin target of the symbol, row[j] += (target -
//    row[j]) >> 7 (arithmetic shift, as in JAX); the group's first lane
//    gathers fences y and y + 1 by shuffle (full scale from G up, 0
//    outside 0..16: the JAX one-hot) and writes the span to the tile.
//    Rows 0, 1, 18 and 36-39 live in the registers of their lanes; the
//    others in the block's 72 x 17 bank in shared memory (laid out as
//    nlzm_tpu_torch/ops/cdf_ops.py). No two lanes touch one fence, so the
//    bank needs no barrier. Warp 0 takes R0 of the 8 blocks, warps 1-4
//    R1 (2 blocks each), 5-8 R2 then R3, 9-10 R4 and 11-12 R5 (4 each): a
//    warp's walk is only as long as its slot's reads, and every
//    instruction serves 2-8 blocks.
// 3. All threads store the tile: a step's 8 x 6 spans are 192 contiguous
//    bytes of spans [T, B, 6].
// Shared memory: banks 8 x 4,896 bytes, entries 4 x 8 x 516 x 4, the
// span tile 512 x 8 x 6 x 4, counts: 203,680 bytes, one CTA an SM, at any
// T (the wide optimal encode's T = 32768 too).
#include "common.cuh"

namespace {

constexpr int NCTX = 72;
constexpr int NF = 17;  // fences per row
constexpr int FULL = 1 << 14;
constexpr int ADAPT_BIAS = (1 << 7) - 1;  // (1 << CDF_ADAPT_BITS) - 1
constexpr unsigned ALL = 0xffffffffu;
constexpr int NB = 8;                    // blocks per CTA
constexpr int C = 512;                   // steps per chunk
constexpr int THREADS = 2 * NB * 32;     // two warps a block
constexpr int PASSES = C * NB / THREADS;  // phase 1 steps per thread
constexpr int ES = C + 4;                // entry row stride: phase 1's stores hit 32 banks
constexpr int BANK_INTS = NCTX * NF;
constexpr size_t SMEM_BYTES =
    sizeof(int) * (size_t)(NB * BANK_INTS + 4 * NB * ES + C * NB * 6 + NB + 4 * NB);
constexpr unsigned VALID = 0x80000000u;

// context layout (ops/cdf_ops.py)
constexpr int CTX_CMD = 0, CTX_LIT_HI = 1, CTX_LIT_LO = 2, CTX_LEN_DIRECT = 18,
              CTX_LEN_EXT_HI = 19, CTX_LEN_EXT_LO = 20, CTX_DIST_HI = 36, CTX_DIST_LO = 40;

__device__ __forceinline__ int ctx_size(int c) {
  return c == CTX_CMD ? 4 : ((c == CTX_LEN_DIRECT || c >= CTX_DIST_HI) ? 8 : 16);
}

// Entries (bit 31: valid; bits 0-9: the step in the chunk):
//   A: y0 << 10 | (R1 on row 18) << 12 | (y1 + 2) << 13
//   B, C: row << 10 | (y + 2) << 17
//   D: lc << 10 | dhi << 12 | dlo << 15
// Symbols are clamped to [-2, 17]: outside 0..16 only whether y and
// y + 1 are fences matters.
__device__ __forceinline__ unsigned sym(int y) { return (unsigned)(clampi(y, -2, 17) + 2); }

struct Command {
  unsigned e[4];         // group entries
  int va, nba, vb, nbb;  // raw-bit fields
  int items;             // coded spans + raw-bit fields
};

// what command (L, V, R) at chunk step t codes, as _emit_commands in
// ops/encode_ops.py
__device__ __forceinline__ Command command(int L, int V, int R, int t) {
  Command c;
  const bool active = L >= 0;
  const bool is_lit = active && L == 0;
  const bool is_match = active && L > 0;
  const bool is_rep = is_match && R >= 0;
  const bool is_dict = is_match && R < 0;

  const int delta = max(V, 1);
  const int mmin = 2 + (delta > 0xFF) + (delta > 0xFFF) + (delta > 0xFFFFF);
  const int lv = max((int)((unsigned)L - (unsigned)mmin), 0);  // i32 wrap, as JAX
  const int lc = min(lv, 3);
  const bool esc = is_match && lv >= 7;
  const int ext = max(lv - 7, 0);
  const int ehi = ext >> 4, elo = ext & 15;
  const int hi_nib = is_lit ? (V >> 4) : 0;
  const int lo_nib = V & 15;

  const int dv = delta - 1;
  const int nbits = clampi(32 - __clz(max(dv, 1)), 1, 31);  // bit length of dv
  const bool big = dv >= 4;
  const int ab = big ? nbits - 2 : 0;
  const int slot = big ? ((nbits - 1) << 1) + ((dv >> ab) & 1) : dv;
  const int extra = dv & ((1 << ab) - 1);
  const int dhi = slot >> 3, dlo = slot & 7;

  const unsigned ts = (unsigned)t;
  c.e[0] = active ? VALID | ts | (unsigned)(is_lit ? 0 : (is_rep ? 2 : 1)) << 10 |
                        (unsigned)!is_lit << 12 | sym(is_lit ? hi_nib : min(lv, 7)) << 13
                  : 0u;
  const bool lit_row = is_lit && hi_nib >= 0 && hi_nib < 16;  // else the zero row
  c.e[1] = (lit_row || esc) ? VALID | ts | (unsigned)(lit_row ? CTX_LIT_LO + hi_nib : CTX_LEN_EXT_HI) << 10 |
                                  sym(is_lit ? lo_nib : ehi) << 17
                            : 0u;
  c.e[2] = (esc && ehi < 16) ? VALID | ts | (unsigned)(CTX_LEN_EXT_LO + ehi) << 10 | sym(elo) << 17
                             : 0u;
  c.e[3] = is_dict ? VALID | ts | (unsigned)lc << 10 | (unsigned)dhi << 12 | (unsigned)dlo << 15
                   : 0u;

  const bool has_bits = is_dict && ab > 0;
  c.nba = is_rep ? 2 : ((has_bits && ab > 4) ? ab - 4 : 0);
  c.va = is_rep ? R : (c.nba > 0 ? extra >> 4 : 0);
  c.nbb = has_bits ? min(ab, 4) : 0;
  c.vb = has_bits ? (extra & ((1 << c.nbb) - 1)) : 0;
  c.items = 2 * active + (is_lit || esc) + esc + 2 * is_dict +
            (is_rep ? 1 : (has_bits ? 1 + (ab > 4) : 0));
  return c;
}

// (row, symbol) of slot S's read in entry e; the symbol count of a row
template <int S>
__device__ __forceinline__ void decode(unsigned e, int& r, int& y) {
  if (S == 0) r = CTX_CMD, y = (e >> 10) & 3;
  if (S == 1) r = (e >> 12) & 1 ? CTX_LEN_DIRECT : CTX_LIT_HI, y = (int)((e >> 13) & 31) - 2;
  if (S == 2 || S == 3) r = (e >> 10) & 127, y = (int)((e >> 17) & 31) - 2;
  if (S == 4) r = CTX_DIST_HI + ((e >> 10) & 3), y = (e >> 12) & 7;
  if (S == 5) r = CTX_DIST_LO + (((e >> 10) & 3) << 3) + ((e >> 12) & 7), y = (e >> 15) & 7;
}

// fence i of a row whose fence i < G the lane of the G-lane group holds
// as v: fences G..16 are full scale (G >= the row's symbol count), and
// outside 0..16 the JAX one-hot gives 0
__device__ __forceinline__ int fence_at(int i, int G, int v) {
  return (i >= 0 && i < G) ? v : (i >= G && i < NF ? FULL : 0);
}

// The fences of the rows a lane keeps in registers: fence j of row 0
// (slot 0), of rows 1 and 18 (slot 1), of rows 36-39 (slot 4).
struct Regs {
  int f[4];
};

// Replay of slot S's reads of one chunk by a warp of 32 / G blocks, lane
// (g, j) owning fence j of the rows of block b0 + g: each group walks its
// block's entries (list + g * ES, len of them), in step order.
template <int S, int G>
__device__ __forceinline__ void replay(int* banks, const unsigned* list, int len, int steps,
                                       int* tile, int bl, int lane, Regs& regs) {
  const int j = lane % G, first = lane - j;
  int* bank = banks + bl * BANK_INTS;
  // two entries in flight: measured faster than a loop of one
#pragma unroll 2
  for (int k = 0; k < steps; ++k) {
    const bool on = k < len;
    const unsigned e = on ? list[k] : 0u;
    int r = 0, y = 0, f = 0;
    decode<S>(e, r, y);
    const int n = ctx_size(r);
    if (S == 0) f = regs.f[0];
    if (S == 1) f = r == CTX_LEN_DIRECT ? regs.f[1] : regs.f[0];
    if (S == 4) {
      const int c = r - CTX_DIST_HI;
      f = c == 0 ? regs.f[0] : c == 1 ? regs.f[1] : c == 2 ? regs.f[2] : regs.f[3];
    }
    if (S == 2 || S == 3 || S == 5) f = bank[r * NF + j];
    // fences y and y + 1 from their lanes (j = G and up: full scale)
    const int lo = __shfl_sync(ALL, f, first + clampi(y, 0, G - 1));
    const int hi = __shfl_sync(ALL, f, first + clampi(y + 1, 0, G - 1));
    if (on && j >= 1 && j < n) {
      const int target = j <= y ? j : FULL + j + ADAPT_BIAS - n;  // mixin_tensor()[class, y]
      const int nf = f + ((target - f) >> 7);
      if (S == 0) regs.f[0] = nf;
      if (S == 1) {
        if (r == CTX_LEN_DIRECT) regs.f[1] = nf; else regs.f[0] = nf;
      }
      if (S == 4) {
        const int c = r - CTX_DIST_HI;
        regs.f[0] = c == 0 ? nf : regs.f[0];
        regs.f[1] = c == 1 ? nf : regs.f[1];
        regs.f[2] = c == 2 ? nf : regs.f[2];
        regs.f[3] = c == 3 ? nf : regs.f[3];
      }
      if (S == 2 || S == 3 || S == 5) bank[r * NF + j] = nf;
    }
    if (on && j == 0) {
      const int start = fence_at(y, G, lo), next = fence_at(y + 1, G, hi);
      tile[((e & 1023) * NB + bl) * 6 + S] = (int)(((unsigned)(next - start) << 16) | (unsigned)start);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    emit_model_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                      const int* __restrict__ op_rep, int T, int B, int* __restrict__ spans,
                      int* __restrict__ va, int* __restrict__ nba, int* __restrict__ vb,
                      int* __restrict__ nbb, int* __restrict__ nops) {
  extern __shared__ int smem[];
  int* banks = smem;                                     // [NB][72 * 17]
  unsigned* ents = (unsigned*)(banks + NB * BANK_INTS);  // [4][NB][ES]
  int* tile = (int*)(ents + 4 * NB * ES);                // [C][NB][6]
  unsigned* nops_acc = (unsigned*)(tile + C * NB * 6);   // [NB]
  int* lens = (int*)(nops_acc + NB);                     // [4][NB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * NB;
  for (int i = tid; i < NB * BANK_INTS; i += THREADS) {  // initial_bank()
    const int c = (i % BANK_INTS) / NF, j = i % NF, n = ctx_size(c);
    banks[i] = j < n ? j * (FULL / n) : FULL;
  }
  if (tid < NB) nops_acc[tid] = 0;
  __syncthreads();

  // phase 1's thread: block bl1, steps tt1 + 64 p
  const int bl1 = tid % NB, tt1 = tid / NB;
  const int gb1 = b0 + bl1;
  unsigned items = 0;
  // phase 2's warp: slot S for blocks bw .. bw + 32 / G - 1 (warps 13-15
  // only compact)
  const int S = warp == 0 ? 0 : warp <= 4 ? 1 : warp <= 8 ? 2 : warp <= 10 ? 4 : warp <= 12 ? 5 : -1;
  const int G = S == 0 ? 4 : (S == 4 || S == 5) ? 8 : 16;
  const int bw = S == 0 ? 0 : S == 1 ? 2 * (warp - 1) : S == 2 ? 2 * (warp - 5)
               : S == 4 ? 4 * (warp - 9) : 4 * (warp - 11);
  const int bl2 = bw + lane / G;  // this lane's block
  const int grp = (S == 0 || S == 1) ? 0 : S == 2 ? 1 : 3;  // its entry group
  Regs regs;
  {
    const int j = lane % G;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // the register rows' initial fences
      const int row = S == 0 ? CTX_CMD : S == 1 ? (c == 0 ? CTX_LIT_HI : CTX_LEN_DIRECT)
                                                : CTX_DIST_HI + c;
      const int n = ctx_size(row);
      regs.f[c] = j < n ? j * (FULL / n) : FULL;
    }
  }

  for (int t0 = 0; t0 < T; t0 += C) {
    if (t0 > 0) __syncthreads();  // the tile and entries of the last chunk are free
    // ---- phase 1: commands, fields, entries
    int Ls[PASSES], Vs[PASSES], Rs[PASSES];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int t = t0 + tt1 + p * (THREADS / NB);
      Ls[p] = -1, Vs[p] = 0, Rs[p] = -1;
      if (t < T && gb1 < B) {
        const long long at = (long long)t * B + gb1;
        Ls[p] = op_len[at], Vs[p] = op_val[at], Rs[p] = op_rep[at];
      }
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int tl = tt1 + p * (THREADS / NB), t = t0 + tl;
      const Command c = command(Ls[p], Vs[p], Rs[p], tl);
      if (t < T && gb1 < B) {
        const long long at = (long long)t * B + gb1;
        va[at] = c.va, nba[at] = c.nba, vb[at] = c.vb, nbb[at] = c.nbb;
        items += (unsigned)c.items;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) ents[(g * NB + bl1) * ES + tl] = c.e[g];
#pragma unroll
      for (int s = 0; s < 6; ++s) tile[(tl * NB + bl1) * 6 + s] = 0;
    }
    __syncthreads();

    // ---- phase 2a: each warp compacts two of the 4 x NB entry lists in
    // step order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int li = 2 * warp + h;  // group li / NB, block li % NB
      unsigned* l = ents + li * ES;
      int count = 0;
      for (int base = 0; base < C; base += 32) {
        const unsigned e = l[base + lane];
        const unsigned has = __ballot_sync(ALL, (e & VALID) != 0);
        if (e & VALID) l[count + __popc(has & ((1u << lane) - 1))] = e;
        count += __popc(has);
      }
      if (lane == 0) lens[li] = count;
    }
    __syncthreads();

    // ---- phase 2b: the replay, slot by slot
    if (S >= 0) {
      const int len = lens[grp * NB + bl2];
      const unsigned* list = ents + (grp * NB + bl2) * ES;
      const int steps = __reduce_max_sync(ALL, len);
      switch (S) {
        case 0: replay<0, 4>(banks, list, len, steps, tile, bl2, lane, regs); break;
        case 1: replay<1, 16>(banks, list, len, steps, tile, bl2, lane, regs); break;
        case 2: {
          replay<2, 16>(banks, list, len, steps, tile, bl2, lane, regs);
          const int len3 = lens[2 * NB + bl2];  // then R3, on the same lanes
          replay<3, 16>(banks, ents + (2 * NB + bl2) * ES, len3, __reduce_max_sync(ALL, len3),
                        tile, bl2, lane, regs);
          break;
        }
        case 4: replay<4, 8>(banks, list, len, steps, tile, bl2, lane, regs); break;
        default: replay<5, 8>(banks, list, len, steps, tile, bl2, lane, regs);
      }
    }
    __syncthreads();

    // ---- phase 3: the span tile out, a step's 8 x 6 spans contiguous
    const int nt = min(C, T - t0);
    for (int i = tid; i < nt * NB * 3; i += THREADS) {
      const int tl = i / (NB * 3), w = i % (NB * 3), bl = w / 3;
      if (b0 + bl < B) {
        const int* src = tile + (tl * NB + bl) * 6 + (w % 3) * 2;
        reinterpret_cast<int2*>(spans)[(((long long)(t0 + tl) * B + b0 + bl) * 6) / 2 + w % 3] =
            make_int2(src[0], src[1]);
      }
    }
  }

  // nops: threads of one block sit NB lanes apart
  items += __shfl_xor_sync(ALL, items, 8);
  items += __shfl_xor_sync(ALL, items, 16);
  if (lane < NB) atomicAdd(&nops_acc[lane], items);
  __syncthreads();
  if (tid < NB && b0 + tid < B) nops[b0 + tid] = (int)nops_acc[tid];
}

}  // namespace

// op_len, op_val, op_rep [T, B] i32; spans [T, B, 6] i32 (u32 bits); the
// fields va, nba, vb, nbb [T, B] i32; nops [B] i32.
NLZM_API int nlzm_emit_model(const void* op_len, const void* op_val, const void* op_rep,
                             void* spans, void* va, void* nba, void* vb, void* nbb, void* nops,
                             int T, int B, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(emit_model_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  emit_model_kernel<<<(B + NB - 1) / NB, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int*)op_len, (const int*)op_val, (const int*)op_rep, T, B, (int*)spans, (int*)va,
      (int*)nba, (int*)vb, (int*)nbb, (int*)nops);
  return launch_status();
}
