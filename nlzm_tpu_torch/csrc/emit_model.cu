// v1 model emission: the CDF spans and raw-bit fields of a command stream.
//
// Replaces nlzm_tpu/ops/encode_ops.py::emit_model (with _span_of, _adapt,
// _fam_row, _fam_set). The TPU version carries every family of CDF rows
// per block through a scan over the commands, with one-hot contractions
// for the row reads and writes.
//
// Design: one warp per block (four blocks per CTA), the decoder's 72 x 17
// CDF bank in shared memory, laid out as nlzm_tpu_torch/ops/cdf_ops.py
// (the layout of csrc/fsm_decode.cu). Lane j < 17 owns fence j of every
// row and adapts it toward the mixin target of the coded symbol,
// row[j] += (target - row[j]) >> 7 (arithmetic shift, as in JAX); no lane
// touches another lane's fence, so the bank needs no barrier.
// - The warp loads 32 commands at once (lane j: step base + j; the next 32
//   are loaded before these are replayed). Each lane works out from its
//   command alone what the six reads code (row, symbol, size class), the
//   raw-bit fields and the coded-item count, all in parallel.
// - Then the steps that code anything are replayed in order: each read's
//   descriptor comes by shuffle, the lanes load their fences of the six
//   rows (distinct within a step), start and the next fence come by
//   shuffle, and the six rows are adapted. Lane j keeps step j's spans and
//   the warp stores the 32 steps together.
// - The encoder knows every symbol, so no search: start = row[y],
//   freq = row[y + 1] - start, 0 outside fences 0..16 (the JAX one-hot).
//   A family index out of range (a literal above 255, a length extension
//   above 255) reads the JAX zero row: span 0, no update.
//
// Bound: the latency of the serial chain of a step (shuffles, six shared
// loads and stores); the commands are read once and the outputs written
// once, far below the memory rate.
#include "common.cuh"

namespace {

constexpr int NCTX = 72;
constexpr int NF = 17;  // fences per row
constexpr int ZERO_ROW = NCTX;
constexpr int FULL = 1 << 14;
constexpr int ADAPT_BIAS = (1 << 7) - 1;  // (1 << CDF_ADAPT_BITS) - 1
constexpr unsigned ALL = 0xffffffffu;
constexpr int WARPS = 4;  // blocks per CTA

// context layout (ops/cdf_ops.py)
constexpr int CTX_CMD = 0, CTX_LIT_HI = 1, CTX_LIT_LO = 2, CTX_LEN_DIRECT = 18,
              CTX_LEN_EXT_HI = 19, CTX_LEN_EXT_LO = 20, CTX_DIST_HI = 36, CTX_DIST_LO = 40;

__device__ __forceinline__ int ctx_size(int c) {
  return c == CTX_CMD ? 4 : ((c == CTX_LEN_DIRECT || c >= CTX_DIST_HI) ? 8 : 16);
}

// a read: bank row (ZERO_ROW = codes nothing), symbol clamped to [-2, 17]
// (only whether y and y + 1 are fences matters outside), log2(n) - 2
__device__ __forceinline__ int pack(int row, int y, int cls) {
  return row | ((clampi(y, -2, 17) + 2) << 7) | (cls << 12);
}

struct Command {
  int d[6];            // the six reads
  int va, nba, vb, nbb;  // raw-bit fields
  int items;           // coded spans + raw-bit fields
  bool active;
};

// what command (L, V, R) codes, as _emit_commands in ops/encode_ops.py
__device__ __forceinline__ Command command(int L, int V, int R) {
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

  c.d[0] = pack(active ? CTX_CMD : ZERO_ROW, is_lit ? 0 : (is_rep ? 2 : 1), 0);
  c.d[1] = pack(is_lit ? CTX_LIT_HI : (active ? CTX_LEN_DIRECT : ZERO_ROW),
                is_lit ? hi_nib : min(lv, 7), is_lit ? 2 : 1);
  const int lit_lo = (hi_nib >= 0 && hi_nib < 16) ? CTX_LIT_LO + hi_nib : ZERO_ROW;
  c.d[2] = pack(is_lit ? lit_lo : (esc ? CTX_LEN_EXT_HI : ZERO_ROW), is_lit ? lo_nib : ehi, 2);
  c.d[3] = pack(esc && ehi < 16 ? CTX_LEN_EXT_LO + ehi : ZERO_ROW, elo, 2);
  c.d[4] = pack(is_dict ? CTX_DIST_HI + lc : ZERO_ROW, dhi, 1);
  c.d[5] = pack(is_dict ? CTX_DIST_LO + (lc << 3) + dhi : ZERO_ROW, dlo, 1);

  const bool has_bits = is_dict && ab > 0;
  c.nba = is_rep ? 2 : ((has_bits && ab > 4) ? ab - 4 : 0);
  c.va = is_rep ? R : (c.nba > 0 ? extra >> 4 : 0);
  c.nbb = has_bits ? min(ab, 4) : 0;
  c.vb = has_bits ? (extra & ((1 << c.nbb) - 1)) : 0;
  c.items = 2 * active + (is_lit || esc) + esc + 2 * is_dict +
            (is_rep ? 1 : (has_bits ? 1 + (ab > 4) : 0));
  c.active = active;
  return c;
}

__global__ void __launch_bounds__(WARPS * 32)
    emit_model_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                      const int* __restrict__ op_rep, int T, int B, int* __restrict__ spans,
                      int* __restrict__ va, int* __restrict__ nba, int* __restrict__ vb,
                      int* __restrict__ nbb, int* __restrict__ nops) {
  __shared__ int banks[WARPS][NCTX * NF];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warps; the kernel has no block-wide barrier
  int* bank = banks[warp];
  if (lane < NF) {  // initial_bank(): uniform fences, pads at full scale
    for (int c = 0; c < NCTX; ++c) {
      const int n = ctx_size(c);
      bank[c * NF + lane] = lane < n ? lane * (FULL / n) : FULL;
    }
  }

  unsigned items = 0;
  int L = -1, V = 0, R = -1;
  if (lane < T) {
    L = op_len[(long long)lane * B + b];
    V = op_val[(long long)lane * B + b];
    R = op_rep[(long long)lane * B + b];
  }
  for (int base = 0; base < T; base += 32) {
    const int nxt = base + 32 + lane;
    int Ln = -1, Vn = 0, Rn = -1;
    if (nxt < T) {
      Ln = op_len[(long long)nxt * B + b];
      Vn = op_val[(long long)nxt * B + b];
      Rn = op_rep[(long long)nxt * B + b];
    }
    const Command c = command(L, V, R);  // L = -1 past T: codes nothing
    items += (unsigned)c.items;

    int mine[6] = {0, 0, 0, 0, 0, 0};
    unsigned todo = __ballot_sync(ALL, c.active);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      int row[6], f[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const int d = __shfl_sync(ALL, c.d[s], j);
        row[s] = d;
        f[s] = (lane < NF && (d & 127) != ZERO_ROW) ? bank[(d & 127) * NF + lane] : 0;
      }
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const int d = row[s];
        const int r = d & 127;
        const int y = ((d >> 7) & 31) - 2;
        const int n = 4 << (d >> 12);
        const int at = __shfl_sync(ALL, f[s], clampi(y, 0, NF - 1));
        const int next = __shfl_sync(ALL, f[s], clampi(y + 1, 0, NF - 1));
        const int start = (y >= 0 && y < NF) ? at : 0;
        const int hi = (y >= -1 && y < NF - 1) ? next : 0;
        if (lane == j) mine[s] = (int)(((unsigned)(hi - start) << 16) | (unsigned)start);
        if (r != ZERO_ROW && lane < NF) {  // adaptation toward mixin_tensor()[class, min(y, n - 1)]
          const int yc = clampi(y, 0, n - 1);
          const int target = lane >= n ? FULL : (lane <= yc ? lane : FULL + lane + ADAPT_BIAS - n);
          bank[r * NF + lane] = f[s] + ((target - f[s]) >> 7);
        }
      }
    }

    const int t = base + lane;
    if (t < T) {
      const long long at = (long long)t * B + b;
      int2* sp = reinterpret_cast<int2*>(spans + at * 6);
      sp[0] = make_int2(mine[0], mine[1]);
      sp[1] = make_int2(mine[2], mine[3]);
      sp[2] = make_int2(mine[4], mine[5]);
      va[at] = c.va;
      nba[at] = c.nba;
      vb[at] = c.vb;
      nbb[at] = c.nbb;
    }
    L = Ln;
    V = Vn;
    R = Rn;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) items += __shfl_xor_sync(ALL, items, o);
  if (lane == 0) nops[b] = (int)items;
}

}  // namespace

// op_len, op_val, op_rep [T, B] i32; spans [T, B, 6] i32 (u32 bits); the
// fields va, nba, vb, nbb [T, B] i32; nops [B] i32.
NLZM_API int nlzm_emit_model(const void* op_len, const void* op_val, const void* op_rep,
                             void* spans, void* va, void* nba, void* vb, void* nbb, void* nops,
                             int T, int B, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  emit_model_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)op_len, (const int*)op_val, (const int*)op_rep, T, B, (int*)spans, (int*)va,
      (int*)nba, (int*)vb, (int*)nbb, (int*)nops);
  return launch_status();
}
