// v1 block entropy decode, one LZ command per step.
//
// Replaces nlzm_tpu/ops/decode_v2.py::fsm_decode_v2 (with _step,
// _frame_init, _cdf_read, _bits_read, _family_update, _win_load2,
// _win_byte). The TPU version keeps every block's model as block-minor
// tensors and advances all blocks one command per scan step, with one-hot
// contractions standing in for per-block gathers and scatters.
//
// Design: one warp per block (a CTA of 32 threads), the blocks of a batch
// in parallel, each walking its own command chain.
// - The block's 72 x 17 CDF bank (4,896 bytes) lives in shared memory,
//   laid out as nlzm_tpu_torch/ops/cdf_ops.py. Lane j < 17 owns fence j of
//   every row: it reads it, and adapts it toward the mixin target of the
//   decoded symbol, row[j] += (target - row[j]) >> 7 (arithmetic shift, as
//   in JAX). No lane ever touches another lane's fence, so the bank needs
//   no barrier. The targets are computed from mixin_tensor's definition
//   (cdf_ops.py), not stored.
// - A read: symbol y = popc(ballot(f >= row[j])) over j = 1..16; start and
//   the next fence come by __shfl_sync (lane 17 holds 0, as the JAX
//   one-hot of y + 1 = 17 gives).
// - The rANS lanes, the bit reader, the frame cursor and the rep table are
//   warp-uniform registers, computed by every lane alike.
// - Every read runs, predicated as in JAX: a read whose predicate is false
//   still yields its symbol from the current lane and row and changes
//   nothing, so steps past a block's end emit exactly the JAX pair. After
//   the terminator step no state changes, so the pair of that step is
//   written to every later step at once.
// - Stream bytes follow the JAX clamps exactly: frame headers and lane
//   seeds use _byte (index clipped to the padded row), renorm and raw-bit
//   bytes the word rule of _win_load2/_win_byte (byte off - 4 base of the
//   window of words clip(base + k)). Positions wrap as i32, u32 state as
//   u32. No load leaves the row.
//
// Bound: the latency of the serial chain of a step, up to six dependent
// CDF reads (shared-memory load, ballot, two shuffles, a multiply, a byte
// load) and two bit reads; there are only B warps (245 at the 8 MB bench
// config, under two per SM), so nothing hides that latency. Neither bytes
// (the streams are read once) nor operations come close.
#include "common.cuh"

namespace {

constexpr int NCTX = 72;
constexpr int NF = 17;  // fences per row
constexpr int FULL = 1 << 14;
constexpr int ADAPT_BIAS = (1 << 7) - 1;  // (1 << CDF_ADAPT_BITS) - 1
constexpr unsigned ALL = 0xffffffffu;

// context layout (ops/cdf_ops.py)
constexpr int CTX_CMD = 0, CTX_LIT_HI = 1, CTX_LIT_LO = 2, CTX_LEN_DIRECT = 18,
              CTX_LEN_EXT_HI = 19, CTX_LEN_EXT_LO = 20, CTX_DIST_HI = 36, CTX_DIST_LO = 40;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int ctx_size(int c) {
  return c == CTX_CMD ? 4 : ((c == CTX_LEN_DIRECT || c >= CTX_DIST_HI) ? 8 : 16);
}

struct Stream {
  const unsigned char* __restrict__ row;  // the block's padded stream
  int S;                                  // padded length (multiple of 4)
  int W;                                  // S / 4 words

  // _byte: index clipped to [0, S - 1]
  __device__ __forceinline__ unsigned byte(int pos) const { return __ldg(row + clampi(pos, 0, S - 1)); }

  __device__ __forceinline__ unsigned be32(int pos) const {
    return (byte(pos) << 24) | (byte(wadd(pos, 1)) << 16) | (byte(wadd(pos, 2)) << 8) |
           byte(wadd(pos, 3));
  }

  __device__ __forceinline__ unsigned le32(int pos) const {
    return byte(pos) | (byte(wadd(pos, 1)) << 8) | (byte(wadd(pos, 2)) << 16) |
           (byte(wadd(pos, 3)) << 24);
  }

  // _win_byte over the window of nw words loaded at word `base`
  __device__ __forceinline__ unsigned win_byte(int base, int nw, int off) const {
    const int j = (int)((unsigned)off - ((unsigned)base << 2));
    const int w = clampi(base + clampi(j >> 2, 0, nw - 1), 0, W - 1);
    return __ldg(row + 4 * w + (j & 3));
  }
};

struct State {
  unsigned rans[4];
  int lane, rans_pos, rbase, reads;
  unsigned word;
  int word_bits, bit_pos, bbase;
};

__device__ __forceinline__ unsigned lane_state(const State& s) {
  return s.lane == 0 ? s.rans[0] : s.lane == 1 ? s.rans[1] : s.lane == 2 ? s.rans[2] : s.rans[3];
}

__device__ __forceinline__ void set_lane_state(State& s, unsigned v) {
  s.rans[0] = s.lane == 0 ? v : s.rans[0];
  s.rans[1] = s.lane == 1 ? v : s.rans[1];
  s.rans[2] = s.lane == 2 ? v : s.rans[2];
  s.rans[3] = s.lane == 3 ? v : s.rans[3];
}

// _cdf_read on bank row ctx; n = the row's symbol count (its mixin class)
__device__ __forceinline__ int cdf_read(int* bank, int ctx, int n, bool pred, State& s,
                                        const Stream& in, int tid) {
  const unsigned x = lane_state(s);
  const int f = (int)(x & 0x3FFFu);
  int* r = bank + ctx * NF;
  const int fence = tid < NF ? r[tid] : 0;
  const int y = __popc(__ballot_sync(ALL, tid >= 1 && tid < NF && f >= fence));
  const int start = __shfl_sync(ALL, fence, y);
  const int hi = __shfl_sync(ALL, fence, y + 1);
  const unsigned x2 = (unsigned)(hi - start) * (x >> 14) + (unsigned)(f - start);
  if (pred) {
    unsigned x3 = x2;
    if (x2 < (1u << 16)) {
      const unsigned b0 = in.win_byte(s.rbase, 4, s.rans_pos);
      const unsigned b1 = in.win_byte(s.rbase, 4, wadd(s.rans_pos, 1));
      x3 = (x2 << 16) | (b0 << 8) | b1;
      s.rans_pos = wadd(s.rans_pos, 2);
    }
    set_lane_state(s, x3);
    s.lane = (s.lane + 1) & 3;
    s.reads += 1;
    if (tid < NF) {  // adaptation toward mixin_tensor()[class, min(y, n - 1)]
      const int yc = min(y, n - 1);
      const int target = tid >= n ? FULL : (tid <= yc ? tid : FULL + tid + ADAPT_BIAS - n);
      r[tid] = fence + ((target - fence) >> 7);
    }
  }
  return y;
}

// _bits_read: MSB-first field of nb (<= 24) bits where pred
__device__ __forceinline__ int bits_read(int nb, bool pred, State& s, const Stream& in) {
  if (!pred) return 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (s.word_bits < 24) {
      const unsigned byte = in.win_byte(s.bbase, 3, s.bit_pos);
      s.word |= byte << clampi(24 - s.word_bits, 0, 31);
      s.bit_pos = wadd(s.bit_pos, 1);
      s.word_bits += 8;
    }
  }
  nb = clampi(nb, 0, 24);
  const int v = nb > 0 ? (int)(s.word >> clampi(32 - nb, 0, 31)) : 0;
  s.word <<= nb;
  s.word_bits -= nb;
  return v;
}

__global__ void __launch_bounds__(32)
    fsm_decode_kernel(const unsigned char* __restrict__ data, int B, int S, int T,
                      int* __restrict__ op_len, int* __restrict__ op_val) {
  __shared__ int bank[NCTX * NF];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const Stream in{data + (long long)b * S, S, S >> 2};

  if (tid < NF) {  // initial_bank(): uniform fences, pads at full scale
    for (int c = 0; c < NCTX; ++c) {
      const int n = ctx_size(c);
      bank[c * NF + tid] = tid < n ? tid * (FULL / n) : FULL;
    }
  }

  State s{};
  int num_ops = 0, frame_ptr = 0;
  bool done = false;
  int rep[4] = {1, 2, 3, 4};

  for (int t = 0; t < T; ++t) {
    if (!done && num_ops == 0) {  // _frame_init
      const int hdr_ops = (int)in.be32(frame_ptr);
      const int nb_bytes = (int)in.be32(wadd(frame_ptr, 4));
      const int nr_bytes = (int)in.be32(wadd(frame_ptr, 8));
      if (hdr_ops == 0) {
        done = true;
      } else {
        const int rans_base = wadd(frame_ptr, nb_bytes);
        num_ops = hdr_ops;
        s.bit_pos = wadd(frame_ptr, 12);
        s.word = 0;
        s.word_bits = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) s.rans[k] = in.le32(wadd(rans_base, 4 * k));
        s.lane = 0;
        s.rans_pos = wadd(rans_base, 16);
        frame_ptr = wadd(rans_base, nr_bytes);
      }
    }
    const bool active = !done;
    s.rbase = s.rans_pos >> 2;
    s.bbase = s.bit_pos >> 2;
    s.reads = 0;

    // R0: command
    const int y0 = cdf_read(bank, CTX_CMD, 4, active, s, in, tid);
    const bool is_lit = active && y0 == 0;
    const bool is_dict = active && y0 == 1;
    const bool is_rep = active && y0 >= 2;
    const bool is_match = is_dict || is_rep;
    // B0: rep slot index
    const int rep_idx = bits_read(2, is_rep, s, in);
    int bits_reads = is_rep ? 1 : 0;
    // R1: literal hi nibble | direct length
    const int y1 = cdf_read(bank, is_lit ? CTX_LIT_HI : CTX_LEN_DIRECT, is_lit ? 16 : 8,
                            active, s, in, tid);
    const bool esc = is_match && y1 == 7;
    const int lc = min(y1, 3);
    // R2: literal lo nibble | length-extension hi
    const int y2 = cdf_read(bank, is_lit ? CTX_LIT_LO + y1 : CTX_LEN_EXT_HI, 16, is_lit || esc,
                            s, in, tid);
    // R3: length-extension lo
    const int y3 = cdf_read(bank, CTX_LEN_EXT_LO + (esc ? y2 : 0), 16, esc, s, in, tid);
    const int lv = esc ? 7 + (y2 << 4) + y3 : y1;
    // R4: distance slot hi (context: length class)
    const int y4 = cdf_read(bank, CTX_DIST_HI + (is_dict ? lc : 0), 8, is_dict, s, in, tid);
    // R5: distance slot lo (context: length class * 8 + hi slot)
    const int y5 =
        cdf_read(bank, CTX_DIST_LO + (is_dict ? (lc << 3) + y4 : 0), 8, is_dict, s, in, tid);

    // distance: both raw-bit fields in one read
    const int dv_slot = (y4 << 3) + y5;
    const bool small = dv_slot < 4;
    const int ab = clampi((dv_slot >> 1) - 1, 0, 30);
    const bool need_bits = is_dict && !small;
    const int extra = bits_read(need_bits ? ab : 0, need_bits, s, in);
    bits_reads += need_bits ? 1 + (ab > 4 ? 1 : 0) : 0;
    const int dv = small ? dv_slot : (int)(((unsigned)(2 + (dv_slot & 1)) << ab) + (unsigned)extra);

    // emit
    const int delta_dict = wadd(dv, 1);
    const int ri = clampi(rep_idx, 0, 3);
    const int delta_rep = ri == 0 ? rep[0] : ri == 1 ? rep[1] : ri == 2 ? rep[2] : rep[3];
    const int delta = is_rep ? delta_rep : delta_dict;
    const int mmin = 2 + (delta > 0xFF) + (delta > 0xFFF) + (delta > 0xFFFFF);
    const int out_len = active ? (is_match ? lv + mmin : 0) : -1;
    const int out_val = is_lit ? (y1 << 4) + y2 : delta;
    if (tid == 0) {
      op_len[(long long)t * B + b] = out_len;
      op_val[(long long)t * B + b] = out_val;
    }

    // rep MTF insert of fresh dict distances
    const bool present = rep[0] == delta_dict || rep[1] == delta_dict ||
                         rep[2] == delta_dict || rep[3] == delta_dict;
    if (is_dict && !present) {
      rep[3] = rep[2];
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = delta_dict;
    }
    num_ops = (int)((unsigned)num_ops - (unsigned)s.reads - (unsigned)bits_reads);

    if (done) {  // frozen from here on: every later step emits this pair
      for (int u = t + 1 + tid; u < T; u += 32) {
        op_len[(long long)u * B + b] = out_len;
        op_val[(long long)u * B + b] = out_val;
      }
      break;
    }
  }
}

}  // namespace

// data [B, S] u8 (S a multiple of 4, zero padded); op_len/op_val [T, B] i32.
NLZM_API int nlzm_fsm_decode(const void* data, void* op_len, void* op_val, int B, int S, int T,
                             int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || T == 0) return 0;
  fsm_decode_kernel<<<B, 32, 0, (cudaStream_t)stream>>>((const unsigned char*)data, B, S, T,
                                                        (int*)op_len, (int*)op_val);
  return launch_status();
}
