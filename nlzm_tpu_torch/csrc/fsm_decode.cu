// v1 block entropy decode, one LZ command per step.
//
// Replaces nlzm_tpu/ops/decode_v2.py::fsm_decode_v2 (with _step,
// _frame_init, _cdf_read, _bits_read, _family_update, _win_load2,
// _win_byte). The TPU version keeps every block's model as block-minor
// tensors and advances all blocks one command per scan step, running all
// six CDF reads and both raw-bit reads of every step under predicates,
// with one-hot contractions standing in for per-block gathers and
// scatters.
//
// Bound: the latency of one block's serial chain of commands. A step
// needs the symbols of the step before (the rows it reads, the rANS lane
// states, the stream cursors), so a block is one warp walking its
// commands; at the 8 MB bench config (32 KiB blocks, 245 blocks) the
// longest block has 16,667 commands (at the CLI's 128 KiB blocks 48,090),
// and there are only 245 warps on 132 SMs, so nothing hides the latency
// of a step: a warp issues in order, and each instruction that waits for
// a shuffle, a ballot or a shared load stalls the block. Neither bytes
// (the streams are read once) nor operations come close.
//
// Design: one warp per block; every choice below shortens a step.
// - Only the reads a command takes run on an active step: a literal is
//   R0, R1, R2; a dictionary match R0, R1, R4, R5 (+ R2, R3 with a length
//   escape) and one raw-bit field; a rep match R0, its 2-bit slot, R1 (+
//   R2, R3). The step's shape follows from R0's and R1's symbols by
//   warp-uniform branches, each with its own fixed lane rotation. A read
//   whose JAX predicate is false changes nothing and its symbol only feeds
//   the pair of a step past the block's end, so the full predicated step
//   runs once, at the terminator: every predicate is false there, all
//   reads see the unmoved lane, and the pair is (-1, the dictionary
//   distance of R4 on row 36 and R5 on row 40). It is written to that step
//   and every later one.
// - The rANS lane states of a step's first reads are known when it
//   starts: R0 reads lane q0, R1 lane q1, and R4 of an unescaped
//   dictionary match lane q2. So rows 0, 1 and 18 (R0 and both candidate
//   rows of R1: 3 + 15 + 7 live fences) live in the registers of lanes
//   0-27, and rows 36-39 (R4's four candidates) in lanes 0-31 (8 each),
//   and one compare and one ballot per group decode R0, R1 and R4 at
//   once. Lane j of a group holds fences j and j + 1 of its row (fence 0 is
//   always 0, fence n always 1 << 14: their adaptation targets equal their
//   values), so y = popc(ballot(f >= fence j)) - 1, and lane y's start,
//   frequency and new state come by one shuffle. Each lane adapts its own
//   two fences, so these rows need no memory at all. Speculating further
//   (R2's 16 literal rows, R5's 32 rows, eight candidates a lane), or
//   hoisting R1's shuffles above the literal/match branch, costs more
//   instructions than the latency it hides: measured slower.
// - The other 64 rows stay in shared memory (the bank, laid out as
//   nlzm_tpu_torch/ops/cdf_ops.py); lane j owns fence j of each, reads it
//   (fences y and y + 1 of the symbol come by shuffle) and writes it back
//   adapted, toward the mixin target of the decoded symbol (row[j] +=
//   (target - row[j]) >> 7, arithmetic shift, as in JAX; targets from
//   mixin_tensor's definition).
// - The stream is read from shared memory: a ring of 512 words per
//   cursor (rANS renorm bytes, raw-bit bytes). Inside a frame both
//   cursors only advance, so when a cursor enters the upper half of its
//   ring the warp refills the lower half with the next 256 words by
//   cp.async, and waits for them only when a step could reach them. The
//   ring is checked once per 16 steps (a step moves a cursor at most 3
//   words), so the steps themselves carry no ring branch: a renorm pair
//   is two shared byte loads, a raw-bit refill one byte permute of two
//   ring words. A frame init restages both rings (and waits). The steps'
//   pairs are stored once per group too, lane k keeping step k's.
// - The JAX clamps hold exactly: ring word v holds stream word
//   clip(v, 0, W - 1), which is what _win_byte reads for any position in
//   word v (the step's window never binds, its word clip does); frame
//   headers and lane seeds read _byte's clipped index from global memory.
//   A group whose cursor words are not all staged, or could wrap past the
//   i32 range inside the group (a corrupt stream: frame_ptr + nb_bytes
//   anywhere), runs the same steps through _win_byte's clamped global
//   loads instead. Positions wrap as i32, u32 state as u32. No load
//   leaves the row.
#include "common.cuh"

namespace {

constexpr int NCTX = 72;
constexpr int NF = 17;  // fences per row
constexpr int FULL = 1 << 14;
constexpr int ADAPT_BIAS = (1 << 7) - 1;  // (1 << CDF_ADAPT_BITS) - 1
constexpr int NONE = 0x7fffffff;          // a fence no f reaches: the lane is not in the read
constexpr unsigned ALL = 0xffffffffu;
constexpr int RW = 512;    // ring words per cursor
constexpr int HALF = RW / 2;
constexpr int GROUP = 16;  // steps between ring checks
constexpr int SPAN = 3 * GROUP + 3;  // words past its cursor word a group can read

// context layout (ops/cdf_ops.py)
constexpr int CTX_CMD = 0, CTX_LIT_HI = 1, CTX_LIT_LO = 2, CTX_LEN_DIRECT = 18,
              CTX_LEN_EXT_HI = 19, CTX_LEN_EXT_LO = 20, CTX_DIST_HI = 36, CTX_DIST_LO = 40;
// lane groups of the register rows: R0 on lanes 0-3, R1's literal row on
// 4-19, its length row on 20-27; R4's rows 36 + c on lanes 8c .. 8c + 7
constexpr unsigned G_CMD = 0xFu, G_LIT = 0xFFFF0u, G_LEN = 0xFF00000u;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int ctx_size(int c) {
  return c == CTX_CMD ? 4 : ((c == CTX_LEN_DIRECT || c >= CTX_DIST_HI) ? 8 : 16);
}

__device__ __forceinline__ int init_fence(int j, int n) { return j < n ? j * (FULL / n) : FULL; }

// fence j of an n-symbol row adapted after symbol y (mixin_tensor()[cls, y])
__device__ __forceinline__ int adapt(int f, int j, int y, int n) {
  if (j >= n) return f;
  const int target = j <= y ? j : FULL + j + ADAPT_BIAS - n;
  return f + ((target - f) >> 7);
}

// the rANS step of a read, given its slot's start and next fence
__device__ __forceinline__ unsigned rans_x2(unsigned x, int lo, int hi) {
  return (unsigned)(hi - lo) * (x >> 14) + (unsigned)((int)(x & 0x3FFFu) - lo);
}

__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// One cursor's window of the block's stream in shared memory: ring word
// v & (RW - 1) holds stream word clip(v, 0, W - 1) for v in [lo, lo + RW)
// (the upper half only once landed, while `pending`).
struct Ring {
  unsigned* w;
  int lo;
  bool pending;

  __device__ __forceinline__ void fill(const unsigned* row32, int W, int v0, int n, int lane) {
    for (int k = lane; k < n; k += 32) {
      const int v = v0 + k;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(w + (v & (RW - 1)))),
                   "l"(row32 + clampi(v, 0, W - 1))
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // restage around cursor word c (a frame init); waits
  __device__ __forceinline__ void reset(const unsigned* row32, int W, int c, int lane) {
    ring_wait();  // nothing in flight may land on the new words
    lo = c;
    fill(row32, W, c, RW, lane);
    ring_wait();
    pending = false;
  }

  // before a group of steps with cursor word c: slide, and whether every
  // word the group can read is staged and landed, with no i32 wrap of the
  // cursor inside the group
  __device__ __forceinline__ bool prepare(const unsigned* row32, int W, int c, int lane) {
    int rel = c - lo;  // word indices lie in [-2^29, 2^29): no overflow
    if (pending && rel + SPAN >= HALF) {
      ring_wait();
      pending = false;
    }
    if (!pending && rel >= HALF && rel < RW) {
      __syncwarp();  // every lane's reads of the half it refills are done
      lo += HALF;
      rel -= HALF;
      fill(row32, W, lo + HALF, HALF, lane);
      pending = true;
    }
    return rel >= 0 && rel + SPAN < (pending ? HALF : RW) && c < (1 << 29) - SPAN;
  }
};

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

// A step's stream bytes: from the rings (FAST), else through _win_byte's
// clamped global loads.
template <bool FAST>
struct Src {
  const unsigned char* rring;
  const unsigned* bring;
  const Stream& in;

  // the 16-bit renorm pair at byte offset off of a step at rans_pos pos
  __device__ __forceinline__ unsigned pair(int pos, int off) const {
    const int p = wadd(pos, off), p1 = wadd(pos, off + 1);
    if (FAST) return ((unsigned)rring[p & (4 * RW - 1)] << 8) | rring[p1 & (4 * RW - 1)];
    return (in.win_byte(pos >> 2, 4, p) << 8) | in.win_byte(pos >> 2, 4, p1);
  }

  // the bytes at bit_pos, big-endian (the first three)
  __device__ __forceinline__ unsigned be_bits(int bit_pos) const {
    if (FAST) {
      const int v = bit_pos >> 2, a = bit_pos & 3;
      return __byte_perm(bring[v & (RW - 1)], bring[(v + 1) & (RW - 1)],
                         (unsigned)((a + 3) | ((a + 2) << 4) | ((a + 1) << 8) | (a << 12)));
    }
    const int base = bit_pos >> 2;
    return (in.win_byte(base, 3, bit_pos) << 24) | (in.win_byte(base, 3, wadd(bit_pos, 1)) << 16) |
           (in.win_byte(base, 3, wadd(bit_pos, 2)) << 8);
  }
};

struct Dec {  // a block's decoder state; warp-uniform but the register rows
  unsigned q0, q1, q2, q3;  // the rANS lane states in read order
  int rans_pos, num_ops, frame_ptr;
  unsigned word;
  int word_bits, bit_pos;
  int rep0, rep1, rep2, rep3;
  int aLo, aHi, bLo, bHi;  // this lane's fences of the register rows
};

// _bits_read of nb bits (pred true): refill with the stream bytes at
// bit_pos while word_bits < 24 (at most three), then the MSB-first field
template <bool FAST>
__device__ __forceinline__ int bits_read(int nb, Dec& d, const Src<FAST>& src) {
  const int k = d.word_bits < 24 ? (24 - d.word_bits + 7) >> 3 : 0;
  if (k > 0) {
    d.word |= (src.be_bits(d.bit_pos) & ~(0xFFFFFFFFu >> (8 * k))) >> d.word_bits;
    d.bit_pos = wadd(d.bit_pos, k);
    d.word_bits += 8 * k;
  }
  nb = clampi(nb, 0, 24);
  const int v = nb > 0 ? (int)(d.word >> (32 - nb)) : 0;
  d.word <<= nb;
  d.word_bits -= nb;
  return v;
}

// A read of bank row r (n symbols) in shared memory with lane state x:
// returns the symbol; sets x2, the renormless next state (ren: x2 < 2^16).
__device__ __forceinline__ int shared_read(int* bank, int r, int n, unsigned x, int lane,
                                           unsigned& x2) {
  const int f = (int)(x & 0x3FFFu);
  int* row = bank + r * NF;
  const int lo = lane < NF ? row[lane] : NONE;
  const int y = __popc(__ballot_sync(ALL, f >= lo)) - 1;  // fence 0 = 0: lane 0 always counts
  x2 = rans_x2(x, __shfl_sync(ALL, lo, y), __shfl_sync(ALL, lo, y + 1));
  if (lane >= 1 && lane < n) row[lane] = adapt(lo, lane, y, n);
  return y;
}

// the symbol of a read on the register group `mask` from its lanes'
// ballot of f >= fence j (fence 0 = 0: the group's first lane always counts)
__device__ __forceinline__ int group_y(unsigned ballot_ge, unsigned mask) {
  return __popc(ballot_ge & mask) - 1;
}

// the dictionary distance of slot fields (y4, y5) and the extra bits
__device__ __forceinline__ int dict_delta(int dv_slot, int extra) {
  const int ab = clampi((dv_slot >> 1) - 1, 0, 30);
  const int dv = dv_slot < 4 ? dv_slot : (int)(((unsigned)(2 + (dv_slot & 1)) << ab) + (unsigned)extra);
  return wadd(dv, 1);
}

__device__ __forceinline__ int mmin_of(int delta) {
  return 2 + (delta > 0xFF) + (delta > 0xFFF) + (delta > 0xFFFFF);
}

// One active step: the command's reads, its emitted pair, the state moved.
template <bool FAST>
__device__ __forceinline__ void step(Dec& d, int* bank, const Src<FAST>& src, int lane,
                                     int& out_len, int& out_val) {
  const int pos = d.rans_pos;
  // the new lane state of a read: x2, renormed with the pair at byte
  // offset off of the step when x2 < 2^16 (off then advances by 2)
  int off = 0;
  auto renorm = [&](unsigned x2) -> unsigned {
    const unsigned pr = src.pair(pos, off);
    const bool ren = x2 < (1u << 16);
    off += ren ? 2 : 0;
    return ren ? (x2 << 16) | pr : x2;
  };

  // R0 and both candidates of R1 (lanes q0, q1), and R4's four
  // candidate rows on q2, in one compare per lane
  const unsigned xA = lane < 4 ? d.q0 : d.q1;
  const int fA = (int)(xA & 0x3FFFu);
  const unsigned x2A = rans_x2(xA, d.aLo, d.aHi);
  const unsigned geA = __ballot_sync(ALL, fA >= d.aLo);
  const int fB = (int)(d.q2 & 0x3FFFu);
  const unsigned x2B = rans_x2(d.q2, d.bLo, d.bHi);
  const unsigned geB = __ballot_sync(ALL, fB >= d.bLo);

  // new lane states n0.. of the step's reads R0.., in read order
  const int y0 = group_y(geA, G_CMD);
  const unsigned n0 = renorm(__shfl_sync(ALL, x2A, y0));
  int used, lane_y1;

  if (y0 == 0) {  // literal: R0, R1 (row 1), R2 (row 2 + y1)
    const int y1 = group_y(geA, G_LIT);
    const unsigned n1 = renorm(__shfl_sync(ALL, x2A, 4 + y1));
    unsigned x2;
    const int y2 = shared_read(bank, CTX_LIT_LO + y1, 16, d.q2, lane, x2);
    const unsigned n2 = renorm(x2);
    d.q0 = d.q3, d.q1 = n0, d.q2 = n1, d.q3 = n2;
    out_len = 0;
    out_val = (y1 << 4) + y2;
    used = 3;
    lane_y1 = (lane >= 4 && lane < 20) ? y1 : -1;
  } else {  // a match: R1 on row 18
    const int y1 = group_y(geA, G_LEN);
    const unsigned n1 = renorm(__shfl_sync(ALL, x2A, 20 + y1));
    lane_y1 = (lane >= 20 && lane < 28) ? y1 : -1;
    const bool esc = y1 == 7;
    int lv = y1;
    unsigned n2 = 0, n3 = 0;
    if (esc) {  // R2 (row 19), R3 (row 20 + y2)
      unsigned x2;
      const int y2 = shared_read(bank, CTX_LEN_EXT_HI, 16, d.q2, lane, x2);
      n2 = renorm(x2);
      const int y3 = shared_read(bank, CTX_LEN_EXT_LO + y2, 16, d.q3, lane, x2);
      n3 = renorm(x2);
      lv = 7 + (y2 << 4) + y3;
    }
    if (y0 == 1) {  // dictionary: R4 (row 36 + lc), R5, the extra bits
      const int lc = min(y1, 3);
      const unsigned gB = 0xFFu << (8 * lc);
      int y4;
      unsigned x2;
      if (!esc) {  // R4 on q2: the speculated compare
        y4 = group_y(geB, gB);
        x2 = __shfl_sync(ALL, x2B, 8 * lc + y4);
      } else {  // R4 on R0's new state
        const int f = (int)(n0 & 0x3FFFu);
        y4 = group_y(__ballot_sync(ALL, f >= d.bLo), gB);
        x2 = __shfl_sync(ALL, rans_x2(n0, d.bLo, d.bHi), 8 * lc + y4);
      }
      const unsigned n4 = renorm(x2);
      const int y5 = shared_read(bank, CTX_DIST_LO + (lc << 3) + y4, 8, esc ? n1 : d.q3, lane, x2);
      const unsigned n5 = renorm(x2);
      if ((lane >> 3) == lc) {  // adapt R4's row
        d.bLo = adapt(d.bLo, lane & 7, y4, 8);
        d.bHi = adapt(d.bHi, (lane & 7) + 1, y4, 8);
      }
      if (esc) {  // six reads: R4 and R5 took R0's and R1's lanes again
        d.q0 = n2, d.q1 = n3, d.q2 = n4, d.q3 = n5;
      } else {
        d.q0 = n0, d.q1 = n1, d.q2 = n4, d.q3 = n5;
      }
      const int dv_slot = (y4 << 3) + y5;
      int extra = 0, bit_reads = 0;
      if (dv_slot >= 4) {
        const int ab = clampi((dv_slot >> 1) - 1, 0, 30);
        extra = bits_read(ab, d, src);
        bit_reads = 1 + (ab > 4);
      }
      const int delta = dict_delta(dv_slot, extra);
      out_len = lv + mmin_of(delta);
      out_val = delta;
      used = (esc ? 6 : 4) + bit_reads;
      if (d.rep0 != delta && d.rep1 != delta && d.rep2 != delta && d.rep3 != delta) {
        d.rep3 = d.rep2, d.rep2 = d.rep1, d.rep1 = d.rep0, d.rep0 = delta;
      }
    } else {  // rep: the 2-bit slot index
      const int ri = clampi(bits_read(2, d, src), 0, 3);
      const int delta = ri == 0 ? d.rep0 : ri == 1 ? d.rep1 : ri == 2 ? d.rep2 : d.rep3;
      if (esc) {
        d.q0 = n0, d.q1 = n1, d.q2 = n2, d.q3 = n3;
      } else {
        d.q0 = d.q2, d.q1 = d.q3, d.q2 = n0, d.q3 = n1;
      }
      out_len = lv + mmin_of(delta);
      out_val = delta;
      used = (esc ? 4 : 2) + 1;
    }
  }
  d.rans_pos = wadd(pos, off);

  // adapt the register rows read: R0's row, and R1's
  if (lane < 4 || lane_y1 >= 0) {
    const int j = lane < 4 ? lane : (lane < 20 ? lane - 4 : lane - 20);
    const int n = lane < 4 ? 4 : (lane < 20 ? 16 : 8);
    const int y = lane < 4 ? y0 : lane_y1;
    d.aLo = adapt(d.aLo, j, y, n);
    d.aHi = adapt(d.aHi, j + 1, y, n);
  }
  d.num_ops = (int)((unsigned)d.num_ops - (unsigned)used);
}

// steps t .. end - 1, or up to the first whose frame's op budget it
// spends; lane k keeps step t + k's pair, and the group's pairs are
// stored together at its end
template <bool FAST>
__device__ __forceinline__ int run(Dec& d, int* bank, const Src<FAST>& src, int lane, int t,
                                   int end, int B, int b, int* op_len, int* op_val) {
  const int t0 = t;
  int my_len = 0, my_val = 0;
  for (; t < end;) {
    int len, val;
    step<FAST>(d, bank, src, lane, len, val);
    my_len = lane == t - t0 ? len : my_len;
    my_val = lane == t - t0 ? val : my_val;
    ++t;
    if (d.num_ops == 0) break;
  }
  if (lane < t - t0) {
    op_len[(long long)(t0 + lane) * B + b] = my_len;
    op_val[(long long)(t0 + lane) * B + b] = my_val;
  }
  return t;
}

__global__ void __launch_bounds__(32)
    fsm_decode_kernel(const unsigned char* __restrict__ data, int B, int S, int T,
                      int* __restrict__ op_len, int* __restrict__ op_val) {
  __shared__ int bank[NCTX * NF];
  __shared__ unsigned ring_words[2][RW];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const Stream in{data + (long long)b * S, S, S >> 2};
  const unsigned* row32 = reinterpret_cast<const unsigned*>(in.row);

  if (lane < NF) {  // initial_bank(): uniform fences, pads at full scale
    for (int c = 0; c < NCTX; ++c) bank[c * NF + lane] = init_fence(lane, ctx_size(c));
  }
  // register rows: A (R0 and R1: rows 0, 1, 18 on lanes 0-27), B (R4)
  const int aJ = lane < 4 ? lane : (lane < 20 ? lane - 4 : lane - 20);
  const int aN = lane < 4 ? 4 : (lane < 20 ? 16 : 8);
  Dec d{};
  d.aLo = lane < 28 ? init_fence(aJ, aN) : NONE;
  d.aHi = lane < 28 ? init_fence(aJ + 1, aN) : NONE;
  d.bLo = init_fence(lane & 7, 8);
  d.bHi = init_fence((lane & 7) + 1, 8);
  d.rep0 = 1, d.rep1 = 2, d.rep2 = 3, d.rep3 = 4;
  __syncwarp();

  Ring rr{ring_words[0], 0, false}, br{ring_words[1], 0, false};
  const Src<true> fast_src{reinterpret_cast<const unsigned char*>(ring_words[0]), ring_words[1], in};
  const Src<false> slow_src{nullptr, nullptr, in};

  for (int t = 0; t < T;) {
    if (d.num_ops == 0) {  // _frame_init
      const int hdr_ops = (int)in.be32(d.frame_ptr);
      const int nb_bytes = (int)in.be32(wadd(d.frame_ptr, 4));
      const int nr_bytes = (int)in.be32(wadd(d.frame_ptr, 8));
      if (hdr_ops == 0) {
        // the terminator: every predicate false, every read on the
        // unmoved lane q0; R4 reads row 36, R5 row 40
        const int f = (int)(d.q0 & 0x3FFFu);
        const int y4 = __popc(__ballot_sync(ALL, lane < 8 && f >= d.bLo)) - 1;
        const int lo5 = lane < NF ? bank[CTX_DIST_LO * NF + lane] : NONE;
        const int y5 = __popc(__ballot_sync(ALL, f >= lo5)) - 1;
        const int val = dict_delta((y4 << 3) + y5, 0);
        for (int u = t + lane; u < T; u += 32) {
          op_len[(long long)u * B + b] = -1;
          op_val[(long long)u * B + b] = val;
        }
        return;
      }
      const int rans_base = wadd(d.frame_ptr, nb_bytes);
      d.num_ops = hdr_ops;
      d.bit_pos = wadd(d.frame_ptr, 12);
      d.word = 0;
      d.word_bits = 0;
      d.q0 = in.le32(rans_base);
      d.q1 = in.le32(wadd(rans_base, 4));
      d.q2 = in.le32(wadd(rans_base, 8));
      d.q3 = in.le32(wadd(rans_base, 12));
      d.rans_pos = wadd(rans_base, 16);
      d.frame_ptr = wadd(rans_base, nr_bytes);
      rr.reset(row32, in.W, d.rans_pos >> 2, lane);
      br.reset(row32, in.W, d.bit_pos >> 2, lane);
    }
    const bool fast = rr.prepare(row32, in.W, d.rans_pos >> 2, lane) &
                      br.prepare(row32, in.W, d.bit_pos >> 2, lane);
    const int end = min(t + GROUP, T);
    t = fast ? run<true>(d, bank, fast_src, lane, t, end, B, b, op_len, op_val)
             : run<false>(d, bank, slow_src, lane, t, end, B, b, op_len, op_val);
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
