// Command assembly: plane symbols -> LZ commands (op_len, op_val).
//
// Replaces nlzm_tpu/ops/wide_decode.py::assemble_ops (with _bits_fetch).
// The TPU version routes symbols to commands with gather-via-sort
// (ops/sort_gather.py) because it has no per-lane gather; here every
// route is one indexed load.
//
// Bound: the dependent scans. A command's plane symbols sit at its
// exclusive rank among commands of its kind, and the raw-bit offsets and
// escape ranks depend on symbols gathered at those ranks, so a block
// needs three ordered sweeps. Design: one CTA of 1024 threads per block,
// tiled over the Tc command slots with carried block scans:
// - sweep 1, per tile: scan (match, dict, literal) flags -> m_rank,
//   d_rank, lit_rank; gather len/dst symbols; scan (escape, bit width)
//   -> lex_rank and bit offsets; fetch the raw-bit fields; compact each
//   dict distance to D[d_rank] in global scratch; write every
//   non-rep command, and park each rep's length and history index j in
//   its own op_len/op_val slots;
// - __syncthreads (global writes of the block become visible);
// - sweep 2: each rep reads D[j] (j >= 0) or the virtual history -j.
// op_len/op_val are [Tc, B]: the expander's layout. Every gathered index
// is clamped (the JAX gathers clamp silently), and so is the
// distance-extra width (ab <= 16) as in the JAX decoder.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 1024;
constexpr int TOK_LIT = 0, TOK_DICT = 1, TOK_REP = 2;

struct Plane {
  const int* p;
  int width;   // columns in use
  int stride;  // row stride (elements)
};

struct Planes {
  Plane tok, len, lex, lit, slot;
};

__device__ __forceinline__ int load_at(const Plane& a, int b, int k) {
  return a.p[(long long)b * a.stride + clampi(k, 0, a.width - 1)];
}

// MSB-first field of `width` (<= 16) bits at bit offset `off`, from the
// block's big-endian halfwords (nlzm_tpu wide_decode._bits_fetch).
__device__ __forceinline__ int bits_fetch(const unsigned short* row, int hb, int off, int width) {
  if (width <= 0) return 0;
  const int h0 = off >> 4;
  const unsigned hw0 = row[clampi(h0, 0, hb - 1)];
  const unsigned hw1 = row[clampi(h0 + 1, 0, hb - 1)];
  const unsigned word = (hw0 << 16) | hw1;
  const unsigned w = (unsigned)min(width, 16);
  return (int)((word << (off & 15)) >> (32u - w));
}

__device__ __forceinline__ int mmin_of(int delta) {
  return 2 + (delta > 0xFF) + (delta > 0xFFF) + (delta > 0xFFFFF);
}

__global__ void __launch_bounds__(NTHREADS)
    assemble_kernel(Planes P, const unsigned short* __restrict__ bit_half, int hb,
                    const int* __restrict__ n_cmds, int* __restrict__ dscratch,
                    int* __restrict__ op_len, int* __restrict__ op_val, int B) {
  __shared__ int scratch3[32][3];
  __shared__ int scratch2[32][2];
  const int b = blockIdx.x;
  const int Tc = P.tok.width;
  const int ncmd = n_cmds[b];
  const unsigned short* bits = bit_half + (long long)b * hb;
  int* D = dscratch + (long long)b * Tc;
  int m_base = 0, d_base = 0, l_base = 0, e_base = 0, w_base = 0;

  for (int k0 = 0; k0 < Tc; k0 += NTHREADS) {
    const int k = k0 + threadIdx.x;
    const bool in = k < Tc;
    const int tok = in ? P.tok.p[(long long)b * P.tok.stride + k] : -1;
    const bool active = in && k < ncmd;
    const bool is_lit = active && tok == TOK_LIT;
    const bool is_rep = active && tok == TOK_REP;
    const bool is_dict = active && tok == TOK_DICT;
    const bool is_match = is_rep || is_dict;

    int f3[3] = {is_match, is_dict, is_lit}, t3[3];
    block_exclusive_scan<3>(f3, t3, scratch3);
    const int m_rank = m_base + f3[0], d_rank = d_base + f3[1], lit_rank = l_base + f3[2];
    m_base += t3[0];
    d_base += t3[1];
    l_base += t3[2];

    const int len_sym = is_match ? load_at(P.len, b, m_rank) : 0;
    const bool esc = is_match && len_sym == 7;
    const int slot = is_dict ? load_at(P.slot, b, d_rank) : 0;
    const bool big_slot = slot >= 4;
    const int ab = clampi(is_dict && big_slot ? (slot >> 1) - 1 : 0, 0, 16);
    const int width = (is_rep ? 2 : 0) + ab;

    int f2[2] = {esc, width}, t2[2];
    block_exclusive_scan<2>(f2, t2, scratch2);
    const int lex_rank = e_base + f2[0], off = w_base + f2[1];
    e_base += t2[0];
    w_base += t2[1];

    const int lv = esc ? 7 + load_at(P.lex, b, lex_rank) : len_sym;
    const int v = bits_fetch(bits, hb, off, width);
    if (!in) continue;
    const long long o = (long long)k * B + b;
    if (is_rep) {  // resolved in sweep 2 from the compacted dict distances
      op_len[o] = lv;
      op_val[o] = d_rank - 1 - v;
    } else if (is_dict) {
      const int extra = v;
      const int dv = big_slot ? ((2 + (slot & 1)) << ab) + extra : slot;
      const int delta = dv + 1;
      D[clampi(d_rank, 0, Tc - 1)] = delta;
      op_len[o] = lv + mmin_of(delta);
      op_val[o] = delta;
    } else {
      op_len[o] = active ? 0 : -1;
      op_val[o] = is_lit ? load_at(P.lit, b, lit_rank) : 0;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < Tc && k < ncmd; k += NTHREADS) {
    if (P.tok.p[(long long)b * P.tok.stride + k] != TOK_REP) continue;
    const long long o = (long long)k * B + b;
    const int j = op_val[o];
    const int delta = j >= 0 ? D[clampi(j, 0, Tc - 1)] : -j;
    op_len[o] += mmin_of(delta);
    op_val[o] = delta;
  }
}

}  // namespace

// tok/len/lex/lit/slot: [B, width] i32 plane symbols (row stride given);
// bit_half [B, hb] u16; n_cmds [B] i32; dscratch [B, Tc] i32;
// op_len/op_val [Tc, B] i32 with Tc = the tok width.
NLZM_API int nlzm_assemble(const void* tok, const void* len, const void* lex, const void* lit,
                           const void* slot, const void* bit_half, const void* n_cmds,
                           void* dscratch, void* op_len, void* op_val, int B, int tok_w,
                           int tok_s, int len_w, int len_s, int lex_w, int lex_s, int lit_w,
                           int lit_s, int slot_w, int slot_s, int hb, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || tok_w == 0) return 0;
  Planes P{{(const int*)tok, tok_w, tok_s},
           {(const int*)len, len_w, len_s},
           {(const int*)lex, lex_w, lex_s},
           {(const int*)lit, lit_w, lit_s},
           {(const int*)slot, slot_w, slot_s}};
  assemble_kernel<<<B, NTHREADS, 0, (cudaStream_t)stream>>>(
      P, (const unsigned short*)bit_half, hb, (const int*)n_cmds, (int*)dscratch, (int*)op_len,
      (int*)op_val, B);
  return launch_status();
}
