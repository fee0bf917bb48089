// Fused rANS decode of the five wide-profile symbol planes.
//
// Replaces nlzm_tpu/ops/wide_decode.py::plane_scan_fused (with _seg_ranks
// and _build_cdf_jnp). On the TPU every step was a dozen dispatched tensor
// ops: grouped fence compares, one-hot MXU selects standing in for
// gathers, a cumsum for the renorm ranks. Here one CTA decodes one block
// and one thread owns one rANS lane.
//
// Bound: latency of the serial step chain (a few hundred steps per block,
// each dependent on the last), not bytes or operations: a block's whole
// stream is a few KB. Design:
// - 224 threads = 7 warps; lanes in slot order tok|len|dst|lit|lex, so
//   every plane owns whole warps (lex: half of warp 6; threads 208-223
//   idle). A lane's renorm rank is a ballot + popc inside its warp, plus
//   the count of the plane's first warp for the second warp of tok and of
//   lit: one __syncthreads per step, with the per-warp counts
//   double-buffered by step parity so step s+1 can never overwrite
//   counts step s is still reading.
// - The chunk-static fence tables (593 ints), the carries and the
//   realized counts (588 ints each) live in shared memory. Symbol search:
//   a linear count over the fences for alphabets <= 64, a binary search
//   for 256. Counts accumulate with shared-memory atomicAdd (integer,
//   exact in any order); at each chunk boundary warp q rebuilds slot q's
//   table with a warp scan: carry = (carry >> 1) + counts, then
//   freq = 1 + carry * (2^14 - nsym) / (tot + 1), fences = exclusive
//   prefix sums with the last fence pinned at 2^14.
// - The lane state is u32 with wraparound, exactly as the JAX decoder.
//   A renorm pair index is clamped to its plane's window.
// - Symbols are written straight into the five per-plane outputs
//   [B, steps * L_p] (wire order), so no un-permute pass follows.
#include "common.cuh"

namespace {

constexpr int NP = 5;
constexpr int LTOT = 208;
constexpr int NTHREADS = 224;
constexpr int NSYM_TOT = 4 + 8 + 64 + 256 + 256;
constexpr int NFEN_TOT = NSYM_TOT + NP;

// slot order tok|len|dst|lit|lex (format/wide.py PLANES grouped by
// alphabet); slot q holds wire plane c_plane[q]
__constant__ int c_base[NP + 1] = {0, 64, 96, 128, 192, 208};
__constant__ int c_alph[NP] = {4, 8, 64, 256, 256};
__constant__ int c_plane[NP] = {0, 2, 4, 1, 3};
__constant__ int c_sym_off[NP] = {0, 4, 12, 76, 332};
__constant__ int c_fen_off[NP] = {0, 5, 14, 79, 336};

struct Planes {
  const int* win[NP];  // wire order, [NC, B, WH_p] renorm windows
  int wh[NP];
  int* out[NP];  // wire order, [B, steps * L_p] symbols
};

__global__ void __launch_bounds__(NTHREADS)
    plane_scan_kernel(const unsigned* __restrict__ seeds, const int* __restrict__ n_syms,
                      const int* __restrict__ sched, const int* __restrict__ priors, int B,
                      int NC, int steps, Planes P) {
  __shared__ int fen[NFEN_TOT];
  __shared__ int carry[NSYM_TOT];
  __shared__ int cnt[NSYM_TOT];
  __shared__ int warp_cnt[2][8];

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int i = t; i < NSYM_TOT; i += NTHREADS) {
    carry[i] = priors ? priors[i] : 0;
    cnt[i] = 0;
  }
  __syncthreads();
  if (warp < NP) {  // initial tables: uniform, or built from the priors
    const int a = c_alph[warp];
    int* f = fen + c_fen_off[warp];
    if (priors) {
      build_fences(carry + c_sym_off[warp], f, a);
    } else {
      for (int k = lane; k <= a; k += 32) f[k] = k < a ? k * (CDF_TOTAL / a) : CDF_TOTAL;
    }
  }
  __syncthreads();

  int q = -1;  // slot of this thread's lane; -1 for the idle threads
  if (t < LTOT) {
    q = 0;
    while (t >= c_base[q + 1]) ++q;
  }
  const bool live = q >= 0;
  const int plane = live ? c_plane[q] : 0;
  const int L = live ? c_base[q + 1] - c_base[q] : 1;
  const int l = live ? t - c_base[q] : 0;
  const int nsym = live ? n_syms[b * NP + plane] : 0;
  const int alph = live ? c_alph[q] : 1;
  const int* myfen = fen + (live ? c_fen_off[q] : 0);
  int* mycnt = cnt + (live ? c_sym_off[q] : 0);
  // a switch, not P.win[plane]: indexing the parameter struct with a
  // run-time value copies it to a local-memory stack frame
  const int* win;
  int WH;
  int* outp;
  switch (plane) {
    case 0: win = P.win[0]; WH = P.wh[0]; outp = P.out[0]; break;
    case 1: win = P.win[1]; WH = P.wh[1]; outp = P.out[1]; break;
    case 2: win = P.win[2]; WH = P.wh[2]; outp = P.out[2]; break;
    case 3: win = P.win[3]; WH = P.wh[3]; outp = P.out[3]; break;
    default: win = P.win[4]; WH = P.wh[4]; outp = P.out[4]; break;
  }
  outp += (long long)b * steps * L + l;
  // the second warp of tok (warp 1) and of lit (warp 5) ranks after the first
  const int prev_warp = (warp == 1 || warp == 5) ? warp - 1 : -1;
  unsigned x = live ? seeds[(long long)b * LTOT + t] : 0u;

  int s = 0;
  for (int c = 0; c < NC; ++c) {
    const int clen = sched[c];
    const int* wrow = win + ((long long)c * B + b) * WH;
    int rel = 0;  // the window cursor restarts every chunk
    for (int i = 0; i < clen; ++i, ++s) {
      const bool active = live && (long long)s * L + l < nsym;
      int y = 0;
      unsigned x2 = x;
      bool ren = false;
      if (live) {
        const int f = (int)(x & 0x3FFFu);
        if (alph <= 64) {
          for (int k = 1; k < alph; ++k) y += f >= myfen[k];
        } else {
          int lo = 0, hi = alph;  // myfen[lo] <= f < myfen[hi]
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (myfen[mid] <= f) lo = mid; else hi = mid;
          }
          y = lo;
        }
        const int start = myfen[y];
        const int freq = myfen[y + 1] - start;
        x2 = (unsigned)freq * (x >> 14) + (unsigned)(f - start);
        ren = active && x2 < 65536u;
      }
      const unsigned m = __ballot_sync(0xffffffffu, ren);
      int rank = __popc(m & ((1u << lane) - 1u));
      if (lane == 0) warp_cnt[s & 1][warp] = __popc(m);
      __syncthreads();
      if (live) {
        const int* wc = warp_cnt[s & 1];
        if (prev_warp >= 0) rank += wc[prev_warp];
        const int total = q == 0 ? wc[0] + wc[1] : (q == 3 ? wc[4] + wc[5] : wc[warp]);
        if (ren) {
          x = (x2 << 16) | (unsigned)wrow[clampi(rel + rank, 0, WH - 1)];
        } else if (active) {
          x = x2;
        }
        rel += total;
        if (active) atomicAdd(&mycnt[y], 1);
        outp[(long long)s * L] = active ? y : 0;
      }
    }
    __syncthreads();  // every count of the chunk is in
    if (warp < NP) {
      const int a = c_alph[warp];
      int* car = carry + c_sym_off[warp];
      int* cn = cnt + c_sym_off[warp];
      for (int k = lane; k < a; k += 32) {
        car[k] = (car[k] >> 1) + cn[k];
        cn[k] = 0;
      }
      __syncwarp();
      build_fences(car, fen + c_fen_off[warp], a);
    }
    __syncthreads();
  }
}

}  // namespace

// seeds [B, 208] u32, slot order; n_syms [B, 5] i32, wire order; sched
// [NC] i32 chunk lengths (sum = steps); priors [588] i32 in slot order, or
// null for uniform initial tables; win_p [NC, B, WH_p] i32; out_p
// [B, steps * L_p] i32.
NLZM_API int nlzm_plane_scan(const void* seeds, const void* n_syms, const void* sched,
                             const void* priors, const void* win0, const void* win1,
                             const void* win2, const void* win3, const void* win4, void* out0,
                             void* out1, void* out2, void* out3, void* out4, int B, int NC,
                             int steps, int wh0, int wh1, int wh2, int wh3, int wh4, int device,
                             void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  Planes P{{(const int*)win0, (const int*)win1, (const int*)win2, (const int*)win3,
            (const int*)win4},
           {wh0, wh1, wh2, wh3, wh4},
           {(int*)out0, (int*)out1, (int*)out2, (int*)out3, (int*)out4}};
  plane_scan_kernel<<<B, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)seeds, (const int*)n_syms, (const int*)sched, (const int*)priors, B, NC,
      steps, P);
  return launch_status();
}
