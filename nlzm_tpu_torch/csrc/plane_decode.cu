// One wide-profile plane's rANS decode with multi-row, multi-read context
// tables: the decoder side of plane_encode.cu for any plane spec.
//
// Replaces nlzm_tpu/ops/wide_decode.py::plane_scan (with _build_cdf_jnp and
// _uniform_tables; its windows come from stage_plane). On the TPU a step
// was a set of tensor ops over [B, L] with one-hot row selects and pair
// selects on the MXU. Here one CTA decodes one block and one thread owns
// one rANS lane (blockDim = L rounded up to a warp, at most 1024).
//
// Bound: latency of the serial step chain (steps x reads dependent table
// reads and renorms a block), not bytes or operations. Design:
// - Per read the fences [rows, alph + 1], the carries and the chunk
//   counts [rows, alph] live in dynamic shared memory, set up and rebuilt
//   by common.cuh's plane_tables_init / plane_tables_rebuild, which
//   plane_encode.cu shares: initial tables uniform or from the read's
//   prior.
// - A read's row: the context row for read 0; row0 * 8 + y_prev for a
//   plane named "dst" (i32 wraparound, as JAX), else y_prev. A single-row
//   read ignores it. A row outside [0, rows) reads as JAX's all-zero
//   one-hot row: symbol alph, start 0, freq 0, and it counts nothing.
// - The renorm rank across lanes is a ballot + popc in the warp plus the
//   counts of lower warps, exchanged once per read with one __syncthreads
//   (per-warp counts double-buffered by read parity). The pair index is
//   clamped to the window.
// - Counts add with shared-memory atomics (integer: exact in any order);
//   at a chunk boundary carry = (carry >> 1) + counts and the fences are
//   rebuilt.
#include "common.cuh"

namespace {

constexpr int MAX_R = 8;

// desc [R, 4] i64 per read: prior pointer ([rows, alph] i32 counts, or 0
// for uniform initial tables), output pointer ([B, steps * L] i32), alph,
// rows.
__global__ void plane_decode_kernel(const long long* __restrict__ desc,
                                    const unsigned* __restrict__ seeds,
                                    const int* __restrict__ wins, const int* __restrict__ n_sym,
                                    const int* __restrict__ ctx, const int* __restrict__ sched,
                                    int B, int L, int R, int steps, int NC, int WH, int is_dst) {
  extern __shared__ int sm[];
  __shared__ int s_fen[MAX_R], s_car[MAX_R], s_cnt[MAX_R], s_alph[MAX_R], s_rows[MAX_R];
  __shared__ long long s_pri[MAX_R], s_out[MAX_R];
  __shared__ int warp_cnt[2][32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  if (t == 0) {
    int off = 0;
    for (int r = 0; r < R; ++r) {
      const int a = (int)desc[r * 4 + 2], nr = (int)desc[r * 4 + 3];
      s_pri[r] = desc[r * 4];
      s_out[r] = desc[r * 4 + 1];
      s_alph[r] = a;
      s_rows[r] = nr;
      s_fen[r] = off;
      off += nr * (a + 1);
      s_car[r] = off;
      off += nr * a;
      s_cnt[r] = off;
      off += nr * a;
    }
  }
  __syncthreads();
  plane_tables_init(sm, s_fen, s_car, s_cnt, s_alph, s_rows, s_pri, R);

  const bool live = t < L;
  const int nsym = n_sym[b];
  const long long blk = (long long)b * steps * L;  // symbol / row offset of block b
  unsigned x = live ? seeds[(long long)b * L + t] : 0u;
  int s = 0, k = 0;  // k counts reads: the parity of warp_cnt
  for (int c = 0; c < NC; ++c) {
    const int clen = sched[c];
    const int* wrow = wins + ((long long)c * B + b) * WH;
    int rel = 0;  // the window cursor restarts every chunk
    for (int i = 0; i < clen; ++i, ++s) {
      const long long idx = blk + (long long)s * L + t;
      const bool active = live && (long long)s * L + t < nsym;
      const int row0 = live ? ctx[idx] : 0;
      int y_prev = 0;
      for (int r = 0; r < R; ++r, ++k) {
        const int a = s_alph[r], nr = s_rows[r];
        int row = r == 0 ? row0
                         : (is_dst ? (int)((unsigned)row0 * 8u + (unsigned)y_prev) : y_prev);
        const bool ok = nr == 1 || (row >= 0 && row < nr);
        if (nr == 1) row = 0;
        int y = a, start = 0, freq = 0;  // the all-zero row
        const unsigned f = x & 0x3FFFu;
        if (live && ok) {
          const int* fen = sm + s_fen[r] + row * (a + 1);
          if (a <= 64) {
            y = 0;
            for (int j = 1; j < a; ++j) y += (int)f >= fen[j];
          } else {  // fen[lo] <= f < fen[hi]
            int lo = 0, hi = a;
            while (hi - lo > 1) {
              const int mid = (lo + hi) >> 1;
              if (fen[mid] <= (int)f) lo = mid; else hi = mid;
            }
            y = lo;
          }
          start = fen[y];
          freq = fen[y + 1] - start;
        }
        const unsigned x2 = (unsigned)freq * (x >> 14) + (f - (unsigned)start);
        const bool ren = active && x2 < 65536u;
        const unsigned m = __ballot_sync(0xffffffffu, ren);
        int rank = __popc(m & ((1u << lane) - 1u));
        if (lane == 0) warp_cnt[k & 1][warp] = __popc(m);
        __syncthreads();
        int total = 0;
        for (int w = 0; w < nwarps; ++w) {
          const int cw = warp_cnt[k & 1][w];
          if (w < warp) rank += cw;
          total += cw;
        }
        if (ren) {
          x = (x2 << 16) | (unsigned)wrow[clampi(rel + rank, 0, WH - 1)];
        } else if (active) {
          x = x2;
        }
        rel += total;
        if (!active) y = 0;
        if (active && ok && y < a) atomicAdd(&sm[s_cnt[r] + row * a + y], 1);
        if (live) reinterpret_cast<int*>(s_out[r])[idx] = y;
        y_prev = y;
      }
    }
    plane_tables_rebuild(sm, s_fen, s_car, s_cnt, s_alph, s_rows, R);
  }
}

}  // namespace

// desc [R, 4] i64 (see the kernel); seeds [B, L] u32; wins [NC, B, WH] i32;
// n_sym [B] i32; ctx [B, steps * L] i32 rows of read 0; sched [NC] i32
// chunk lengths (sum = steps). smem_bytes: the tables of every read, the
// sum of rows * (3 * alph + 1) ints.
NLZM_API int nlzm_plane_decode(const void* desc, const void* seeds, const void* wins,
                               const void* n_sym, const void* ctx, const void* sched, int B,
                               int L, int R, int steps, int NC, int WH, int is_dst,
                               int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (R < 1 || R > MAX_R || L < 1 || L > 1024 || WH < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(plane_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = (L + 31) / 32 * 32;
  plane_decode_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const long long*)desc, (const unsigned*)seeds, (const int*)wins, (const int*)n_sym,
      (const int*)ctx, (const int*)sched, B, L, R, steps, NC, WH, is_dst);
  return launch_status();
}
