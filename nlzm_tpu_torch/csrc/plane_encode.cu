// Wide-profile plane encode: chunk-adaptive tables simulated against the
// known symbols, then interleaved rANS backward over the lanes.
//
// Replaces nlzm_tpu/ops/wide_encode_dev.py::plane_encode. The forward pass
// gives every symbol its (start, freq) under the same chunk-static tables
// the decoder rebuilds (chunk_schedule: 2, 2, 4, 8, then 8s; at each chunk
// boundary carry = (carry >> 1) + counts and the fences are rebuilt as
// _build_cdf does), so both sides agree by construction. The backward pass
// walks the steps in reverse with one u32 rANS state per lane, records the
// low 16 bits of the state at every (step, read, lane) and marks a renorm
// pair where (x >> 18) >= freq (x >= freq << 18 overflows u32 at freq =
// 2^14), then x = ((x / freq) << 14) + x % freq + start. Outputs are in
// decode order (step, read, lane): seeds [B, L] u32, pairs [B, steps*R*L]
// i32, emission mask [B, steps*R*L] (one byte, 0 or 1).
//
// Bound: the serial chunk chain of the forward pass (a table rebuild
// every 8 steps) and the u32 divisions of the backward chain; a plane's
// symbols are a few hundred KB. Design: one CTA per block, one thread per
// lane (blockDim = L rounded up to a warp).
// - Per read the fences [rows, alph + 1], carries and chunk counts
//   [rows, alph] live in dynamic shared memory; counts add with shared
//   atomics (integer: exact in any order), one atomic per group of lanes
//   with the same (row, symbol) (__match_any_sync).
// - At a chunk boundary warp w rebuilds rows w, w + nwarps, ... with a
//   warp scan; the i32 fence arithmetic of the JAX function is kept (the
//   carries decay, so carry * (2^14 - nsym) cannot overflow).
// - (start, freq) go to a global scratch [B, steps, R, L] in the layout of
//   the outputs; each lane reads back only what it wrote, so the backward
//   pass needs no barrier.
// - Any number of reads and context rows (the wire-v4 planes have one of
//   each); symbol and row indices are clamped to the plane's alphabet and
//   rows, so no load leaves the tables.
#include "common.cuh"

namespace {

constexpr int MAX_R = 8;

// desc [R, 5] i64 per read: symbols pointer ([B, steps * L], u8 or i32),
// context-row pointer ([B, steps * L] i32, or 0 for row 0), prior pointer
// ([rows, alph] i32 counts, or 0 for uniform initial tables), alph, rows.
__global__ void plane_encode_kernel(const long long* __restrict__ desc,
                                    const int* __restrict__ n_sym, const int* __restrict__ sched,
                                    unsigned* __restrict__ span, unsigned* __restrict__ seeds,
                                    int* __restrict__ pairs, uint8_t* __restrict__ mask, int L,
                                    int R, int steps, int NC, int sym_u8) {
  extern __shared__ int sm[];
  __shared__ int s_fen[MAX_R], s_car[MAX_R], s_cnt[MAX_R], s_alph[MAX_R], s_rows[MAX_R];
  __shared__ long long s_sym[MAX_R], s_row[MAX_R], s_pri[MAX_R];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    int off = 0;
    for (int r = 0; r < R; ++r) {
      const int a = (int)desc[r * 5 + 3], nr = (int)desc[r * 5 + 4];
      s_sym[r] = desc[r * 5];
      s_row[r] = desc[r * 5 + 1];
      s_pri[r] = desc[r * 5 + 2];
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

  const long long Tpad = (long long)steps * L;
  const long long srow = (long long)b * Tpad;  // symbol / row offset of block b
  const long long orow = srow * R;             // span / output offset of block b
  const int nsym = n_sym[b];
  const int in_warp = min(32, L - warp * 32);
  const unsigned wmask = in_warp >= 32 ? 0xffffffffu : ((1u << max(in_warp, 0)) - 1u);
  int s = 0;
  for (int c = 0; c < NC; ++c) {
    const int clen = sched[c];
    for (int i = 0; i < clen; ++i, ++s) {
      if (t < L) {
        const long long idx = (long long)s * L + t;
        const bool active = idx < nsym;
        for (int r = 0; r < R; ++r) {
          const int a = s_alph[r];
          int y = sym_u8 ? (int)reinterpret_cast<const uint8_t*>(s_sym[r])[srow + idx]
                         : reinterpret_cast<const int*>(s_sym[r])[srow + idx];
          const int* rowp = reinterpret_cast<const int*>(s_row[r]);
          const int row = rowp ? clampi(rowp[srow + idx], 0, s_rows[r] - 1) : 0;
          y = clampi(y, 0, a - 1);
          const int* f = sm + s_fen[r] + row * (a + 1);
          unsigned st = 0u, fq = 1u;
          if (active) {
            st = (unsigned)f[y];
            fq = (unsigned)(f[y + 1] - f[y]);
          }
          span[orow + ((long long)s * R + r) * L + t] = (fq << 16) | st;
          const int key = active ? row * a + y : -1;
          const unsigned grp = __match_any_sync(wmask, key);
          if (active && lane == __ffs(grp) - 1) atomicAdd(&sm[s_cnt[r] + key], __popc(grp));
        }
      }
    }
    plane_tables_rebuild(sm, s_fen, s_car, s_cnt, s_alph, s_rows, R);
  }

  if (t >= L) return;
  unsigned x = 1u << 16;
  for (int s2 = steps - 1; s2 >= 0; --s2) {
    const bool active = (long long)s2 * L + t < nsym;
    for (int r = R - 1; r >= 0; --r) {
      const long long k = orow + ((long long)s2 * R + r) * L + t;
      const unsigned sf = span[k];
      const unsigned fq = sf >> 16, st = sf & 0xFFFFu;
      const bool over = active && (x >> 18) >= fq;
      pairs[k] = (int)(x & 0xFFFFu);
      mask[k] = over ? 1 : 0;
      const unsigned x1 = over ? x >> 16 : x;
      if (active) x = ((x1 / fq) << 14) + x1 % fq + st;
    }
  }
  seeds[(long long)b * L + t] = x;
}

}  // namespace

// desc [R, 5] i64 (see the kernel); n_sym [B] i32; sched [NC] i32 chunk
// lengths (sum = steps); span [B, steps * R * L] u32 scratch; seeds
// [B, L] u32, pairs [B, steps * R * L] i32, mask [B, steps * R * L] u8 out.
// smem_bytes: the tables of every read, sum of rows * (3 * alph + 1) ints.
NLZM_API int nlzm_plane_encode(const void* desc, const void* n_sym, const void* sched,
                               void* span, void* seeds, void* pairs, void* mask, int B, int L,
                               int R, int steps, int NC, int sym_u8, int smem_bytes, int device,
                               void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (R < 1 || R > MAX_R || L < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(plane_encode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = (L + 31) / 32 * 32;
  plane_encode_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const long long*)desc, (const int*)n_sym, (const int*)sched, (unsigned*)span,
      (unsigned*)seeds, (int*)pairs, (uint8_t*)mask, L, R, steps, NC, sym_u8);
  return launch_status();
}
