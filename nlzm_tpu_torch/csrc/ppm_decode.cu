// NLZC decode: 32 segment lanes a block, two nibble reads a byte against
// 2 x 4096-row chunk-static tables, rebuilt every chunk with group backoff
// and the container prior.
//
// Replaces nlzm_tpu/research/ppm_tpu.py::_decode_blocks (run, chunk_body,
// step_body, read_one, build_jnp). On the TPU a read selected each lane's
// table row with a one-hot [B, 32, 4096] contraction on the MXU and
// accumulated counts with another; here rows are plain loads.
//
// Bound: the serial chain of each block (steps x 2 dependent table reads
// and renorms) and the table rebuilds, which read and write every row of
// a block's tables at each chunk boundary. Design: one CTA of 256 threads
// a block, in one launch.
// - A block's tables (2 x 4096 rows x 17 fences) and carries (2 x 4096 x
//   16) do not fit shared memory (~1 MB), so they live in device memory
//   (scratch from the wrapper).
// - Warp 0 decodes, one lane a segment: loads its row's 17 fences, counts
//   the fences <= f, ranks its renorm among the block's lanes by ballot +
//   popc, reads the big-endian pair from the window (34 words at the
//   step's cursor >> 2, clamped to the stream as JAX clamps it), and adds
//   one to its (row, symbol) with an integer atomicAdd (exact in any
//   order).
// - carry = (carry >> 1) + counts is kept as one array: the rebuild that
//   builds the tables from this chunk's carry stores carry >> 1 right
//   away, and the next chunk's counts add onto it. All eight warps
//   rebuild between __syncthreads, a half-warp per 16-row group and a
//   lane per symbol: the group sum, eff = carry + gs / 2 + 8 * prior + 2,
//   the row total by shuffles, freq = 1 + eff * (2^14 - 16) / (tot + 1),
//   fences by a 16-lane scan with the last pinned at 2^14. The rebuild
//   after the last chunk, which no output reads, is skipped.
#include "common.cuh"

namespace {

constexpr int LANES = 32;
constexpr int ROWS = 4096;
constexpr int GROUP = 16;
constexpr int NS = 16;  // symbols (nibbles) a row
constexpr int FW = NS + 1;  // fences a row
constexpr int PRIOR_W = 8;
constexpr int BLEND = 2;
constexpr int WIN_H = 2 * ((2 * LANES * 2) / 4 + 2);  // JAX's window, in halfwords
constexpr int THREADS = 256;
static_assert((2 * ROWS / GROUP) % (2 * (THREADS / 32)) == 0, "half-warps split the groups");

// One rebuild of a block's two tables from its carries (first: the
// carries are not written yet and read as 0). carry, tables: the block's
// [2 * ROWS, 16] and [2 * ROWS, 17]; prior [2 * ROWS, 16].
__device__ void rebuild(int* carry, int* tables, const int* __restrict__ prior, bool first) {
  const int lane = threadIdx.x & 31, k = lane & 15, warp = threadIdx.x >> 5;
  const int halves = 2 * (blockDim.x >> 5);
  for (int g = 2 * warp + (lane >> 4); g < 2 * ROWS / GROUP; g += halves) {
    const long long r0 = (long long)g * GROUP;
    int c[GROUP];
    int gs = 0;
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      c[i] = first ? 0 : carry[(r0 + i) * NS + k];
      gs += c[i];
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const long long row = r0 + i;
      const int eff = c[i] + gs / 2 + PRIOR_W * prior[row * NS + k] + BLEND;
      int tot = eff;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
      const int fr = 1 + (int)(((long long)eff * (CDF_TOTAL - NS)) / (tot + 1));
      int inc = fr;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o, 16);
        if (k >= o) inc += v;
      }
      tables[row * FW + k] = inc - fr;
      if (k == NS - 1) tables[row * FW + NS] = CDF_TOTAL;
      carry[row * NS + k] = c[i] >> 1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    ppm_decode_kernel(const unsigned* __restrict__ words, const int* __restrict__ seg_lens,
                      const int* __restrict__ prior, const int* __restrict__ sched,
                      int* carry_all, int* tables_all, uint8_t* __restrict__ out, int W, int steps,
                      int NC) {
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* carry = carry_all + (long long)b * 2 * ROWS * NS;
  int* tables = tables_all + (long long)b * 2 * ROWS * FW;
  const unsigned* wb = words + (long long)b * W;
  rebuild(carry, tables, prior, true);
  __syncthreads();

  // decode state, live in warp 0 only
  unsigned x = warp == 0 ? wb[lane] : 0u;
  int cursor = 4 * LANES, prev = 0, prev2 = 0;
  const int seg = warp == 0 ? seg_lens[b * LANES + lane] : 0;
  uint8_t* ob = out + (long long)b * steps * LANES + lane;
  int s = 0;
  for (int c = 0; c < NC; ++c) {
    const int clen = sched[c];
    if (warp == 0) {
      for (int i = 0; i < clen; ++i, ++s) {
        const bool a = s < seg;
        const int base = cursor >> 2;
        int sym[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r == 0 ? (prev << 4) | (prev2 >> 4) : (sym[0] << 8) | prev;
          const int* fen = tables + ((long long)r * ROWS + row) * FW;
          int fv[FW];
#pragma unroll
          for (int j = 0; j < FW; ++j) fv[j] = fen[j];
          const int f = (int)(x & 0x3FFFu);
          int y = 0;
#pragma unroll
          for (int j = 1; j < FW; ++j) y += f >= fv[j];
          int start = 0, end = CDF_TOTAL;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (j == y) {
              start = fv[j];
              end = fv[j + 1];
            }
          }
          const unsigned x2 = (unsigned)(end - start) * (x >> 14) + (unsigned)(f - start);
          const bool ren = a && x2 < 65536u;
          const unsigned m = __ballot_sync(0xffffffffu, ren);
          if (ren) {
            const int rank = __popc(m & ((1u << lane) - 1u));
            const int h = clampi((cursor + 2 * rank - 4 * base) >> 1, 0, WIN_H - 1);
            const unsigned w = wb[clampi(base + (h >> 1), 0, W - 1)];
            const unsigned half = (w >> (16 * (h & 1))) & 0xFFFFu;
            x = (x2 << 16) | ((half & 0xFFu) << 8) | (half >> 8);
          } else if (a) {
            x = x2;
          }
          cursor += 2 * __popc(m);
          sym[r] = a ? y : 0;
          if (a) atomicAdd(&carry[((long long)r * ROWS + row) * NS + y], 1);
        }
        const int byte = (sym[0] << 4) | sym[1];
        ob[(long long)s * LANES] = (uint8_t)byte;
        if (a) {
          prev2 = prev;
          prev = byte;
        }
      }
    }
    if (c == NC - 1) break;  // no output reads the last rebuild
    __syncthreads();  // every count of the chunk is in
    rebuild(carry, tables, prior, false);
    __syncthreads();
  }
}

}  // namespace

// words [B, W] u32 (W >= 32); seg_lens [B, 32] i32; prior [2, 4096, 16]
// i32; sched [NC] i32 chunk lengths (sum = steps); carry [B, 8192, 16] and
// tables [B, 8192, 17] i32 scratch; out [B, steps, 32] u8.
NLZM_API int nlzm_ppm_decode(const void* words, const void* seg_lens, const void* prior,
                             const void* sched, void* carry, void* tables, void* out, int B, int W,
                             int steps, int NC, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  if (W < LANES) return (int)cudaErrorInvalidValue;
  ppm_decode_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const int*)seg_lens, (const int*)prior, (const int*)sched,
      (int*)carry, (int*)tables, (uint8_t*)out, W, steps, NC);
  return launch_status();
}
