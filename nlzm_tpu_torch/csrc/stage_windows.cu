// Dense per-chunk renorm windows of the five wide-profile planes.
//
// Replaces nlzm_tpu/ops/wide_decode.py::stage_windows_fused (a batched
// gather-via-sort on the TPU, which has no per-lane gather). Here it is an
// indexed copy: win_p[c, b, k] = hw[b, clamp(offs[b, p, c] + k, 0, H - 1)]
// for k below the chunk's pair count, 0 past it; the index and the count
// wrap in int32, as JAX's do.
//
// Bound: bytes. The windows are written once (at the shipping shape ~63%
// of their cells are the zeros past a chunk's pairs) and each live pair is
// read once, a contiguous run of the block's stream. Design: a warp per
// (block, chunk). Its lanes walk the chunk's five rows as one list of
// units, so each plane takes lanes in proportion to its width: a unit is
// four cells, written with one 16-byte store, where the plane's rows are
// 16-byte aligned (WH_p % 4 == 0 and the plane's base a multiple of 4),
// else one cell. A lane finds its unit's plane from four compares against
// the planes' first units: no cell costs a division. Lanes 0-4 load the
// chunk's offset and next offset (or end) of their plane and hold its
// values (first pair, pair count, first unit, the row's place in out);
// each unit takes them from lane p by shuffles, so no lane keeps a table.
// A unit past the pair count is stored as zeros without a load. A lane
// takes one unit a round (its loads, then its store) in 32 registers, so
// 8 CTAs fit an SM and the loads and stores of many warps overlap (2, 4
// and 8 units a round, in more registers, were slower). The warps of a
// CTA take consecutive chunks of one block (grid [B, chunk groups]), so a
// 32 KiB block's 24-27 chunks fill 3-4 CTAs.
#include "common.cuh"

namespace {

constexpr int NP = 5;
constexpr int MAX_WARPS = 8;  // chunks a CTA
constexpr int MIN_CTAS = 8;   // resident an SM (32 registers a thread)

struct Planes {
  long long base[NP];  // plane p's first int in out
  int wh[NP];          // window width
  int width[NP];       // cells a unit: 4 (16-byte rows) or 1
  int first[NP + 1];   // plane p's first unit in a chunk; first[NP]: units a chunk
};

// plane of a chunk's unit u: four compares, no division
__device__ __forceinline__ int plane_of(const Planes& P, int u) {
  int p = 0;
#pragma unroll
  for (int q = 1; q < NP; ++q) p += u >= P.first[q];
  return p;
}

__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_CTAS)
    stage_windows_kernel(const unsigned short* __restrict__ hw, const int* __restrict__ offs,
                         const int* __restrict__ ends, int* __restrict__ out, int B, int H,
                         int NC, Planes P) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int c = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= NC) return;  // the whole warp

  // lane p < 5 holds plane p's values for this chunk: its first pair, its
  // pair count (to the next chunk's first pair or the stream's end), its
  // first unit << 1 | 16-byte units, and its row's first cell in out
  int o = 0, n = 0, fw = 0;
  long long row = 0;
  if (lane < NP) {
    const long long at = ((long long)b * NP + lane) * NC + c;
    o = offs[at];
    n = (int)((unsigned)(c + 1 < NC ? offs[at + 1] : ends[b * NP + lane]) - (unsigned)o);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (lane == q) {
        fw = P.first[q] << 1 | (P.width[q] == 4);
        row = P.base[q] + ((long long)c * B + b) * P.wh[q];
      }
    }
  }

  const unsigned short* src = hw + (long long)b * H;
  const int U = P.first[NP];
  for (int u0 = 0; u0 < U; u0 += 32) {  // the same trips for every lane
    const int u = u0 + lane;
    const int p = plane_of(P, u);
    const int op = __shfl_sync(FULL, o, p), np = __shfl_sync(FULL, n, p);
    const int f = __shfl_sync(FULL, fw, p);
    const long long r = __shfl_sync(FULL, row, p);
    if (u >= U) continue;
    const bool w4 = f & 1;
    const int k0 = w4 ? (u - (f >> 1)) << 2 : u - (f >> 1);
    int x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      x[i] = 0;
      if ((i == 0 || w4) && k < np && H > 0)
        x[i] = __ldg(src + clampi((int)((unsigned)op + (unsigned)k), 0, H - 1));
    }
    if (w4)
      *reinterpret_cast<int4*>(out + r + k0) = make_int4(x[0], x[1], x[2], x[3]);
    else
      out[r + k0] = x[0];
  }
}

// the launch at (B, NC): warps a CTA (consecutive chunks) and chunk groups
void config_of(int NC, int* warps, int* groups) {
  const int g = (NC + MAX_WARPS - 1) / MAX_WARPS;
  *groups = g;
  *warps = g ? (NC + g - 1) / g : 1;
}

}  // namespace

// hw [B, H] u16; offs [B, 5, NC] i32; ends [B, 5] i32;
// out: the five windows [NC, B, WH_p] i32 back to back, plane order.
NLZM_API int nlzm_stage_windows(const void* hw, const void* offs, const void* ends, void* out,
                                int B, int H, int NC, int wh0, int wh1, int wh2, int wh3,
                                int wh4, int device, void* stream) {
  cudaSetDevice(device);
  const int whs[NP] = {wh0, wh1, wh2, wh3, wh4};
  Planes P;
  long long base = 0;
  P.first[0] = 0;
  const bool aligned = ((uintptr_t)out & 15) == 0;
  for (int p = 0; p < NP; ++p) {
    P.base[p] = base;
    P.wh[p] = whs[p];
    P.width[p] = aligned && whs[p] % 4 == 0 && base % 4 == 0 ? 4 : 1;
    P.first[p + 1] = P.first[p] + whs[p] / P.width[p];
    base += (long long)NC * B * whs[p];
  }
  if (B == 0 || NC == 0 || P.first[NP] == 0) return 0;
  int warps, groups;
  config_of(NC, &warps, &groups);
  stage_windows_kernel<<<dim3(B, groups), 32 * warps, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)hw, (const int*)offs, (const int*)ends, (int*)out, B, H, NC, P);
  return launch_status();
}

// out[6]: threads a CTA, CTAs of the launch, registers a thread, resident
// CTAs an SM, SMs, chunk groups a block; the launch at (B, NC).
NLZM_API int nlzm_stage_windows_shape(void* out, int B, int NC, int device, void* stream) {
  (void)stream;
  cudaSetDevice(device);
  int warps, groups, ctas = 0, sms = 0;
  config_of(NC, &warps, &groups);
  cudaFuncAttributes attr = {};
  cudaError_t e = cudaFuncGetAttributes(&attr, stage_windows_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, stage_windows_kernel, 32 * warps, 0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int v[6] = {32 * warps, B * groups, attr.numRegs, ctas, sms, groups};
  for (int i = 0; i < 6; ++i) ((int*)out)[i] = v[i];
  return 0;
}
