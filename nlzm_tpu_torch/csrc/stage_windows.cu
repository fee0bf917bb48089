// Dense per-chunk renorm windows of the five wide-profile planes.
//
// Replaces nlzm_tpu/ops/wide_decode.py::stage_windows_fused (a batched
// gather-via-sort on the TPU, which has no per-lane gather). Here it is a
// plain indexed copy: win_p[c, b, k] = hw[b, clamp(offs[b, p, c] + k)]
// for k below the chunk's pair count, 0 past it.
//
// Bound: memory. Each output word costs one 2-byte read (mostly from L1/L2:
// a chunk's window is a contiguous run of the block's stream) and one
// 4-byte coalesced write. Design: one CTA per (block, plane), threads
// stride over the plane's NC x WH_p window cells so that neighbouring
// threads write neighbouring words of one chunk's window row.
#include "common.cuh"

namespace {

constexpr int NP = 5;

struct Widths {
  int wh[NP];  // window width of each plane, wire order
};

__global__ void stage_windows_kernel(const unsigned short* __restrict__ hw,
                                     const int* __restrict__ offs,
                                     const int* __restrict__ ends,
                                     int* __restrict__ out, int B, int H, int NC,
                                     Widths w) {
  const int b = blockIdx.x, p = blockIdx.y;
  const int WH = w.wh[p];
  // plane p's windows [NC, B, WH_p] follow the planes before it
  long long base = 0;
  for (int q = 0; q < p; ++q) base += (long long)NC * B * w.wh[q];
  const int* ob = offs + ((long long)b * NP + p) * NC;
  const int end = ends[b * NP + p];
  const unsigned short* row = hw + (long long)b * H;
  const int n = NC * WH;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = i / WH, k = i - c * WH;
    const int o = ob[c];
    const int nxt = c + 1 < NC ? ob[c + 1] : end;
    int v = 0;
    if (k < nxt - o) v = row[clampi(o + k, 0, H - 1)];
    out[base + ((long long)c * B + b) * WH + k] = v;
  }
}

}  // namespace

// hw [B, H] u16; offs [B, 5, NC] i32; ends [B, 5] i32;
// out: the five windows [NC, B, WH_p] i32 back to back, plane order.
NLZM_API int nlzm_stage_windows(const void* hw, const void* offs, const void* ends, void* out,
                                int B, int H, int NC, int wh0, int wh1, int wh2, int wh3,
                                int wh4, int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0) return 0;
  Widths w{{wh0, wh1, wh2, wh3, wh4}};
  stage_windows_kernel<<<dim3(B, NP), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)hw, (const int*)offs, (const int*)ends, (int*)out, B, H, NC, w);
  return launch_status();
}
