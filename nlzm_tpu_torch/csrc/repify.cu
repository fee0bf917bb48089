// Rep-slot replay over a command stream.
//
// Replaces nlzm_tpu/ops/encode_ops.py::repify. Per block, a 4-slot table
// of distances starting at {1, 2, 3, 4}: a match (op_len > 0) whose
// distance is in the table gets the index of its first equal slot; a fresh
// distance is pushed to the front (the last slot drops). Every other row
// gives -1. op_len / op_val / op_rep are [T, B].
//
// Bound: latency of the serial table chain, T steps per block (T = 32768
// at 32 KiB blocks). Design: one warp per block, the table in
// warp-uniform registers. The warp loads 32 steps at once (lane j step
// base + j; the next 32 are loaded before the current ones are replayed),
// then replays them in order, each step's (len, val) broadcast by shuffle;
// lane j keeps step j's result and the warp stores all 32 together. Rows
// of the [T, B] arrays are B apart, so each load is one scattered word
// per lane.
#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;  // four blocks per CTA

__global__ void __launch_bounds__(NTHREADS)
    repify_kernel(const int* __restrict__ op_len, const int* __restrict__ op_val,
                  int* __restrict__ op_rep, int T, int B) {
  const int b = (blockIdx.x * NTHREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // whole warps only
  int t0 = 1, t1 = 2, t2 = 3, t3 = 4;
  int L = -1, V = 0;
  if (lane < T) {
    L = op_len[(long long)lane * B + b];
    V = op_val[(long long)lane * B + b];
  }
  for (int base = 0; base < T; base += 32) {
    const int nxt = base + 32 + lane;
    int Ln = -1, Vn = 0;
    if (nxt < T) {
      Ln = op_len[(long long)nxt * B + b];
      Vn = op_val[(long long)nxt * B + b];
    }
    const int n = min(32, T - base);
    int mine = -1;
    for (int j = 0; j < n; ++j) {
      const int Lj = __shfl_sync(0xffffffffu, L, j);
      const int Vj = __shfl_sync(0xffffffffu, V, j);
      const int idx = Vj == t0 ? 0 : (Vj == t1 ? 1 : (Vj == t2 ? 2 : (Vj == t3 ? 3 : -1)));
      const bool is_match = Lj > 0;
      if (lane == j) mine = (is_match && idx >= 0) ? idx : -1;
      if (is_match && idx < 0) {
        t3 = t2;
        t2 = t1;
        t1 = t0;
        t0 = Vj;
      }
    }
    if (base + lane < T) op_rep[(long long)(base + lane) * B + b] = mine;
    L = Ln;
    V = Vn;
  }
}

}  // namespace

// op_len, op_val [T, B] i32; op_rep [T, B] i32 out.
NLZM_API int nlzm_repify(const void* op_len, const void* op_val, void* op_rep, int T, int B,
                         int device, void* stream) {
  cudaSetDevice(device);
  if (B == 0 || T == 0) return 0;
  const int warps_per_cta = NTHREADS / 32;
  repify_kernel<<<(B + warps_per_cta - 1) / warps_per_cta, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int*)op_len, (const int*)op_val, (int*)op_rep, T, B);
  return launch_status();
}
