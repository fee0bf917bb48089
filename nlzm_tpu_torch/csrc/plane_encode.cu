// Wide-profile plane encode: chunk-adaptive tables worked out from the
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
// Bound: bytes, the pairs and mask written (5 bytes a (step, read, lane));
// then each lane's backward chain, one dependent u32 step a symbol.
// Design: one launch encodes up to five planes, one CTA of 256 threads a
// (block, plane), the planes with the longest chains first (their CTAs
// start first); the planes' descriptors pass by value as a kernel
// parameter (nothing is uploaded for a launch), and each CTA copies its own
// into shared memory. No chunk waits on the one before:
// - The CTA stages the block's live keys (row * alph + symbol, clamped to
//   the read's rows and alphabet; a byte, or a u16 past 256 entries) in
//   shared memory: 16 bytes a thread, clamped with __vminu4, for byte
//   symbols of one row.
// - Counts: the symbols are known, so a chunk's counts do not depend on
//   its tables, and every chunk is counted at once. For one-read,
//   one-row planes (every wire plane) a warp takes a chunk, whose keys
//   are one run of bytes: up to 8 keys in registers (a byte a key, summed
//   over the warp in 16-bit fields), past that a shared atomic a symbol in
//   the warp's own row. Else a warp a step, a shared atomic a symbol.
// - carry_k = (carry_{k-1} >> 1) + count_k in place of the counts, a
//   thread an entry, serially over the chunks; then every chunk's fences
//   (u16) at once, a warp a (chunk, read, row), with build_fences'
//   arithmetic (common.cuh).
// - Backward: a thread a lane from the block's last live step back (the
//   steps past it are filled by the whole CTA: pairs 0, mask 0); each
//   step's (start, freq, 1 / freq) comes from its chunk's fences and its
//   key in shared memory, worked out while the chain takes the step
//   before, and the division is a float estimate corrected once.
// - A plane whose keys and tables pass PE_SMEM_MAX (a 128 KiB all-literal
//   block's lit plane: 258 chunks) is "large": its counts and fences live
//   in device scratch, its keys are read from the inputs, and the backward
//   pass copies windows of chunks' fences into shared memory
//   (ops/wide_encode_dev.py plane_layout picks the path).
// Any number of reads (<= 8), lanes (<= 256) and context rows; symbol and
// row indices are clamped to the read's alphabet and rows, so no load
// leaves the tables.
#include "common.cuh"

namespace {

constexpr int MAX_R = 8;
constexpr int MAX_PLANES = 5;
constexpr int NT = 256;  // threads a CTA (wide_encode_dev.PE_THREADS); at most NT lanes
constexpr int NWARPS = NT / 32;
constexpr int PE_FIELDS = 51;  // int64 fields a plane on the host (ops/wide_encode_dev.py)

struct Plane {
  const void* sym[MAX_R];   // [B, steps * L] u8 or i32
  const int* row[MAX_R];    // [B, steps * L] i32, or null for row 0
  const int* prior[MAX_R];  // [rows, alph] i32 counts, or null for uniform tables
  int alph[MAX_R], rows[MAX_R];
  int coff[MAX_R], foff[MAX_R];  // a read's first entry in a chunk's counts / fences
  unsigned* seeds;
  int* pairs;
  uint8_t* mask;
  const int* n_sym;
  uint8_t* scratch;   // large planes: block 0's counts, then its fences
  long long sstride;  // scratch bytes a block
  long long cbytes;   // bytes of a block's counts (16-aligned)
  int B, L, R, steps, NC, KC, KF, RT, cta0;  // KC / KF entries a chunk, RT rows of all reads
  int sym_u8, key16, fast, simple, large;
  // fast: u8 symbols and one row a read, so keys are clamped bytes; simple:
  // also one read of at most 256 symbols (every wire plane)
};

struct Params {
  Plane p[MAX_PLANES];
  int np, smem;
};

__host__ __device__ __forceinline__ long long align16(long long v) { return (v + 15) & ~15LL; }

// step s's chunk (format/wide.py chunk_schedule: 2, 2, 4, 8, then 8s):
// 0, 0, 1, 1, 2 x 4, 3 x 8, then one every 8 steps; a plane of n > 0
// steps has chunk_of(n - 1) + 1 chunks
__host__ __device__ __forceinline__ int chunk_of(int s) {
#ifdef __CUDA_ARCH__
  return s < 16 ? max(31 - __clz(s), 0) : (s >> 3) + 2;
#else
  return s < 16 ? (s > 0 ? 31 - __builtin_clz((unsigned)s) : 0) : (s >> 3) + 2;
#endif
}

__device__ __forceinline__ int chunk_start(int k) { return k < 4 ? (k ? 1 << k : 0) : 8 * k - 16; }

// read r's clamped key at element e of the [B, steps * L] inputs
__device__ __forceinline__ int key_at(const Plane& P, int r, long long e) {
  const int a = P.alph[r];
  int y = P.sym_u8 ? (int)static_cast<const uint8_t*>(P.sym[r])[e]
                   : static_cast<const int*>(P.sym[r])[e];
  y = clampi(y, 0, a - 1);
  return P.row[r] ? clampi(P.row[r][e], 0, P.rows[r] - 1) * a + y : y;
}

// a step's record for the chain, worked out ahead of it
struct Rec {
  unsigned fq, st;
  float rf;  // 1 / fq, within 1 ulp (rcp.approx)
  bool act;
};

// One step of the chain on state x: returns the pair (x's low 16 bits) and
// sets over (a renorm); x = ((x1 / fq) << 14) + x1 % fq + st for a live
// lane. q = x1 / fq comes from the float quotient, within 1 of it (q <
// 2^18: x1 < fq << 18 without a renorm, < 2^16 after one; the two
// roundings and the reciprocal's ulp stay under 2^-21 of it), then one
// correction each way on the remainder.
__device__ __forceinline__ unsigned chain_step(unsigned& x, const Rec& c, bool& over) {
  const unsigned pair = x & 0xFFFFu;
  over = c.act && (x >> 18) >= c.fq;
  const unsigned x1 = over ? x >> 16 : x;
  unsigned q = __float2uint_rz(__uint2float_rn(x1) * c.rf);
  int rem = (int)(x1 - q * c.fq);
  q = rem < 0 ? q - 1 : q;
  rem = rem < 0 ? rem + (int)c.fq : rem;
  q = rem >= (int)c.fq ? q + 1 : q;
  rem = rem >= (int)c.fq ? rem - (int)c.fq : rem;
  if (c.act) x = (q << 14) + (unsigned)rem + c.st;
  return pair;
}

template <bool LARGE, bool SIMPLE>
__device__ void encode_block(const Plane& P, int b, uint8_t* sm, int smem) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int L = P.L, R = SIMPLE ? 1 : P.R, KC = P.KC, KF = P.KF, key16 = P.key16;
  const long long Tpad = (long long)P.steps * L;
  const long long base = (long long)b * Tpad;  // symbol / row offset of block b
  const long long obase = base * R;            // output offset of block b
  const long long n = min(max((long long)P.n_sym[b], 0LL), Tpad);
  const int S = (int)((n + L - 1) / L);  // live steps
  const int NCl = S > 0 ? chunk_of(S - 1) + 1 : 0;
  const long long kbytes = align16(Tpad * R * (key16 ? 2 : 1));
  int* cnt;
  uint16_t* fen;
  if (LARGE) {
    cnt = reinterpret_cast<int*>(P.scratch + b * P.sstride);
    fen = reinterpret_cast<uint16_t*>(P.scratch + b * P.sstride + P.cbytes);
  } else {
    cnt = reinterpret_cast<int*>(sm + kbytes);
    fen = reinterpret_cast<uint16_t*>(sm + kbytes + P.cbytes);
  }
  auto key = [&](int r, long long i) -> int {
    if (LARGE) return key_at(P, r, base + i);
    const long long q = r * Tpad + i;
    return key16 ? reinterpret_cast<const uint16_t*>(sm)[q] : sm[q];
  };

  // 1. keys of the live steps into shared memory; the live chunks' counts 0
  const long long live = (long long)S * L;
  if (!LARGE) {
    for (int r = 0; r < R; ++r) {
      const uint8_t* src = static_cast<const uint8_t*>(P.sym[r]) + base;
      if (P.fast && ((uintptr_t)src & 15) == 0 && (Tpad & 15) == 0) {
        const unsigned cap = (unsigned)(P.alph[r] - 1) * 0x01010101u;
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(sm + r * Tpad);
#pragma unroll 4
        for (long long v = t; v < (live + 15) >> 4; v += NT) {
          uint4 w = __ldg(s4 + v);
          w.x = __vminu4(w.x, cap);
          w.y = __vminu4(w.y, cap);
          w.z = __vminu4(w.z, cap);
          w.w = __vminu4(w.w, cap);
          d4[v] = w;
        }
      } else if (key16) {
        uint16_t* d = reinterpret_cast<uint16_t*>(sm) + r * Tpad;
        for (long long i = t; i < live; i += NT) d[i] = (uint16_t)key_at(P, r, base + i);
      } else {
        uint8_t* d = sm + r * Tpad;
        for (long long i = t; i < live; i += NT) d[i] = (uint8_t)key_at(P, r, base + i);
      }
    }
  }
  for (long long j = t; j < (long long)NCl * KC; j += NT) cnt[j] = 0;
  __syncthreads();

  // 2. every live chunk's counts at once. Byte keys in shared memory: a
  // warp a chunk (its keys are one run of bytes), 16 a lane at a time; a
  // key space of at most 8 counted in registers (8-bit fields, two words)
  // and summed over the warp in 16-bit fields, past that a shared atomic a
  // symbol in the warp's own row. Else a warp a step, a shared atomic a
  // symbol.
  if (SIMPLE && !LARGE && (L & 7) == 0) {
    for (int k = warp; k < NCl; k += NWARPS) {
      const int lo = chunk_start(k) * L;
      const int hi = (int)min((long long)chunk_start(k + 1) * L, n);
      int* ck = cnt + k * KC;
      unsigned c0 = 0, c1 = 0;  // keys 0-3 and 4-7, a byte each
      for (int p = lo + 16 * lane; p < hi; p += 512) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(sm + p);
        const unsigned w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const unsigned v = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
          if (p + i < hi) {
            if (KC <= 8) {
              const unsigned inc = 1u << (8 * (v & 3));
              c0 += v < 4 ? inc : 0u;
              c1 += v < 4 ? 0u : inc;
            } else {
              atomicAdd(ck + v, 1);
            }
          }
        }
      }
      if (KC <= 8) {  // uniform over the warp; a field sums to at most 8 L <= 2048
        const int e0 = warp_sum((int)(c0 & 0x00FF00FFu)), o0 = warp_sum((int)((c0 >> 8) & 0x00FF00FFu));
        const int e1 = warp_sum((int)(c1 & 0x00FF00FFu)), o1 = warp_sum((int)((c1 >> 8) & 0x00FF00FFu));
        if (lane < KC) {
          const int e = lane < 4 ? e0 : e1, o = lane < 4 ? o0 : o1;
          ck[lane] = ((lane & 1 ? o : e) >> (lane & 2 ? 16 : 0)) & 0xFFFF;
        }
      }
    }
  } else {
    for (int s = warp; s < S; s += NWARPS) {
      int* cs = cnt + (long long)chunk_of(s) * KC;
      for (int l = lane; l < L; l += 32) {
        const long long i = (long long)s * L + l;
        if (i >= n) break;
        for (int r = 0; r < R; ++r) atomicAdd(cs + P.coff[r] + key(r, i), 1);
      }
    }
  }
  __syncthreads();

  // 3. carries in place of the counts: carry_k = (carry_{k-1} >> 1) +
  // count_k, from the prior (or 0); the last live chunk's is never read
  for (int e = t; e < KC; e += NT) {
    int r = 0;
    while (r + 1 < R && e >= P.coff[r + 1]) ++r;
    int carry = P.prior[r] ? P.prior[r][e - P.coff[r]] : 0;
    constexpr int U = 8;  // counts loaded ahead of the carries
    for (int k0 = 0; k0 + 1 < NCl; k0 += U) {
      int c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int* p = cnt + (long long)(k0 + u) * KC + e;
        c[u] = k0 + u + 1 < NCl ? (LARGE ? __ldcg(p) : *p) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u + 1 < NCl) {
          carry = (carry >> 1) + c[u];
          cnt[(long long)(k0 + u) * KC + e] = carry;
        }
      }
    }
  }
  __syncthreads();

  // 4. every live chunk's fences: chunk 0's from the prior (or uniform),
  // chunk k's from carry_{k-1}; a warp a (chunk, read, row)
  for (int task = warp; task < NCl * P.RT; task += NWARPS) {
    const int k = task / P.RT;
    int row = task - k * P.RT, r = 0;
    while (row >= P.rows[r]) row -= P.rows[r++];
    const int a = P.alph[r];
    uint16_t* f = fen + (long long)k * KF + P.foff[r] + row * (a + 1);
    if (k > 0) {
      build_fences(cnt + (long long)(k - 1) * KC + P.coff[r] + row * a, f, a);
    } else if (P.prior[r]) {
      build_fences(P.prior[r] + row * a, f, a);
    } else {
      for (int i = lane; i <= a; i += 32) f[i] = (uint16_t)(i < a ? i * (CDF_TOTAL / a) : CDF_TOTAL);
      __syncwarp();
    }
  }

  // 5. the steps past the last live one: pairs 0 (the state is still
  // 2^16), mask 0
  {
    const long long lo = obase + live * R, hi = obase + Tpad * R;
    for (long long o = lo + t; o < hi; o += NT) P.pairs[o] = 0;
    long long m0 = min(hi, (lo + 3) & ~3LL), m1 = max(m0, hi & ~3LL);
    for (long long o = lo + t; o < m0; o += NT) P.mask[o] = 0;
    for (long long o = m0 + 4LL * t; o < m1; o += 4LL * NT)
      *reinterpret_cast<unsigned*>(P.mask + o) = 0u;
    for (long long o = m1 + t; o < hi; o += NT) P.mask[o] = 0;
  }
  __syncthreads();

  // 6. backward, a thread a lane; the fences of a window of chunks at a
  // time (large planes copy each window into shared memory)
  const int W = LARGE ? max(1, smem / (2 * KF)) : max(NCl, 1);
  const bool mine = t < L;
  unsigned x = 1u << 16;
  const int ltail = (int)(n - (long long)(S - 1) * L);  // live lanes of step S - 1
  int* const pairs = P.pairs + obase + t;
  uint8_t* const mask = P.mask + obase + t;
  for (int khi = NCl; khi > 0; khi -= W) {
    const int klo = max(0, khi - W);
    const uint16_t* fw = fen;
    if (LARGE) {
      __syncthreads();  // the previous window is consumed
      uint16_t* d = reinterpret_cast<uint16_t*>(sm);
      const uint16_t* src = fen + (long long)klo * KF;
      for (long long i = t; i < (long long)(khi - klo) * KF; i += NT) d[i] = src[i];
      __syncthreads();
      fw = d;  // chunk k's fences at fw + (k - klo) * KF
    }
    const int kbase = LARGE ? klo : 0;
    if (!mine) continue;
    const int j_lo = chunk_start(klo) * R, j_hi = min(S, chunk_start(khi)) * R;
    // (step, read) j's (start, freq, 1 / freq) and whether its lane is live
    auto rec_of = [&](int j) -> Rec {
      Rec c;
      int s = j, off = 0, kk;
      if (SIMPLE) {
        kk = LARGE ? key_at(P, 0, base + (long long)s * L + t) : sm[s * L + t];
      } else {
        s = j / R;
        const int r = j - s * R, a = P.alph[r];
        kk = key(r, (long long)s * L + t);
        off = P.foff[r] + (P.rows[r] > 1 ? kk / a : 0);
      }
      c.act = s < S - 1 || t < ltail;
      const uint16_t* f = fw + (chunk_of(s) - kbase) * KF + off + kk;
      const unsigned f0 = f[0], f1 = f[1];
      c.fq = c.act ? f1 - f0 : 1u;
      c.st = c.act ? f0 : 0u;
      c.rf = rcp_approx((float)c.fq);
      return c;
    };
    // the next step's record worked out while the chain takes this one;
    // stores stream (evict first)
    int* pp = pairs + (long long)(j_hi - 1) * L;
    uint8_t* mp = mask + (long long)(j_hi - 1) * L;
    Rec cur = rec_of(max(j_hi - 1, j_lo));
    for (int j = j_hi - 1; j >= j_lo; --j) {
      const Rec nxt = rec_of(max(j - 1, j_lo));
      bool over;
      const unsigned pair = chain_step(x, cur, over);
      __stcs(pp, (int)pair);
      __stcs(mp, (uint8_t)over);
      pp -= L;
      mp -= L;
      cur = nxt;
    }
  }
  if (mine) P.seeds[(long long)b * L + t] = x;
}

__global__ void __launch_bounds__(NT, 3)  // at most 85 registers: 3 CTAs an SM
    plane_encode_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ __align__(16) Plane pl;  // the CTA's plane, out of the parameter space
  int pi = 0;
  while (pi + 1 < P.np && (int)blockIdx.x >= P.p[pi + 1].cta0) ++pi;
  const int* src = reinterpret_cast<const int*>(&P.p[pi]);
  for (int i = threadIdx.x; i < (int)(sizeof(Plane) / 4); i += NT)
    reinterpret_cast<int*>(&pl)[i] = src[i];
  __syncthreads();
  const int b = (int)blockIdx.x - pl.cta0;
  if (pl.large) {
    if (pl.simple)
      encode_block<true, true>(pl, b, sm, P.smem);
    else
      encode_block<true, false>(pl, b, sm, P.smem);
  } else if (pl.simple) {
    encode_block<false, true>(pl, b, sm, P.smem);
  } else {
    encode_block<false, false>(pl, b, sm, P.smem);
  }
}

}  // namespace

// planes: np x PE_FIELDS int64 on the host, a plane each, in launch order
// (its CTAs first for the first plane): symbol pointers [8] ([B, steps * L]
// u8 or i32), context-row pointers [8] ([B, steps * L] i32, or 0 for row
// 0), prior pointers [8] ([rows, alph] i32, or 0), alph [8], rows [8],
// then seeds ([B, L] u32 out), pairs ([B, steps * R * L] i32 out), mask
// ([B, steps * R * L] u8 out), n_sym ([B] i32), B, L, R, steps, sym_u8,
// large, and its scratch offset in bytes (large planes). scratch: device
// bytes for the large planes (B x (counts + fences) each). smem_bytes: the
// launch's dynamic shared memory, which every plane's keys and tables must
// fit (a large plane's one chunk of fences).
NLZM_API int nlzm_plane_encode(const void* planes, void* scratch, int np, int smem_bytes,
                               int device, void* stream) {
  cudaSetDevice(device);
  if (np < 1 || np > MAX_PLANES || smem_bytes < 0) return (int)cudaErrorInvalidValue;
  Params P{};
  P.np = np;
  P.smem = smem_bytes;
  int ctas = 0;
  const long long* in = static_cast<const long long*>(planes);
  for (int i = 0; i < np; ++i) {
    const long long* f = in + (long long)i * PE_FIELDS;
    Plane& q = P.p[i];
    q.R = (int)f[46];
    q.L = (int)f[45];
    q.steps = (int)f[47];
    q.B = (int)f[44];
    if (q.R < 1 || q.R > MAX_R || q.L < 1 || q.L > NT || q.steps < 0 || q.B < 0)
      return (int)cudaErrorInvalidValue;
    q.NC = q.steps > 0 ? chunk_of(q.steps - 1) + 1 : 1;
    int maxkey = 0;
    for (int r = 0; r < q.R; ++r) {
      q.sym[r] = reinterpret_cast<const void*>(f[r]);
      q.row[r] = reinterpret_cast<const int*>(f[8 + r]);
      q.prior[r] = reinterpret_cast<const int*>(f[16 + r]);
      q.alph[r] = (int)f[24 + r];
      q.rows[r] = (int)f[32 + r];
      if (q.alph[r] < 1 || q.alph[r] > CDF_TOTAL || q.rows[r] < 1) return (int)cudaErrorInvalidValue;
      q.coff[r] = q.KC;
      q.foff[r] = q.KF;
      q.KC += q.rows[r] * q.alph[r];
      q.KF += q.rows[r] * (q.alph[r] + 1);
      q.RT += q.rows[r];
      maxkey = max(maxkey, q.rows[r] * q.alph[r]);
    }
    q.seeds = reinterpret_cast<unsigned*>(f[40]);
    q.pairs = reinterpret_cast<int*>(f[41]);
    q.mask = reinterpret_cast<uint8_t*>(f[42]);
    q.n_sym = reinterpret_cast<const int*>(f[43]);
    q.sym_u8 = f[48] != 0;
    q.large = f[49] != 0;
    q.key16 = maxkey > 256;
    q.fast = q.sym_u8 && !q.key16;
    for (int r = 0; r < q.R; ++r) q.fast = q.fast && q.rows[r] == 1;
    q.simple = q.R == 1 && q.rows[0] == 1 && !q.key16;
    q.cbytes = align16((long long)q.NC * q.KC * 4);
    const long long tables = q.cbytes + align16((long long)q.NC * q.KF * 2);
    const long long keys = align16((long long)q.steps * q.L * q.R * (q.key16 ? 2 : 1));
    if (q.large) {
      if (2LL * q.KF > smem_bytes) return (int)cudaErrorInvalidValue;
      q.scratch = static_cast<uint8_t*>(scratch) + f[50];
      q.sstride = tables;
    } else if (maxkey > 65536 || keys + tables > smem_bytes) {
      return (int)cudaErrorInvalidValue;
    }
    q.cta0 = ctas;
    ctas += q.B;
  }
  if (ctas == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(plane_encode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  plane_encode_kernel<<<ctas, NT, smem_bytes, (cudaStream_t)stream>>>(P);
  return launch_status();
}

// The launch's shape on this card at smem_bytes of dynamic shared memory:
// out [4] i32 = registers a thread, resident CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs, threads a CTA.
NLZM_API int nlzm_plane_encode_shape(void* out, int smem_bytes, int device, void* stream) {
  (void)stream;
  const int threads = NT;
  cudaSetDevice(device);
  cudaError_t e = cudaFuncSetAttribute(plane_encode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, (const void*)plane_encode_kernel);
  int ctas = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, (const void*)plane_encode_kernel,
                                                      threads, smem_bytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = ctas;
  o[2] = sms;
  o[3] = threads;
  return 0;
}
