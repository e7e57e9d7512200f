// K7: the velocity-dependent pair evaluation over (N, M) pair slabs.
//
// Replaces icebergs_tpu/ops/pallas_pairs.py::_pallas_eval (through
// eval_pair_ia_pallas): per pair the pmag-scaled radial and tangential
// damping weights (Stern et al. 2017 Eq. 8; icebergs.F90:706-804), the
// damping matrix D = wr P + wt (I - P), and per berg the five sums over
// its M candidates: D11, D12, D22, D11 u2 + D12 v2, D12 u2 + D22 v2.
// Output (5, N), one contiguous row per sum.  The TPU kernel's (N, 8)
// block and its three zero columns are its tiling, not the function.
//
// Bound: bytes.  An inactive pair adds exact zeros, so the function needs
// the (N, M) bool mask (216 MB at N = 1M, M = 216), the four (N,)
// velocities, of the seven float32 slabs only the 32-byte sectors that
// hold an active pair (a row rarely has more than two; reading every slab
// whole would move 6.3 GB), and the 5 x 4 x N bytes of output.  At the
// headline bucket tables the mask is four fifths of it.
//
// Design.  The mask streams as one flat byte sequence in 16-byte vectors.
// A CTA of 256 threads takes a tile of TR rows, TR a multiple of 16 (so
// every tile starts on a 16-byte boundary of the 16-byte aligned mask,
// whatever M is) with TR x M <= 32 KB; a longer tile (M > 2048) is walked
// in 32 KB groups.  Each thread issues all its loads (ld.global.nc, up to
// 8 vectors, neighbouring threads on neighbouring vectors) before it tests
// any, so each resident CTA keeps ~32 KB in flight, well above the ~25 KB
// per SM that the HBM rate needs at its latency: plain loads reach the
// bound here without TMA's descriptors, and the unaligned rows cost
// nothing since tiles, not rows, are aligned.  The last tile's ragged tail
// is read byte by byte.  A group with no set byte costs one barrier: no
// scan, no slab read.  Otherwise its set bytes are ranked in (row, k)
// order (per-warp prefix counts and per-warp totals) and handed out 256
// at a time, one pair per thread, which issues its seven slab loads
// (and its row's velocities) before it uses any and writes its five
// terms to shared memory.  The first thread of each row's run then adds
// them to the row's sums in ascending k.  So each row sums its active
// terms in ascending k from +0: the same bits on every run (no atomics),
// and bit for bit the plain version's sums on a row with at most two
// active pairs, where adding the zeros of the inactive ones is exact.
// The per-pair arithmetic follows the plain version expression by
// expression; build with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                            // vectors a thread loads
constexpr int kGroupBytes = kThreads * kVec * 16;  // 32 KB
constexpr int kRowsMax = kThreads;                 // rows per tile, at most
constexpr int kMinCtas = 4;
static_assert(kRowsMax == kThreads, "one thread per row of a tile");

// Rows per tile at M: the largest multiple of 16, at most kRowsMax, whose
// bytes fit one group; 16 where even those do not (several groups).
int tile_rows(int m) {
  if (m <= 0) return kRowsMax;
  const int r = kGroupBytes / m / 16 * 16;
  return r < 16 ? 16 : (r > kRowsMax ? kRowsMax : r);
}

__device__ __forceinline__ float pmag(float a11, float a12, float a22,
                                      float coef, float du1, float dv1,
                                      float du0, float dv0) {
  const float a1 = a11 * du1 + a12 * dv1;
  const float b1 = a12 * du1 + a22 * dv1;
  const float a0 = a11 * du0 + a12 * dv0;
  const float b0 = a12 * du0 + a22 * dv0;
  const float m1 = sqrtf(a1 * a1 + b1 * b1);
  const float m0 = sqrtf(a0 * a0 + b0 * b0);
  return coef * 0.5f * (m1 + m0);
}

// The 16 mask bytes at byte `at`: one vector load, or byte by byte where
// the vector would cross the end of the mask.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p,
                                        long long at, long long total) {
  if (at + 16 <= total) return __ldg(reinterpret_cast<const uint4*>(p + at));
  unsigned long long lo = 0, hi = 0;
  for (int b = 0; b < 16 && at + b < total; ++b) {
    const unsigned long long x = (unsigned long long)__ldg(p + at + b)
                                 << (8 * (b & 7));
    if (b < 8) lo |= x; else hi |= x;
  }
  return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi,
                    (unsigned)(hi >> 32));
}

// Bit b of the result is set where byte b of w is nonzero (b < 4).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned mask16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

template <bool PMAG>
__global__ void __launch_bounds__(kThreads, kMinCtas) pair_eval_kernel(
    const uint8_t* __restrict__ active, const float* __restrict__ P11,
    const float* __restrict__ P12, const float* __restrict__ P22,
    const float* __restrict__ crad, const float* __restrict__ ctan,
    const float* __restrict__ u2, const float* __restrict__ v2,
    const float* __restrict__ u0, const float* __restrict__ v0,
    const float* __restrict__ u1, const float* __restrict__ v1, int n, int m,
    int tr, float* __restrict__ out) {
  __shared__ float acc[5][kRowsMax];   // each row's running sums
  __shared__ float term[5][kThreads];  // one chunk's terms
  __shared__ int eoff[kThreads];       // one chunk's pairs (tile byte)
  __shared__ int erow[kThreads];       // and their rows in the tile
  __shared__ int wtot[kVec / 2][kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long r0 = (long long)blockIdx.x * tr;
  const int rows = (int)(n - r0 < tr ? n - r0 : tr);
  const long long tile0 = r0 * m, total = (long long)n * m;
  const int tbytes = rows * m;
#pragma unroll
  for (int f = 0; f < 5; ++f) acc[f][t] = 0.f;

  for (int g0 = 0; g0 < tbytes; g0 += kGroupBytes) {
    const int gb = tbytes - g0 < kGroupBytes ? tbytes - g0 : kGroupBytes;
    const int nvec = (gb + 15) >> 4;
    uint4 v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int vi = j * kThreads + t;
      v[j] = vi < nvec ? load16(active, tile0 + g0 + 16LL * vi, total)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    bool any = false;  // each vector tested as two 64-bit words
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      any |= ((unsigned long long)v[j].y << 32 | v[j].x |
              (unsigned long long)v[j].w << 32 | v[j].z) != 0ull;
    if (!__syncthreads_or(any)) continue;

    // rank the set bytes in (row, k) order: vector j * 256 + t of the
    // group comes before j * 256 + t + 1.  Two 16-bit counts per scan
    unsigned msk[kVec];
    int base[kVec];
#pragma unroll
    for (int j = 0; j < kVec; j += 2) {
      msk[j] = mask16(v[j]);
      msk[j + 1] = mask16(v[j + 1]);
      const unsigned c = __popc(msk[j]) | (unsigned)__popc(msk[j + 1]) << 16;
      unsigned x = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) wtot[j / 2][warp] = (int)x;
      base[j] = (int)((x - c) & 0xffffu);
      base[j + 1] = (int)((x - c) >> 16);
    }
    __syncthreads();
    int run = 0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      for (int w = 0; w < kWarps; ++w) {
        const unsigned x = (unsigned)wtot[j / 2][w];
        if (w == warp) base[j] += run;
        run += (int)((j & 1) ? x >> 16 : x & 0xffffu);
      }
    }

    for (int p0 = 0; p0 < run; p0 += kThreads) {
      // hand out the pairs ranked [p0, p0 + 256)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        unsigned bits = msk[j];
        int pos = base[j];
        if (!bits || pos >= p0 + kThreads || pos + __popc(bits) <= p0)
          continue;
        const int vo = g0 + 16 * (j * kThreads + t);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          if (pos >= p0 && pos < p0 + kThreads) eoff[pos - p0] = vo + b;
          ++pos;
        }
      }
      __syncthreads();
      const int nc = run - p0 < kThreads ? run - p0 : kThreads;
      if (t < nc) {
        const int off = eoff[t];
        const int rl = off / m;
        const long long i = tile0 + off;
        const float p11 = __ldg(P11 + i), p12 = __ldg(P12 + i),
                    p22 = __ldg(P22 + i), uu2 = __ldg(u2 + i),
                    vv2 = __ldg(v2 + i);
        float wr = __ldg(crad + i), wt = __ldg(ctan + i);
        if (PMAG) {
          const long long r = r0 + rl;
          const float U0 = __ldg(u0 + r), V0 = __ldg(v0 + r),
                      U1 = __ldg(u1 + r), V1 = __ldg(v1 + r);
          const float du1 = uu2 - U1, dv1 = vv2 - V1;
          const float du0 = uu2 - U0, dv0 = vv2 - V0;
          wr = pmag(p11, p12, p22, wr, du1, dv1, du0, dv0);
          wt = pmag(1.f - p11, -p12, 1.f - p22, wt, du1, dv1, du0, dv0);
        }
        const float d11 = wr * p11 + wt * (1.f - p11);
        const float d12 = wr * p12 + wt * (-p12);
        const float d22 = wr * p22 + wt * (1.f - p22);
        term[0][t] = d11;
        term[1][t] = d12;
        term[2][t] = d22;
        term[3][t] = d11 * uu2 + d12 * vv2;
        term[4][t] = d12 * uu2 + d22 * vv2;
        erow[t] = rl;
      }
      __syncthreads();
      if (t < nc && (t == 0 || erow[t - 1] != erow[t])) {
        // the first pair of its row in this chunk adds the row's run
        const int rl = erow[t];
        float s0 = acc[0][rl], s1 = acc[1][rl], s2 = acc[2][rl],
              s3 = acc[3][rl], s4 = acc[4][rl];
        for (int e = t; e < nc && erow[e] == rl; ++e) {
          s0 += term[0][e];
          s1 += term[1][e];
          s2 += term[2][e];
          s3 += term[3][e];
          s4 += term[4][e];
        }
        acc[0][rl] = s0;
        acc[1][rl] = s1;
        acc[2][rl] = s2;
        acc[3][rl] = s3;
        acc[4][rl] = s4;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (t < rows) {
#pragma unroll
    for (int f = 0; f < 5; ++f) out[(long long)f * n + r0 + t] = acc[f][t];
  }
}

using KernelFn = decltype(&pair_eval_kernel<true>);

KernelFn kernel_of(int pmag_on) {
  return pmag_on ? pair_eval_kernel<true> : pair_eval_kernel<false>;
}

}  // namespace

extern "C" int ib_pair_eval(const void* active, const void* P11,
                            const void* P12, const void* P22, const void* crad,
                            const void* ctan, const void* u2, const void* v2,
                            const void* u0, const void* v0, const void* u1,
                            const void* v1, int n, int m, int pmag_on,
                            void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int tr = tile_rows(m);
  const long long blocks = ((long long)n + tr - 1) / tr;
  kernel_of(pmag_on)<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)active, (const float*)P11, (const float*)P12,
      (const float*)P22, (const float*)crad, (const float*)ctan,
      (const float*)u2, (const float*)v2, (const float*)u0, (const float*)v0,
      (const float*)u1, (const float*)v1, n, m, tr, (float*)out);
  return (int)cudaGetLastError();
}

// The rows per tile at m, the kernel's static shared memory and its
// resident CTAs per SM at 256 threads.
extern "C" int ib_pair_eval_config(int m, int pmag_on, int* rows_per_tile,
                                   int* smem, int* ctas_per_sm) {
  *rows_per_tile = tile_rows(m);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_of(pmag_on));
  if (e != cudaSuccess) return (int)e;
  *smem = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel_of(pmag_on), kThreads, 0);
}
