// K7: the velocity-dependent pair evaluation over (N, M) pair slabs.
//
// Replaces icebergs_tpu/ops/pallas_pairs.py::_pallas_eval (through
// eval_pair_ia_pallas): per pair the pmag-scaled radial and tangential
// damping weights (Stern et al. 2017 Eq. 8; icebergs.F90:706-804), the
// damping matrix D = wr P + wt (I - P), and per berg the five sums over
// its M candidates: D11, D12, D22, D11 u2 + D12 v2, D12 u2 + D22 v2.
// Output (N, 8): those five, then three zero columns, as the TPU kernel.
//
// Bound: bytes.  An inactive pair adds exact zeros, so the function needs
// the (N, M) bool mask (216 MB at N = 1M, M = 216) and, of the seven
// float32 slabs, only the 32-byte sectors that hold an active pair; a row
// rarely has more than two.  Reading every slab whole would move 6.3 GB.
// The slabs are row-major, so one thread per row would stride M floats
// between neighbouring threads; here one warp takes a row and its lanes
// stride over M, so the mask is read in whole sectors, and a lane reads
// the seven slab values of a pair only where the mask is set.  Each lane
// keeps five partial sums in registers and a shuffle tree reduces them.
// That association differs from torch.sum's, so the kernel agrees with
// the plain version to rounding.  The per-pair arithmetic follows the
// plain version expression by expression; build with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool PMAG>
__global__ void pair_eval_kernel(
    const uint8_t* __restrict__ active, const float* __restrict__ P11,
    const float* __restrict__ P12, const float* __restrict__ P22,
    const float* __restrict__ crad, const float* __restrict__ ctan,
    const float* __restrict__ u2, const float* __restrict__ v2,
    const float* __restrict__ u0, const float* __restrict__ v0,
    const float* __restrict__ u1, const float* __restrict__ v1, int n, int m,
    float* __restrict__ out) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp leaves together
  const float U0 = u0[row], V0 = v0[row], U1 = u1[row], V1 = v1[row];
  const long long base = row * m;
  float s11 = 0.f, s12 = 0.f, s22 = 0.f, sux = 0.f, suy = 0.f;
  for (int k = lane; k < m; k += 32) {
    const long long i = base + k;
    if (!active[i]) continue;
    const float p11 = P11[i], p12 = P12[i], p22 = P22[i];
    const float uu2 = u2[i], vv2 = v2[i];
    float wr = crad[i], wt = ctan[i];
    if (PMAG) {
      const float du1 = uu2 - U1, dv1 = vv2 - V1;
      const float du0 = uu2 - U0, dv0 = vv2 - V0;
      wr = pmag(p11, p12, p22, wr, du1, dv1, du0, dv0);
      wt = pmag(1.f - p11, -p12, 1.f - p22, wt, du1, dv1, du0, dv0);
    }
    const float d11 = wr * p11 + wt * (1.f - p11);
    const float d12 = wr * p12 + wt * (-p12);
    const float d22 = wr * p22 + wt * (1.f - p22);
    s11 += d11;
    s12 += d12;
    s22 += d22;
    sux += d11 * uu2 + d12 * vv2;
    suy += d12 * uu2 + d22 * vv2;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s11 += __shfl_down_sync(0xffffffffu, s11, off);
    s12 += __shfl_down_sync(0xffffffffu, s12, off);
    s22 += __shfl_down_sync(0xffffffffu, s22, off);
    sux += __shfl_down_sync(0xffffffffu, sux, off);
    suy += __shfl_down_sync(0xffffffffu, suy, off);
  }
  if (lane == 0) {
    float* o = out + row * 8;
    o[0] = s11;
    o[1] = s12;
    o[2] = s22;
    o[3] = sux;
    o[4] = suy;
    o[5] = 0.f;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

}  // namespace

extern "C" int ib_pair_eval(const void* active, const void* P11,
                            const void* P12, const void* P22, const void* crad,
                            const void* ctan, const void* u2, const void* v2,
                            const void* u0, const void* v0, const void* u1,
                            const void* v1, int n, int m, int pmag_on,
                            void* out, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 rows per block
  const long long blocks = ((long long)n * 32 + threads - 1) / threads;
  auto kern = pmag_on ? pair_eval_kernel<true> : pair_eval_kernel<false>;
  kern<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)active, (const float*)P11, (const float*)P12,
      (const float*)P22, (const float*)crad, (const float*)ctan,
      (const float*)u2, (const float*)v2, (const float*)u0, (const float*)v0,
      (const float*)u1, (const float*)v1, n, m, (float*)out);
  return (int)cudaGetLastError();
}
