// K6: the sorted-frame field-to-berg interpolation.
//
// Replaces icebergs_tpu/ops/pallas_interp.py::interp_sorted.  Per berg it
// reads the 53 used slots of its cell's column of the (64, ncells) slot
// table (the corner values of 8 fields, 12 SSH-stencil slopes with their
// nonfinite-indicator bits, 5 A-grid scalars, the two walk-anchor halves)
// and computes the 15 output rows of _env_rows_from_slots in registers:
// the bilinear corner interpolations, the stencil slopes, the rotation to
// the grid's axes, the reference's NaN scrub from the indicator bits, and
// the pass-through scalars.  Dead bergs (key = ncells) read zeros, as the
// TPU kernel's zero-padded table gives them.
//
// Bound: bytes.  The table (64 x ncells floats, read once where bergs of a
// cell sit side by side in the sorted slab), three inputs and 15 output
// rows per berg; about 150 operations per berg.  The TPU kernel staged a
// window of cells per block and selected each berg's column with a 0/1
// matmul (exact only at full precision), with a window-overflow flag and
// a fallback.  Here one thread per berg reads its column by index: no
// window, no matmul, no overflow, and neighbouring threads of the sorted
// slab read the same or adjacent cells, so the reads stay in cache.
// Output rows are written coalesced, (15, N) row-major.  The arithmetic
// follows _env_rows_from_slots expression by expression; build with
// -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// slot rows (icebergs_tpu/ops/pallas_interp.py:48-66)
constexpr int S_CORN = 0, S_DDX = 32, S_DDY = 38, S_SST = 44, S_SSS = 45,
              S_CN = 46, S_HI = 47, S_OD = 48, S_NANX = 49, S_NANY = 50,
              S_M25L = 51, S_M25H = 52;
constexpr int E_NROWS = 15;

__global__ void interp_sorted_kernel(const float* __restrict__ tbl, int ncells,
                                     const int32_t* __restrict__ key,
                                     const float* __restrict__ xi_in,
                                     const float* __restrict__ yj_in, int n,
                                     int old_bug, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = key[i];
  const bool live = c >= 0 && c < ncells;
  auto rd = [&](int s) -> float {
    return live ? tbl[(long long)s * ncells + c] : 0.f;
  };
  const float xi = xi_in[i], yj = yj_in[i];

  float vals[8];
  for (int k = 0; k < 8; ++k) {
    const float f00 = rd(S_CORN + 4 * k + 0);
    const float f01 = rd(S_CORN + 4 * k + 1);
    const float f10 = rd(S_CORN + 4 * k + 2);
    const float f11 = rd(S_CORN + 4 * k + 3);
    if (old_bug)
      vals[k] = (f11 * (1.f - xi) + f01 * xi) * (1.f - yj) +
                (f10 * (1.f - xi) + f00 * xi) * yj;
    else
      vals[k] = (f11 * xi + f01 * (1.f - xi)) * yj +
                (f10 * xi + f00 * (1.f - xi)) * (1.f - yj);
  }
  const float cr = vals[0], sr = vals[1];

  float dX[6], dY[6];
  for (int s = 0; s < 6; ++s) {
    dX[s] = rd(S_DDX + s);
    dY[s] = rd(S_DDY + s);
  }
  const bool yhi = yj >= 0.5f, xhi = xi >= 0.5f;
  const float hxp = yhi ? (yj - 0.5f) * dX[0] + (1.5f - yj) * dX[1]
                        : (yj + 0.5f) * dX[1] + (0.5f - yj) * dX[2];
  const float hxm = yhi ? (yj - 0.5f) * dX[3] + (1.5f - yj) * dX[4]
                        : (yj + 0.5f) * dX[4] + (0.5f - yj) * dX[5];
  const float sx = xi * hxp + (1.f - xi) * hxm;
  const float hyp = xhi ? (xi - 0.5f) * dY[0] + (1.5f - xi) * dY[1]
                        : (xi + 0.5f) * dY[1] + (0.5f - xi) * dY[2];
  const float hym = xhi ? (xi - 0.5f) * dY[3] + (1.5f - xi) * dY[4]
                        : (xi + 0.5f) * dY[4] + (0.5f - xi) * dY[5];
  const float sy = yj * hyp + (1.f - yj) * hym;

  // rot(u, v) = (cos u + sin v, cos v - sin u)
  float o[E_NROWS];
  for (int p = 0; p < 3; ++p) {
    const float u = vals[2 + 2 * p], v = vals[3 + 2 * p];
    o[2 * p] = cr * u + sr * v;
    o[2 * p + 1] = cr * v - sr * u;
  }
  float ssh_x = cr * sx + sr * sy;
  float ssh_y = cr * sy - sr * sx;
  // the reference NaN scrub from the nonfinite-indicator bits: slots
  // (0,1,3,4) feed the >= 0.5 branch, (1,2,4,5) the other
  const int bx = (int)rd(S_NANX), by = (int)rd(S_NANY);
  const int mlo = 0x1b, mhi = 0x36;
  const int px = bx & (yhi ? mlo : mhi);
  const int py = by & (xhi ? mlo : mhi);
  if ((px | py) != 0) {
    ssh_x = 0.f;
    ssh_y = 0.f;
  }
  o[6] = ssh_x;
  o[7] = ssh_y;
  o[8] = rd(S_SST);
  o[9] = rd(S_SSS);
  o[10] = rd(S_CN);
  o[11] = rd(S_HI);
  o[12] = rd(S_OD);
  o[13] = rd(S_M25L);
  o[14] = rd(S_M25H);
  for (int r = 0; r < E_NROWS; ++r) out[(long long)r * n + i] = o[r];
}

}  // namespace

extern "C" int ib_interp_sorted(const void* tbl, int ncells, const void* key,
                                const void* xi, const void* yj, int n,
                                int old_bug, void* out, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 128;
  interp_sorted_kernel<<<(n + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)tbl, ncells, (const int32_t*)key, (const float*)xi,
      (const float*)yj, n, old_bug, (float*)out);
  return (int)cudaGetLastError();
}
