// K3: per-cell segment sums of the reproducible spreading pass.
//
// Replaces icebergs_tpu/ops/pallas_spread.py::segment_spread_sums (and its
// bitwise twins segment_spread_sums_p / segment_spread_sums_g).  Input is
// the cell-sorted payload stack rows_s (R, N) (row layout R_* below) and
// cell_starts; for each cell it builds every row's 9 rectangle spreading
// weights (pallas_spread._weights_from_rows, icebergs.F90:3960-4001), the
// 36 weight x value products, the 7 per-cell diagnostic columns and the
// n_extra pass-through columns, and sums them over the cell's rows.
//
// The TPU kernel summed with a 0/1 selection matmul whose contraction runs
// in row order, i.e. each cell's rows in (cell, id) order.  Here one
// thread owns one cell and adds its own rows [cell_starts[c],
// cell_starts[c+1]) sequentially in registers: the same association, no
// atomics, no window (so no overflow; the window flag is still computed
// by the wrapper and reported), and no slop rows from other cells.
//
// Bound: memory.  Every sorted row is read once (13 + n_extra floats) and
// every cell writes 43 + n_extra sums; the ~180 flops per row are cheap.
// Neighbouring threads own neighbouring cells, whose rows are adjacent in
// the sorted slab, so the row reads of a warp cover one contiguous range.
// Build with -fmad=false so that the weight products round as the
// reference's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// payload rows (icebergs_tpu/ops/pallas_spread.py:47-60)
constexpr int R_XI = 1, R_YJ = 2, R_AREA = 3, R_MASS = 4, R_LWMS = 5, R_U = 6,
              R_V = 7, R_MASSMS = 8, R_VIRT = 9, R_BITS = 10, R_FLB = 11,
              R_FLBB = 12, R_NFIX = 13;
// per-cell table rows: 9 neighbour masks then the cell area
constexpr int T_AREA = 9;
constexpr int NSPREAD = 36, NCELLCOL = 7, MAX_EXTRA = 16;

__global__ void segment_spread_kernel(const float* __restrict__ rows, int n,
                                      const int32_t* __restrict__ cell_starts,
                                      const float* __restrict__ tbl,
                                      float* __restrict__ S, int ncells,
                                      int n_extra, int use_old_spreading) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncells) return;
  const long long N = n;
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = tbl[(long long)k * ncells + c];
  const float area_cell = tbl[(long long)T_AREA * ncells + c];
  const float area_c = fmaxf(area_cell, 1e-30f);

  float acc[NSPREAD + NCELLCOL + MAX_EXTRA];
#pragma unroll
  for (int k = 0; k < NSPREAD + NCELLCOL + MAX_EXTRA; ++k) acc[k] = 0.f;

  const int r0 = cell_starts[c], r1 = cell_starts[c + 1];
  for (int r = r0; r < r1; ++r) {
    const float x = rows[R_XI * N + r];
    const float y = rows[R_YJ * N + r];
    float xL, xR, yD, yU;
    if (use_old_spreading) {
      xL = fminf(0.5f, fmaxf(0.f, 0.5f - x));
      xR = fminf(0.5f, fmaxf(0.f, x - 0.5f));
      yD = fminf(0.5f, fmaxf(0.f, 0.5f - y));
      yU = fminf(0.5f, fmaxf(0.f, y - 0.5f));
    } else {
      const float Area = rows[R_AREA * N + r];
      const float L = area_cell > 0.f
                          ? fminf(sqrtf(Area / fmaxf(area_cell, 1e-30f)), 1.f)
                          : 1.f;
      const float Ls = fmaxf(L, 1e-30f);
      const float inv = 1.f / Ls;
      xL = fminf(0.5f, fmaxf(0.f, 0.5f - x / Ls));
      xR = fminf(0.5f, fmaxf(0.f, x / Ls + (0.5f - inv)));
      yD = fminf(0.5f, fmaxf(0.f, 0.5f - y / Ls));
      yU = fminf(0.5f, fmaxf(0.f, y / Ls + (0.5f - inv)));
    }
    const float xC = fmaxf(0.f, 1.f - (xL + xR));
    const float yC = fmaxf(0.f, 1.f - (yD + yU));
    float w[9];
    w[0] = yD * xL * m[0];
    w[1] = yD * xC * m[1];
    w[2] = yD * xR * m[2];
    w[3] = yC * xL * m[3];
    w[5] = yC * xR * m[5];
    w[6] = yU * xL * m[6];
    w[7] = yU * xC * m[7];
    w[8] = yU * xR * m[8];
    w[4] = 1.f - (((w[0] + w[8]) + (w[2] + w[6])) + ((w[3] + w[5]) + (w[1] + w[7])));

    const float mass = rows[R_MASS * N + r];
    const float lwms = rows[R_LWMS * N + r];
    const float u = rows[R_U * N + r];
    const float v = rows[R_V * N + r];
    const float vals[4] = {mass, lwms, u * lwms, v * lwms};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[k * 4 + f] += w[k] * vals[f];
    }
    const float w_cell = rows[R_MASSMS * N + r] / area_c;
    acc[36] += w_cell;
    acc[37] += w_cell * u;
    acc[38] += w_cell * v;
    acc[39] += rows[R_VIRT * N + r];
    acc[40] += rows[R_BITS * N + r];
    acc[41] += rows[R_FLB * N + r];
    acc[42] += rows[R_FLBB * N + r];
#pragma unroll
    for (int e = 0; e < MAX_EXTRA; ++e) {
      if (e < n_extra) acc[43 + e] += rows[(R_NFIX + e) * N + r];
    }
  }
  const int out = NSPREAD + NCELLCOL + n_extra;
  float* Sc = S + (long long)c * out;
#pragma unroll
  for (int k = 0; k < NSPREAD + NCELLCOL + MAX_EXTRA; ++k) {
    if (k < out) Sc[k] = acc[k];
  }
}

}  // namespace

extern "C" int ib_max_spread_extra() { return MAX_EXTRA; }

extern "C" int ib_segment_spread_sums(const void* rows, int n,
                                      const void* cell_starts, const void* tbl,
                                      void* S, int ncells, int n_extra,
                                      int use_old_spreading, void* stream) {
  if (ncells == 0) return (int)cudaGetLastError();
  const int threads = 128;
  segment_spread_kernel<<<(ncells + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)rows, n, (const int32_t*)cell_starts, (const float*)tbl,
      (float*)S, ncells, n_extra, use_old_spreading);
  return (int)cudaGetLastError();
}
