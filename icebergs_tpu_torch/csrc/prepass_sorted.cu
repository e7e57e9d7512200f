// K5: the contact prepass search over the cell-sorted slab.
//
// Replaces icebergs_tpu/ops/pallas_prepass.py::contact_prepass_sorted: K2's
// search without the partner-feature extraction.  For each block of BN
// consecutive sorted bergs it scans 2r+1 strips of cells [c_lo, c_hi]
// (grid rows j-r .. j+r of the block's cell span).  A candidate is engaged
// when its key lies in the strip, both sides are alive, it is not the berg
// itself, neither side has fl_k == -1, (with group != 0) it is in another
// conglomerate, and r^2 <= crit^2 * slack with crit = max(R1 + R2,
// contact_distance).  Per berg it writes the engaged count and the min /
// max engaged sorted slot (-1 when none).
//
// The TPU kernel DMAs a fixed window of W rows per strip, starting at the
// strip's first slot rounded down to 8, and masks by key.  On the sorted
// slab that is the slot range [cell_starts[c_lo], min(cell_starts[c_hi+1],
// 8*(cell_starts[c_lo]/8) + W, N)), which this kernel scans directly: the
// same candidates, including in blocks the wrapper flags bad (whose window
// is truncated), so every output equals the TPU kernel's.
//
// Bound: memory latency, not arithmetic.  At the 1M-berg headline a block
// of 128 bergs reads ~3 strips of ~35 candidate rows of 32 bytes; the
// (N, 8) row layout lets a block stage a tile of candidate rows into
// shared memory with two 16-byte loads per thread (a warp reads 1 KB
// contiguous), after which every thread compares against every staged row
// by broadcast reads.  The outputs are three int32 per berg, written
// once.  Build with -fmad=false: r^2 and crit^2 * slack must round as the
// reference rounds them, or engagement flips at the boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// packed feature columns (icebergs_tpu/ops/pallas_prepass.py:50)
// lon_old, lat_old, radius, fl_k | alive, key, group, 0

__global__ void prepass_sorted_kernel(const float4* __restrict__ P, int n,
                                      const int32_t* __restrict__ cell_starts,
                                      const int32_t* __restrict__ c_lo,
                                      const int32_t* __restrict__ c_hi,
                                      int nstrips, int window, int group,
                                      float cd, float slack,
                                      int32_t* __restrict__ cnt_out,
                                      int32_t* __restrict__ pmin_out,
                                      int32_t* __restrict__ pmax_out) {
  extern __shared__ float4 tile[];  // 2 float4 per staged row
  const int bn = blockDim.x;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int gid = b * bn + t;
  const bool own = gid < n;
  float4 a0 = make_float4(0.f, 0.f, 0.f, -1.f);
  float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (own) {
    a0 = P[2 * (long long)gid];
    a1 = P[2 * (long long)gid + 1];
  }
  const float lon1 = a0.x, lat1 = a0.y, R1 = a0.z, fl1 = a0.w;
  const float al1 = a1.x, g1 = a1.z;
  const bool active = own && al1 > 0.5f && fl1 != -1.f;
  const int big = 2 * n;
  int cnt = 0, vmin = big, vmax = -1;

  for (int s = 0; s < nstrips; ++s) {
    const int clo = c_lo[b * nstrips + s];
    const int chi = c_hi[b * nstrips + s];
    const float fclo = (float)clo, fchi = (float)chi;
    const int start = cell_starts[clo];
    const int end = min(min(cell_starts[chi + 1], (start / 8) * 8 + window),
                        n);
    for (int base = start; base < end; base += bn) {
      const int m = min(bn, end - base);
      __syncthreads();
      if (t < m) {
        const long long r = base + t;
        tile[2 * t] = P[2 * r];
        tile[2 * t + 1] = P[2 * r + 1];
      }
      __syncthreads();
      if (!active) continue;
      for (int k = 0; k < m; ++k) {
        const float4 c0 = tile[2 * k];
        const float4 c1 = tile[2 * k + 1];
        const int wid = base + k;
        const bool valid = c1.y >= fclo && c1.y <= fchi && c1.x > 0.5f &&
                           wid != gid && c0.w != -1.f &&
                           !(group && c1.z == g1);
        const float rx = lon1 - c0.x;
        const float ry = lat1 - c0.y;
        const float r2 = rx * rx + ry * ry;
        const float crit = fmaxf(R1 + c0.z, cd);
        if (valid && r2 > 0.f && r2 <= crit * crit * slack) {
          ++cnt;
          vmin = min(vmin, wid);
          vmax = max(vmax, wid);
        }
      }
    }
  }
  if (!own) return;
  cnt_out[gid] = cnt;
  pmin_out[gid] = vmin >= big ? -1 : vmin;
  pmax_out[gid] = vmax;
}

}  // namespace

extern "C" int ib_prepass_sorted(const void* P, int n, const void* cell_starts,
                                 const void* c_lo, const void* c_hi,
                                 int nblocks, int block_n, int nstrips,
                                 int window, int group, float cd, float slack,
                                 void* cnt, void* pmin, void* pmax,
                                 void* stream) {
  if (nblocks == 0) return (int)cudaGetLastError();
  const size_t smem = 2 * (size_t)block_n * sizeof(float4);
  prepass_sorted_kernel<<<nblocks, block_n, smem, (cudaStream_t)stream>>>(
      (const float4*)P, n, (const int32_t*)cell_starts, (const int32_t*)c_lo,
      (const int32_t*)c_hi, nstrips, window, group, cd, slack, (int32_t*)cnt,
      (int32_t*)pmin, (int32_t*)pmax);
  return (int)cudaGetLastError();
}
