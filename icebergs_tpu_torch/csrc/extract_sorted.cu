// K2: contact search with partner-feature extraction over the cell-sorted slab.
//
// Replaces icebergs_tpu/ops/pallas_prepass.py::contact_extract_sorted_g
// (and its bitwise twins contact_extract_sorted / contact_extract_sorted_p).
// For each block of BN consecutive sorted bergs it scans 2r+1 strips of
// cells [c_lo, c_hi] (grid rows j-r .. j+r of the block's cell span).  A
// candidate is engaged when its key lies in the strip, both sides are
// alive, it is not the berg itself, neither side has fl_k == -1, and
// r^2 <= crit^2 * slack with crit = max(R1 + R2, contact_distance).
// Per berg it writes the engaged count, the min / max engaged sorted slot
// (kept as ints, stored as f32 like the TPU kernel: BIG = 2N when none)
// and the 8 PT feature rows of those two partners, copied by index.
// With group != 0 (the MTS Part-1 collision group) a candidate in the
// berg's own conglomerate (equal PT_GRP row) is never engaged.
//
// Bound: memory and latency, not arithmetic.  A block reads ~3 strips of
// ~(BN / occupancy + 2) cells; at the 1M-berg headline (~3.8 bergs/cell)
// that is ~400 candidate rows of 6 floats per 128 bergs, staged once in
// shared memory and compared by all 128 threads.  On the TPU the window
// was a fixed 128-aligned DMA with a window-overflow flag; here each strip
// is read over its exact extent [cell_starts[c_lo], cell_starts[c_hi+1]),
// in tiles of BN rows, so no read is wasted.  Blocks that the wrapper
// flags bad (span or window overflow, computed as the TPU wrapper does so
// that the fallback set stays the same) are skipped and write the
// "no partner" result; the caller routes their bergs to the exact
// fallback.  Build with -fmad=false: the compare must round rx*rx + ry*ry
// and crit*crit*slack exactly as the reference does, or engagement flips
// at the boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PT feature rows (icebergs_tpu/ops/pallas_prepass.py:258-260)
constexpr int PT_LON = 0, PT_LAT = 1, PT_RAD = 8, PT_ALIVE = 9, PT_KEY = 10,
              PT_GRP = 11, PT_FLK = 12;
constexpr int NFEAT = 8;     // extracted rows per partner (6 eval + 2 spare)
constexpr int EX_F1 = 4, EX_F2 = 12, EX_NOUT = 24;

__global__ void extract_sorted_kernel(const float* __restrict__ PT, int n,
                                      const int32_t* __restrict__ cell_starts,
                                      const int32_t* __restrict__ c_lo,
                                      const int32_t* __restrict__ c_hi,
                                      const uint8_t* __restrict__ bad,
                                      float* __restrict__ out, int nstrips,
                                      int group, float cd, float slack) {
  extern __shared__ float sm[];
  const int bn = blockDim.x;
  float* s_lon = sm;
  float* s_lat = sm + bn;
  float* s_rad = sm + 2 * bn;
  float* s_flk = sm + 3 * bn;
  float* s_alive = sm + 4 * bn;
  float* s_key = sm + 5 * bn;
  float* s_grp = sm + 6 * bn;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long N = n;
  const int gid = b * bn + t;
  const bool own = gid < n;
  float lon1 = 0.f, lat1 = 0.f, R1 = 0.f, fl1 = -1.f, al1 = 0.f, g1 = 0.f;
  if (own) {
    lon1 = PT[PT_LON * N + gid];
    lat1 = PT[PT_LAT * N + gid];
    R1 = PT[PT_RAD * N + gid];
    fl1 = PT[PT_FLK * N + gid];
    al1 = PT[PT_ALIVE * N + gid];
    g1 = PT[PT_GRP * N + gid];
  }
  const int big = 2 * n;
  int cnt = 0, vmin = big, vmax = -1;

  if (!bad[b]) {
    for (int s = 0; s < nstrips; ++s) {
      const int clo = c_lo[b * nstrips + s];
      const int chi = c_hi[b * nstrips + s];
      const float fclo = (float)clo, fchi = (float)chi;
      const int start = cell_starts[clo];
      const int end = cell_starts[chi + 1];
      for (int base = start; base < end; base += bn) {
        const int m = min(bn, end - base);
        __syncthreads();
        if (t < m) {
          const long long r = base + t;
          s_lon[t] = PT[PT_LON * N + r];
          s_lat[t] = PT[PT_LAT * N + r];
          s_rad[t] = PT[PT_RAD * N + r];
          s_flk[t] = PT[PT_FLK * N + r];
          s_alive[t] = PT[PT_ALIVE * N + r];
          s_key[t] = PT[PT_KEY * N + r];
          s_grp[t] = PT[PT_GRP * N + r];
        }
        __syncthreads();
        if (!own || !(al1 > 0.5f) || fl1 == -1.f) continue;
        for (int k = 0; k < m; ++k) {
          const int wid = base + k;
          const float key2 = s_key[k];
          const bool valid = key2 >= fclo && key2 <= fchi &&
                             s_alive[k] > 0.5f && wid != gid &&
                             s_flk[k] != -1.f &&
                             !(group && s_grp[k] == g1);
          const float rx = lon1 - s_lon[k];
          const float ry = lat1 - s_lat[k];
          const float r2 = rx * rx + ry * ry;
          const float crit = fmaxf(R1 + s_rad[k], cd);
          if (valid && r2 > 0.f && r2 <= crit * crit * slack) {
            ++cnt;
            vmin = min(vmin, wid);
            vmax = max(vmax, wid);
          }
        }
      }
    }
  }
  if (!own) return;
  out[0 * N + gid] = (float)cnt;
  out[1 * N + gid] = (float)vmin;
  out[2 * N + gid] = (float)vmax;
  out[3 * N + gid] = 0.f;
  for (int f = 0; f < NFEAT; ++f) {
    out[(EX_F1 + f) * N + gid] = cnt > 0 ? PT[f * N + vmin] : 0.f;
    out[(EX_F2 + f) * N + gid] = cnt > 0 ? PT[f * N + vmax] : 0.f;
  }
  for (int f = EX_F2 + NFEAT; f < EX_NOUT; ++f) out[f * N + gid] = 0.f;
}

}  // namespace

extern "C" int ib_extract_sorted(const void* PT, int n, const void* cell_starts,
                                 const void* c_lo, const void* c_hi,
                                 const void* bad, void* out, int nblocks,
                                 int block_n, int nstrips, int group,
                                 float cd, float slack, void* stream) {
  if (nblocks == 0) return (int)cudaGetLastError();
  const size_t smem = 7 * (size_t)block_n * sizeof(float);
  extract_sorted_kernel<<<nblocks, block_n, smem, (cudaStream_t)stream>>>(
      (const float*)PT, n, (const int32_t*)cell_starts, (const int32_t*)c_lo,
      (const int32_t*)c_hi, (const uint8_t*)bad, (float*)out, nstrips, group,
      cd, slack);
  return (int)cudaGetLastError();
}
