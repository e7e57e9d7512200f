// K5: the contact prepass search over the cell-sorted slab.
//
// Replaces icebergs_tpu/ops/pallas_prepass.py::contact_prepass_sorted: K2's
// search without the partner-feature extraction.  For each block of BN
// consecutive sorted bergs it scans 2r+1 strips of cells [c_lo, c_hi]
// (grid rows j-r .. j+r of the block's cell span).  A candidate is engaged
// when its key lies in the strip, both sides are alive, it is not the berg
// itself, neither side has fl_k == -1, (with GROUP) it is in another
// conglomerate, and r^2 <= crit^2 * slack with crit = max(R1 + R2,
// contact_distance).  Per berg it writes the engaged count, the min / max
// engaged sorted slot (-1 when none) and its block's bad flag.
//
// The TPU kernel DMAs a fixed window of W rows per strip, starting at the
// strip's first slot rounded down to 8, and masks by key.  On the sorted
// slab that is the slot range [cell_starts[c_lo], min(cell_starts[c_hi+1],
// 8*(cell_starts[c_lo]/8) + W, N)), which this kernel scans: the same
// candidates, also in blocks flagged bad (whose window is truncated), so
// every output equals the TPU kernel's.  Each CTA builds its own tables
// from the block's first and last key, as the TPU wrapper does
// (pallas_prepass.py:116-131; csrc/block_tables.cuh, shared with K2): the
// strips' cell ranges, the bad flag (a cell span wider than nx - (2r+1),
// or a strip that needs more than W rows of its 8-aligned window) and the
// scan ranges.
//
// Bound: instruction issue, as K2's (csrc/extract_sorted.cu), whose
// levers this kernel takes:
//
// - Each candidate is staged once as a float4 {lon, lat, rad, grp}; one
//   that fails a candidate-only test (key in strip, alive, fl_k != -1) or
//   lies past its strip's scan range is staged with lon = NaN, so the
//   inner loop is one LDS.128 and the distance test.  With lon = NaN, rx
//   and r2 are NaN and `r2 > 0 && r2 <= t` is false.  The berg's own slot
//   stages the berg's own lon and lat, so r2 = 0 fails r2 > 0 (a NaN or
//   inf coordinate gives NaN, which fails too).  A berg that cannot
//   engage (past N, not alive, fl_k == -1) takes lon1 = NaN.
// - Whole strips are staged per __syncthreads: at BN 128 and window 160,
//   three strips of at most 160 candidates fit one round.
// - Chunks of CH candidates far from a warp are skipped by the whole warp
//   by a box test, exact by monotone rounding (argued in full in
//   extract_sorted.cu): the gap between the chunk's and the warp's
//   lon / lat boxes gives gx*gx + gy*gy <= every pair's r2, and
//   cb = max(max|R1| + max|R2|, |cd|) bounds every pair's |crit|, so a
//   chunk with gx*gx + gy*gy > cb*cb*slack holds no engaged pair.  The
//   skip changes neither the count nor the min / max slot.
// - BN 128 / 3 strips / no group (the `fused` paths) is a compile-time
//   instantiation; other shapes take a generic one (BN and strips at run
//   time, GROUP compiled both ways), which a caller may also force onto
//   the compiled shape to time the specialisation.
//
// - On a lat-lon grid (LL) the distance test measures the pair in metres
//   through the metric factors at its mean latitude, one cosf a test
//   (bitwise equality with torch.cos rules out __cosf), and the skips
//   take K2's design (csrc/extract_sorted.cu, csrc/latlon.cuh): the chunk
//   skip bounds the x gap by the smaller of two cosines, one per warp and
//   one per staged chunk (box_cos, kept in shared memory beside the
//   chunk's box; metric_kx), and each candidate of a kept chunk first
//   takes a test with no cosine, each lane's bound of its own pair
//   against its own crit (with GROUP, outside its own conglomerate),
//   skipped by the warp unless some lane may engage it (one vote).  Both
//   drop only pairs that the full test rejects.  Every instantiation
//   exists with LL false (the Cartesian code unchanged) and true.
//
// Build with -fmad=false: r^2 and crit^2 * slack must round as the
// reference rounds them, or engagement flips at the boundary.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_tables.cuh"
#include "latlon.cuh"

namespace {

// packed feature columns (icebergs_tpu/ops/pallas_prepass.py:50)
// lon_old, lat_old, radius, fl_k | alive, key, group, 0
constexpr int MAX_STRIPS = 9;          // radius <= 4
constexpr int CAND_PER_WARP = 256, MAX_CAND = 2048;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int cap_chunks(int bn, int ch) {
  return ((bn / 32) * CAND_PER_WARP < MAX_CAND ? (bn / 32) * CAND_PER_WARP
                                                : MAX_CAND) / ch;
}

// ll: the lat-lon forms, which keep each chunk's cosine
size_t smem_bytes(int bn, int ch, bool ll) {
  const size_t cap = (size_t)cap_chunks(bn, ch);
  return cap * ch * sizeof(float4) +
         cap * (sizeof(float4) + (ll ? 2 : 1) * sizeof(float));
}

template <int W>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// BN_T / NS_T: threads per block and strips, or 0 for run-time values;
// CH: candidates per chunk, the grain of the warp's skip; LL: the lat-lon
// metric (kpr, pi180: csrc/latlon.cuh).
template <int BN_T, int NS_T, bool GROUP, int CH, bool LL>
__global__ void __launch_bounds__(BN_T ? BN_T : 1024)
prepass_sorted_kernel(const float4* __restrict__ P, int n,
                      const int32_t* __restrict__ key_s,
                      const int32_t* __restrict__ cell_starts, int nx,
                      int ncells, int nstrips_rt, int window, float cd,
                      float slack, float kpr, float pi180,
                      int32_t* __restrict__ cnt_out,
                      int32_t* __restrict__ pmin_out,
                      int32_t* __restrict__ pmax_out,
                      uint8_t* __restrict__ bad_out) {
  const int bn = BN_T ? BN_T : (int)blockDim.x;
  const int ns = NS_T ? NS_T : nstrips_rt;
  constexpr int LPC = 32 / CH;                 // chunks a warp stages at once
  const int cap = cap_chunks(bn, CH);
  const int nwarps = bn / 32;
  extern __shared__ float4 sm4[];
  float4* s_cand = sm4;                        // [cap * CH]
  float4* s_box = sm4 + cap * CH;              // [cap] lon min/max, lat min/max
  float* s_rmax = (float*)(s_box + cap);       // [cap] largest |rad|
  float* s_ccos = s_rmax + cap;                // [cap] (LL) box_cos
  __shared__ int s_start[MAX_STRIPS], s_len[MAX_STRIPS];
  __shared__ int s_choff[MAX_STRIPS + 1];
  __shared__ float s_clo[MAX_STRIPS], s_chi[MAX_STRIPS];
  __shared__ int s_win_bad[MAX_STRIPS];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gid = b * bn + t;
  const bool own = gid < n;
  const float qnan = __int_as_float(0x7fc00000);
  float lon1 = qnan, lat1 = 0.f, R1 = 0.f, g1 = 0.f;
  if (own) {
    const float4 a0 = P[2 * (long long)gid];
    const float4 a1 = P[2 * (long long)gid + 1];
    lat1 = a0.y;
    R1 = a0.z;
    g1 = a1.z;
    // a berg that cannot engage takes lon1 = NaN (see the note above)
    if (a1.x > 0.5f && a0.w != -1.f) lon1 = a0.x;
  }

  // the block's tables (pallas_prepass.py:116-131; csrc/block_tables.cuh)
  const BlockSpan sp = block_span(key_s, b, bn, n, ncells);
  if (t < ns) {
    const Strip st = block_strip(sp, t, ns, nx, ncells, cell_starts);
    const int ws8 = (st.start / 8) * 8;
    s_win_bad[t] = st.stop - ws8 > window;
    const int end = min(min(st.stop, ws8 + window), n);
    s_start[t] = st.start;
    s_len[t] = end > st.start ? end - st.start : 0;
    s_clo[t] = (float)st.clo;
    s_chi[t] = (float)st.chi;
  }
  __syncthreads();
  if (t == 0) {
    int acc = 0;
    for (int s = 0; s < ns; ++s) {
      s_choff[s] = acc;
      acc += (s_len[s] + CH - 1) / CH;
    }
    s_choff[ns] = acc;
  }
  bool bad = span_bad(sp, nx, ns);
  for (int s = 0; s < ns; ++s) bad = bad || s_win_bad[s];
  // this warp's box over the lanes that can engage (NaN lon1 ignored)
  const bool can = !isnan(lon1);
  const float wlo_x = group_min<32>(can ? lon1 : INFINITY);
  const float whi_x = group_max<32>(can ? lon1 : -INFINITY);
  const float wlo_y = group_min<32>(can ? lat1 : INFINITY);
  const float whi_y = group_max<32>(can ? lat1 : -INFINITY);
  const float wr = group_max<32>(can ? fabsf(R1) : 0.f);
  const float cos_w = LL ? box_cos(wlo_y, whi_y, pi180) : 0.f;
  const bool warp_can = __any_sync(FULL, can);
  const float acd = fabsf(cd);
  const int big = 2 * n;
  int cnt = 0, vmin = big, vmax = -1;
  __syncthreads();
  const int nch = s_choff[ns];

  for (int ch0 = 0; ch0 < nch; ch0 += cap) {
    const int m = min(cap, nch - ch0);
    // stage: warp w takes chunks LPC*w .. LPC*w + LPC - 1, then the next
    // LPC*nwarps; CH lanes a chunk, one candidate a lane
    for (int q0 = warp * LPC; q0 < m; q0 += nwarps * LPC) {
      const int q = q0 + lane / CH;
      const int ch = ch0 + q;
      int s = 0;
      while (s + 1 < ns && s_choff[s + 1] <= ch) ++s;
      const int k = (ch - s_choff[s]) * CH + lane % CH;
      float4 c = make_float4(qnan, 0.f, 0.f, 0.f);
      bool v = false;
      if (q < m && k < s_len[s]) {
        const long long slot = s_start[s] + k;
        const float4 b0 = P[2 * slot];
        const float4 b1 = P[2 * slot + 1];
        v = b1.y >= s_clo[s] && b1.y <= s_chi[s] && b1.x > 0.5f &&
            b0.w != -1.f;
        c.y = b0.y;
        c.z = b0.z;
        if (GROUP) c.w = b1.z;
        if (v) c.x = b0.x;
      }
      if (q < m) s_cand[q * CH + lane % CH] = c;
      const bool in = v && !isnan(c.x);
      const float lo_x = group_min<CH>(in ? c.x : INFINITY);
      const float hi_x = group_max<CH>(in ? c.x : -INFINITY);
      const float lo_y = group_min<CH>(in ? c.y : INFINITY);
      const float hi_y = group_max<CH>(in ? c.y : -INFINITY);
      const float rm = group_max<CH>(in ? fabsf(c.z) : 0.f);
      const float cc = LL ? box_cos(lo_y, hi_y, pi180) : 0.f;
      if (lane % CH == 0 && q < m) {
        s_box[q] = make_float4(lo_x, hi_x, lo_y, hi_y);
        s_rmax[q] = rm;
        if (LL) s_ccos[q] = cc;
      }
    }
    __syncthreads();
    if (warp_can) {
      for (int q = 0; q < m; ++q) {
        const float4 bx = s_box[q];
        const float gx = fmaxf(fmaxf(bx.x - whi_x, wlo_x - bx.y), 0.f);
        const float gy = fmaxf(fmaxf(bx.z - whi_y, wlo_y - bx.w), 0.f);
        const float cb = fmaxf(wr + s_rmax[q], acd);
        // the metric's x factor bound for every pair of the warp and the
        // chunk (lat-lon only)
        const float kx = LL ? metric_kx(cos_w, s_ccos[q], kpr) : 0.f;
        const float d2 = LL ? gap2_metric(gx, gy, kx, kpr) : gx * gx + gy * gy;
        if (d2 > cb * cb * slack) continue;          // warp-uniform
        const int ch = ch0 + q;
        int s = 0;
        while (s + 1 < ns && s_choff[s + 1] <= ch) ++s;
        const int base = s_start[s] + (ch - s_choff[s]) * CH;
        const float4* cq = s_cand + q * CH;
#pragma unroll 8
        for (int k = 0; k < CH; ++k) {
          const float4 c = cq[k];
          if (LL) {
            // K2's test, written as K2 writes it (csrc/extract_sorted.cu,
            // which argues it).  The same test through a shared inline
            // function ran ~7% slower here and in K2's fused3_ll, and ~5%
            // faster in K2's part1_ll (chip_smoke.py --ab, NVIDIA H100);
            // this form wins by launches a step (8 on 12a / 12b, 2 on 12c)
            const float dx = lon1 - c.x, dy = lat1 - c.y;
            const float gxm = kx > 0.f ? fabsf(dx) * kx : 0.f;
            const float gym = dy * kpr;
            const float critl = fmaxf(R1 + c.z, cd);
            bool may = (dx != 0.f || dy != 0.f) &&
                       gxm * gxm + gym * gym <= critl * critl * slack;
            if (GROUP) may = may && c.w != g1;
            if (!__any_sync(FULL, may)) continue;          // warp-uniform
          }
          float rx, ry;
          pair_sep<LL>(lon1, lat1, c.x, c.y, kpr, pi180, rx, ry);
          const float r2 = rx * rx + ry * ry;
          const float crit = fmaxf(R1 + c.z, cd);
          bool e = r2 > 0.f && r2 <= crit * crit * slack;
          if (GROUP) e = e && c.w != g1;
          if (e) {
            const int wid = base + k;
            ++cnt;
            vmin = min(vmin, wid);
            vmax = max(vmax, wid);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!own) return;
  cnt_out[gid] = cnt;
  pmin_out[gid] = vmin >= big ? -1 : vmin;
  pmax_out[gid] = vmax;
  bad_out[gid] = bad;
}

// instantiations: 0 = BN 128 / 3 strips (the `fused` paths), 1 = generic,
// 2 = generic / GROUP; chunks of 16 candidates without the group filter
// and 32 with it, as K2's instantiations of the same shapes; each
// Cartesian (0-2) and lat-lon (NV + 0-2)
enum { V_FUSED = 0, V_GENERIC = 1, V_GENERIC_GROUP = 2, NV = 3 };
constexpr int CH_OF[NV] = {16, 16, 32};

typedef void (*KernelFn)(const float4*, int, const int32_t*, const int32_t*,
                         int, int, int, int, float, float, float, float,
                         int32_t*, int32_t*, int32_t*, uint8_t*);

template <bool LL>
KernelFn kernel_of_metric(int variant) {
  switch (variant) {
    case V_FUSED: return prepass_sorted_kernel<128, 3, false, 16, LL>;
    case V_GENERIC: return prepass_sorted_kernel<0, 0, false, 16, LL>;
    case V_GENERIC_GROUP: return prepass_sorted_kernel<0, 0, true, 32, LL>;
    default: return nullptr;
  }
}

KernelFn kernel_of(int variant) {
  return variant >= NV ? kernel_of_metric<true>(variant - NV)
                       : kernel_of_metric<false>(variant);
}

// generic != 0 forces the generic instantiation
int variant_of(int block_n, int nstrips, int group, int generic,
               int latlon) {
  const int v = !generic && block_n == 128 && nstrips == 3 && !group
                    ? V_FUSED
                    : group ? V_GENERIC_GROUP : V_GENERIC;
  return v + (latlon ? NV : 0);
}

bool valid_shape(int block_n, int nstrips) {
  return block_n % 32 == 0 && block_n >= 32 && block_n <= 1024 &&
         nstrips >= 1 && nstrips <= MAX_STRIPS && nstrips % 2 == 1;
}

}  // namespace

// P: (n, 8) float rows (16-byte aligned), key_s: (n,) int32 sorted cell
// keys (dead = ncells), cell_starts: (ncells + 1,) int32; outputs (n,)
// int32 cnt / pmin / pmax and (n,) bytes bad.
extern "C" int ib_prepass_sorted(const void* P, int n, const void* key_s,
                                 const void* cell_starts, int nx, int ncells,
                                 int block_n, int nstrips, int window,
                                 int group, int generic, int latlon,
                                 float cd, float slack, float kpr,
                                 float pi180, void* cnt, void* pmin,
                                 void* pmax, void* bad, void* stream) {
  if (!valid_shape(block_n, nstrips) || ncells < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int v = variant_of(block_n, nstrips, group, generic, latlon);
  kernel_of(v)<<<(n + block_n - 1) / block_n, block_n,
                 smem_bytes(block_n, CH_OF[v % NV], v >= NV),
                 (cudaStream_t)stream>>>(
      (const float4*)P, n, (const int32_t*)key_s,
      (const int32_t*)cell_starts, nx, ncells, nstrips, window, cd, slack,
      kpr, pi180, (int32_t*)cnt, (int32_t*)pmin, (int32_t*)pmax,
      (uint8_t*)bad);
  return (int)cudaGetLastError();
}

// The instantiation a launch takes, its dynamic shared memory and its
// resident CTAs per SM at block_n threads.
extern "C" int ib_prepass_config(int block_n, int nstrips, int group,
                                 int generic, int latlon, int* variant,
                                 int* smem, int* ctas_per_sm) {
  if (!valid_shape(block_n, nstrips)) return (int)cudaErrorInvalidValue;
  *variant = variant_of(block_n, nstrips, group, generic, latlon);
  *smem = (int)smem_bytes(block_n, CH_OF[*variant % NV], *variant >= NV);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel_of(*variant), block_n, (size_t)*smem);
}
