// K2: contact search with partner-feature extraction over the cell-sorted slab.
//
// Replaces icebergs_tpu/ops/pallas_prepass.py::contact_extract_sorted_g
// (and its bitwise twins contact_extract_sorted / contact_extract_sorted_p).
// For each block of BN consecutive sorted bergs it scans 2r+1 strips of
// cells [c_lo, c_hi] (grid rows j-r .. j+r of the block's cell span),
// which each CTA builds itself from the block's first and last key.  A
// candidate is engaged when its key lies in the strip, both sides are
// alive, it is not the berg itself, neither side has fl_k == -1, and
// r^2 <= crit^2 * slack with crit = max(R1 + R2, contact_distance).
// Per berg it writes the engaged count, the min / max engaged sorted slot
// (kept as ints, stored as f32 like the TPU kernel: BIG = 2N when none)
// and the 8 PT feature rows of those two partners, copied by index.
// With GROUP (the MTS Part-1 collision group) a candidate in the berg's
// own conglomerate (equal PT_GRP row) is never engaged.
//
// With EPI (contact_extract_sorted_g(epilogue=True)) the kernel also runs
// the velocity-independent pair precompute of the legacy contact group.
// A candidate is staged with its mass in the fourth float (the slot GROUP
// uses; EPI and GROUP are exclusive).  Every engaged pair is also tested
// exactly, r = sqrtf(r2) < crit (the reference's sqrt-based test).  An
// exact pair is engaged: the correctly rounded r < crit means sqrt(r2) <
// crit, so r2 < crit^2, below crit * crit * slack whatever the rounding of
// its two products (slack - 1 = 1e-6 is eight times their error); so the
// chunk skip, which drops only chunks with no engaged pair, drops no exact
// pair.  It adds the
// spring acceleration spring * (min(M1, M2) / M1) * (crit - r) times
// (rx / r, ry / r) to the berg's sums iax, iay in candidate order (a
// fixed order; rows with at most two exact pairs equal any order's
// bits).  The two selected partners' rows become u, v, P11, P12, P22 =
// (rx rx, rx ry, ry ry) / r^2, the mass ratio and the exactness flag.
// The search keeps rx, ry, r, crit and the candidate's mass of the pair
// that sets vmin and of the one that sets vmax in registers, and forms
// the rows from them: the values a reload of the partner's PT rows would
// recompute with the same operations, so the same bits; only u and v are
// loaded by slot.  Rows (EX_IAX = 3, EX_IAY = 20, 7 a partner from EX_F1
// / EX_F2) as the TPU kernel writes them.
//
// Bound: instruction issue.  At the 1M-berg headline a block of 128 bergs
// meets ~400 candidates and every thread tests every one; the data are a
// few KB in shared memory.  So the design cuts instructions per test and
// tests:
//
// - Staging decides what depends on the candidate alone.  Each candidate
//   is staged once as a float4 {lon, lat, rad, grp}; one that fails a
//   candidate-only test (key in strip, alive, fl_k != -1) or lies past its
//   strip's end is staged with lon = NaN.  The inner loop is one LDS.128
//   and the distance test.  Exactness: with lon = NaN, rx and r2 are NaN,
//   so `r2 > 0 && r2 <= t` is false, as the reference's validity mask
//   makes it.  The berg's own slot needs no test either: it stages the
//   berg's own lon and lat bits, so rx = ry = 0 and r2 = 0 fails r2 > 0
//   (a NaN or inf coordinate gives r2 = NaN, which fails too).  A berg
//   that cannot engage (past N, not alive, fl_k == -1) takes lon1 = NaN
//   and so never engages.
// - Whole strips are staged per __syncthreads: all 2r+1 strips of a block,
//   each padded to chunks of CH candidates, up to 256 candidates per warp
//   and 2048 per block in a round.
// - Chunks far from a warp are skipped by the whole warp.  Staging keeps,
//   per chunk, the box of its candidates' lon / lat and the largest
//   |rad|; each warp keeps the box of its bergs' lon / lat and their
//   largest |R1|.  A chunk is skipped when the gap between the boxes
//   gx = max(cmin_lon - wmax_lon, wmin_lon - cmax_lon, 0) (gy likewise)
//   gives gx*gx + gy*gy > cb*cb*slack with cb = max(wmax_R + cmax_R, |cd|).
//   Exactness: float subtraction, multiplication and addition are
//   correctly rounded and so monotone, and x - y rounds to -(y - x); so
//   every pair of a lane and a candidate of the chunk has |rx| >= gx,
//   |ry| >= gy, r2 = rx*rx + ry*ry >= gx*gx + gy*gy, and
//   |crit| <= max(|R1 + R2|, |cd|) <= cb, so crit*crit*slack <=
//   cb*cb*slack < r2: the pair fails the test whatever the radii and
//   whether or not contact_distance sets crit.  fminf / fmaxf ignore the
//   NaN of a staged-out candidate or a lane that cannot engage; a box with
//   no members is (+inf, -inf) and is skipped (none of its pairs can
//   engage); a NaN in the test itself compares false and does not skip.
// - BN 128 / 3 strips (the fast lane and the per-step fused3 path) and
//   BN 256 / 5 strips / GROUP (MTS Part 1) are compile-time
//   instantiations; other shapes take a generic one (BN and strips at run
//   time, GROUP compiled in both ways, with the chunk size of the
//   compiled shape of the same GROUP), which a caller may also force
//   onto the compiled shapes to time the specialisation.
//
// - On a lat-lon grid (LL) the distance test measures the pair in metres
//   through the metric factors at its mean latitude (csrc/latlon.cuh), one
//   cosf per tested pair, and the chunk skip bounds the x gap by the
//   cosine at the largest |latitude| of the two boxes (latlon.cuh).
//   The cosine is the test's cost (bitwise equality with torch.cos rules
//   out __cosf), so each candidate of a kept chunk first takes a test
//   with no cosine: every lane bounds its pair's r2 from its own gaps
//   (|lon1 - lon2| scaled by the chunk's factor, |ry| itself) against its
//   own crit (and, with GROUP, drops its own conglomerate), and the warp
//   skips the candidate unless some lane may engage (one vote).  The
//   chunk skip's argument covers the bound (the two points lie in the two
//   boxes), so it drops only pairs that the full test rejects.  The chunk
//   skip's own factor takes the smaller of two cosines, one per warp and
//   one per staged chunk (box_cos, metric_kx), not one per warp and chunk
//   (12c's grouped search meets ~250 chunks a block, most of them
//   skipped).  Every instantiation exists with LL false, which is the
//   Cartesian code unchanged, and with LL true.
//
// The block tables.  Each CTA builds its strips and its bad flag from the
// block's first and last key and the cell starts (csrc/block_tables.cuh,
// shared with K5), under the TPU wrapper's rule (pallas_prepass.py:663-675;
// ops/extract.py block_tables, which the plain version and the CPU path
// take): c0 = key[b*BN], c1c = min(key of
// the block's last row, ncells - 1) with the tail padded with dead keys
// (ncells); span bad when c1c - c0 > nx - (2r+1); strip s covers
// [clamp(c0 - r + (s-r)*nx, 0, ncells-1), clamp(c1c + r + (s-r)*nx, -1,
// ncells-1)], and is window bad when cs[chi+1] - 128*(cs[clo]/128) > WL,
// the TPU kernel's 128-aligned window (window_lanes on the host).  It
// scans [cs[clo], cs[chi+1]) whole (the gathered window holds all of it
// when the block is good).  A bad block is skipped and writes the "no
// partner" result; every row writes its block's bad byte, and the caller
// routes those bergs to the exact fallback, so the fallback set stays the
// reference's.  Build with -fmad=false: the compare must round rx*rx +
// ry*ry and crit*crit*slack exactly as the reference does, or engagement
// flips at the boundary.  The epilogue writes 24 rows (96 B per berg) and
// reads the two partners' u and v only for engaged bergs, next to the
// berg in the sorted slab.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_tables.cuh"
#include "latlon.cuh"

namespace {

// PT feature rows (icebergs_tpu/ops/pallas_prepass.py:258-260)
constexpr int PT_LON = 0, PT_LAT = 1, PT_U = 2, PT_V = 3, PT_MASS = 5,
              PT_RAD = 8, PT_ALIVE = 9, PT_KEY = 10, PT_GRP = 11, PT_FLK = 12;
constexpr int NFEAT = 8;     // extracted rows per partner (6 eval + 2 spare)
constexpr int EX_F1 = 4, EX_F2 = 12, EX_NOUT = 24;
constexpr int EX_IAX = 3, EX_IAY = 20, EX_EPI_NP = 7;   // epilogue rows
constexpr int MAX_STRIPS = 9;          // radius <= 4
// staged candidates: 256 a warp, at most 2048 a block
constexpr int CAND_PER_WARP = 256, MAX_CAND = 2048;
constexpr unsigned FULL = 0xffffffffu;

// chunks staged per round at bn threads and ch candidates a chunk
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

// min / max over lanes w*W .. w*W + W - 1 (W = 32: the warp; W = 16: each
// half)
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

// The search's registers of one selected partner: rx, ry, r = sqrtf(r2),
// crit and the partner's mass.
struct Partner {
  float rx, ry, r, crit, m2;
};

// One selected partner's epilogue rows (the operations of the TPU
// kernel's per-candidate chain): P11, P12, P22, mass ratio, exactness.
// An engaged partner has r2 > 0, so rsafe = r.
__device__ __forceinline__ void partner_rows(const Partner& p, float M1,
                                             float* d) {
  const float rs2 = p.r * p.r;
  d[0] = (p.rx * p.rx) / rs2;
  d[1] = (p.rx * p.ry) / rs2;
  d[2] = (p.ry * p.ry) / rs2;
  d[3] = fminf(M1, p.m2) / M1;
  d[4] = p.r < p.crit ? 1.f : 0.f;
}

// BN_T / NS_T: threads per block and strips, or 0 for run-time values;
// CH: candidates per chunk (16 or 32), the grain of the warp's skip;
// EPI: the pair epilogue (spring: the contact spring coefficient); LL: the
// lat-lon metric (kpr, pi180: csrc/latlon.cuh).
template <int BN_T, int NS_T, bool GROUP, int CH, bool EPI, bool LL>
__global__ void __launch_bounds__(BN_T ? BN_T : 1024)
extract_sorted_kernel(const float* __restrict__ PT, int n,
                      const int32_t* __restrict__ key_s,
                      const int32_t* __restrict__ cell_starts, int nx,
                      int ncells, int wl, float* __restrict__ out,
                      uint8_t* __restrict__ bad_out, int nstrips_rt,
                      float cd, float slack, float spring, float kpr,
                      float pi180) {
  static_assert(!(GROUP && EPI), "EPI stages the mass where GROUP stages "
                                 "the group");
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
  const long long N = n;
  const int gid = b * bn + t;
  const bool own = gid < n;
  const float qnan = __int_as_float(0x7fc00000);
  float lon1 = qnan, lat1 = 0.f, R1 = 0.f, g1 = 0.f, M1 = 1e-30f;
  float iax = 0.f, iay = 0.f;
  if (own) {
    if (EPI) M1 = fmaxf(PT[PT_MASS * N + gid], 1e-30f);
    const float al1 = PT[PT_ALIVE * N + gid];
    const float fl1 = PT[PT_FLK * N + gid];
    lat1 = PT[PT_LAT * N + gid];
    R1 = PT[PT_RAD * N + gid];
    if (GROUP) g1 = PT[PT_GRP * N + gid];
    // a berg that cannot engage takes lon1 = NaN (see the note above)
    if (al1 > 0.5f && fl1 != -1.f) lon1 = PT[PT_LON * N + gid];
  }
  const int big = 2 * n;
  int cnt = 0, vmin = big, vmax = -1;
  Partner p_min = {}, p_max = {};               // (EPI) see the note above

  // the block's tables (see the note above; csrc/block_tables.cuh)
  const BlockSpan sp = block_span(key_s, b, bn, n, ncells);
  if (t < ns) {
    const Strip st = block_strip(sp, t, ns, nx, ncells, cell_starts);
    s_win_bad[t] = st.stop - (st.start / 128) * 128 > wl;
    s_start[t] = st.start;
    s_len[t] = st.stop > st.start ? st.stop - st.start : 0;
    s_clo[t] = (float)st.clo;
    s_chi[t] = (float)st.chi;
  }
  __syncthreads();
  bool bad = span_bad(sp, nx, ns);
  for (int s = 0; s < ns; ++s) bad = bad || s_win_bad[s];

  if (!bad) {
    if (t == 0) {
      int acc = 0;
      for (int s = 0; s < ns; ++s) {
        s_choff[s] = acc;
        acc += (s_len[s] + CH - 1) / CH;
      }
      s_choff[ns] = acc;
    }
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
    __syncthreads();
    const int nch = s_choff[ns];

    for (int ch0 = 0; ch0 < nch; ch0 += cap) {
      const int m = min(cap, nch - ch0);
      // stage: warp w takes chunks LPC*w .. LPC*w + LPC - 1, then the
      // next LPC*nwarps; CH lanes a chunk, one candidate a lane
      for (int q0 = warp * LPC; q0 < m; q0 += nwarps * LPC) {
        const int q = q0 + lane / CH;
        const int ch = ch0 + q;
        int s = 0;
        while (s + 1 < ns && s_choff[s + 1] <= ch) ++s;
        const int k = (ch - s_choff[s]) * CH + lane % CH;
        const int slot = s_start[s] + k;
        float4 c = make_float4(qnan, 0.f, 0.f, 0.f);
        bool v = false;
        if (q < m && k < s_len[s]) {
          const float key2 = PT[PT_KEY * N + slot];
          const float al2 = PT[PT_ALIVE * N + slot];
          const float fl2 = PT[PT_FLK * N + slot];
          v = key2 >= s_clo[s] && key2 <= s_chi[s] && al2 > 0.5f &&
              fl2 != -1.f;
          c.y = PT[PT_LAT * N + slot];
          c.z = PT[PT_RAD * N + slot];
          if (GROUP) c.w = PT[PT_GRP * N + slot];
          if (EPI) c.w = PT[PT_MASS * N + slot];
          if (v) c.x = PT[PT_LON * N + slot];
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
          // the metric's x factor bound for every pair of the warp and
          // the chunk (lat-lon only)
          const float kx = LL ? metric_kx(cos_w, s_ccos[q], kpr) : 0.f;
          const float d2 = LL ? gap2_metric(gx, gy, kx, kpr)
                              : gx * gx + gy * gy;
          if (d2 > cb * cb * slack) continue;        // warp-uniform
          const int ch = ch0 + q;
          int s = 0;
          while (s + 1 < ns && s_choff[s + 1] <= ch) ++s;
          const int base = s_start[s] + (ch - s_choff[s]) * CH;
          const float4* cq = s_cand + q * CH;
#pragma unroll 8
          for (int k = 0; k < CH; ++k) {
            const float4 c = cq[k];
            if (LL) {
              // the lane's bound of its r2 with the chunk's kx and no
              // cosine (csrc/latlon.cuh); the warp skips the cosine when
              // no lane may engage.  A NaN bound compares false: it comes
              // only from a NaN or opposite infinite coordinates, whose
              // r2 is NaN too, or a NaN crit, which fails the full test.
              // A pair at equal coordinates (the lane's own slot) has dx =
              // dy = 0, so rx = ry = 0 and r2 = 0 fails r2 > 0
              const float dx = lon1 - c.x, dy = lat1 - c.y;
              const float gxm = kx > 0.f ? fabsf(dx) * kx : 0.f;
              const float gym = dy * kpr;
              const float critl = fmaxf(R1 + c.z, cd);
              bool may = (dx != 0.f || dy != 0.f) &&
                         gxm * gxm + gym * gym <= critl * critl * slack;
              if (GROUP) may = may && c.w != g1;
              if (!__any_sync(FULL, may)) continue;        // warp-uniform
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
              if (EPI) {
                const float r = sqrtf(r2);
                if (r < crit) {
                  const float aspr = spring * (fminf(M1, c.w) / M1) *
                                     (crit - r);
                  iax = iax + aspr * (rx / r);
                  iay = iay + aspr * (ry / r);
                }
                if (wid < vmin) p_min = Partner{rx, ry, r, crit, c.w};
                if (wid > vmax) p_max = Partner{rx, ry, r, crit, c.w};
              }
              vmin = min(vmin, wid);
              vmax = max(vmax, wid);
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (!own) return;
  bad_out[gid] = bad;
  out[0 * N + gid] = (float)cnt;
  out[1 * N + gid] = (float)vmin;
  out[2 * N + gid] = (float)vmax;
  if (EPI) {
    // rows: cnt vmin vmax IAX | u v P11 P12 P22 mm ex 0 | (partner 2) |
    // IAY 0 0 0
    out[EX_IAX * N + gid] = iax;
    out[EX_IAY * N + gid] = iay;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int q = p ? vmax : vmin;
      const int base = p ? EX_F2 : EX_F1;
      float d[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      float u = 0.f, v = 0.f;
      if (cnt > 0) {
        partner_rows(p ? p_max : p_min, M1, d);
        u = PT[PT_U * N + q];
        v = PT[PT_V * N + q];
      }
      out[base * N + gid] = u;
      out[(base + 1) * N + gid] = v;
#pragma unroll
      for (int k = 0; k < 5; ++k) out[(base + 2 + k) * N + gid] = d[k];
      out[(base + EX_EPI_NP) * N + gid] = 0.f;
    }
#pragma unroll
    for (int f = EX_IAY + 1; f < EX_NOUT; ++f) out[f * N + gid] = 0.f;
    return;
  }
  out[3 * N + gid] = 0.f;
#pragma unroll
  for (int f = 0; f < NFEAT; ++f) {
    out[(EX_F1 + f) * N + gid] = cnt > 0 ? PT[f * N + vmin] : 0.f;
    out[(EX_F2 + f) * N + gid] = cnt > 0 ? PT[f * N + vmax] : 0.f;
  }
#pragma unroll
  for (int f = EX_F2 + NFEAT; f < EX_NOUT; ++f) out[f * N + gid] = 0.f;
}

// instantiations: 0 = BN 128 / 3 strips (chunks of 16), 1 = BN 256 / 5
// strips / GROUP (chunks of 32), 2 = generic (16), 3 = generic / GROUP
// (32), 4 = BN 128 / 3 strips / EPI (16), 5 = generic / EPI (16); each
// Cartesian (0-5) and lat-lon (NV + 0-5).  Chunks of 16 against 32: 0.153
// against 0.168 ms at BN 128, 0.298 against 0.271 at BN 256 (NVIDIA H100,
// chip_smoke.py --ab).
enum {
  V_FUSED3 = 0, V_PART1 = 1, V_GENERIC = 2, V_GENERIC_GROUP = 3,
  V_FUSED3_EPI = 4, V_GENERIC_EPI = 5, NV = 6
};
constexpr int CH_OF[NV] = {16, 32, 16, 32, 16, 16};

typedef void (*KernelFn)(const float*, int, const int32_t*, const int32_t*,
                         int, int, int, float*, uint8_t*, int, float, float,
                         float, float, float);

template <bool LL>
KernelFn kernel_of_metric(int variant) {
  switch (variant) {
    case V_FUSED3: return extract_sorted_kernel<128, 3, false, 16, false, LL>;
    case V_PART1: return extract_sorted_kernel<256, 5, true, 32, false, LL>;
    case V_GENERIC: return extract_sorted_kernel<0, 0, false, 16, false, LL>;
    case V_GENERIC_GROUP:
      return extract_sorted_kernel<0, 0, true, 32, false, LL>;
    case V_FUSED3_EPI:
      return extract_sorted_kernel<128, 3, false, 16, true, LL>;
    case V_GENERIC_EPI: return extract_sorted_kernel<0, 0, false, 16, true, LL>;
    default: return nullptr;
  }
}

KernelFn kernel_of(int variant) {
  return variant >= NV ? kernel_of_metric<true>(variant - NV)
                       : kernel_of_metric<false>(variant);
}

// generic != 0 forces the generic instantiation; -1: no instantiation
// (the epilogue with the group filter)
int variant_of(int block_n, int nstrips, int group, int generic, int epi,
               int latlon) {
  const bool f3 = !generic && block_n == 128 && nstrips == 3 && !group;
  int v;
  if (epi) {
    v = group ? -1 : f3 ? V_FUSED3_EPI : V_GENERIC_EPI;
  } else if (f3) {
    v = V_FUSED3;
  } else if (!generic && block_n == 256 && nstrips == 5 && group) {
    v = V_PART1;
  } else {
    v = group ? V_GENERIC_GROUP : V_GENERIC;
  }
  return v < 0 ? v : v + (latlon ? NV : 0);
}

bool valid_shape(int block_n, int nstrips) {
  return block_n % 32 == 0 && block_n >= 32 && block_n <= 1024 &&
         nstrips >= 1 && nstrips <= MAX_STRIPS && nstrips % 2 == 1;
}

}  // namespace

// PT: (16, n) float rows, key_s: (n,) int32 sorted cell keys (dead =
// ncells), cell_starts: (ncells + 1,) int32, wl: the TPU kernel's window
// width (window_lanes); outputs (24, n) float rows and (n,) bytes bad.
extern "C" int ib_extract_sorted(const void* PT, int n, const void* key_s,
                                 const void* cell_starts, int nx, int ncells,
                                 int wl, void* out, void* bad, int block_n,
                                 int nstrips, int group, int generic,
                                 int epilogue, int latlon, float cd,
                                 float slack, float spring, float kpr,
                                 float pi180, void* stream) {
  const int v = variant_of(block_n, nstrips, group, generic, epilogue,
                           latlon);
  if (!valid_shape(block_n, nstrips) || ncells < 1 || v < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  kernel_of(v)<<<(n + block_n - 1) / block_n, block_n,
                 smem_bytes(block_n, CH_OF[v % NV], v >= NV),
                 (cudaStream_t)stream>>>(
      (const float*)PT, n, (const int32_t*)key_s,
      (const int32_t*)cell_starts, nx, ncells, wl, (float*)out,
      (uint8_t*)bad, nstrips, cd, slack, spring, kpr, pi180);
  return (int)cudaGetLastError();
}

// The instantiation a launch takes, its dynamic shared memory and its
// resident CTAs per SM at block_n threads.
extern "C" int ib_extract_config(int block_n, int nstrips, int group,
                                 int generic, int epilogue, int latlon,
                                 int* variant, int* smem, int* ctas_per_sm) {
  *variant = variant_of(block_n, nstrips, group, generic, epilogue, latlon);
  if (!valid_shape(block_n, nstrips) || *variant < 0)
    return (int)cudaErrorInvalidValue;
  *smem = (int)smem_bytes(block_n, CH_OF[*variant % NV], *variant >= NV);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel_of(*variant), block_n, (size_t)*smem);
}
