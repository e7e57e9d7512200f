// The lat-lon pair metric shared by the contact searches K2
// (extract_sorted.cu) and K5 (prepass_sorted.cu).
//
// On a lat-lon grid the TPU kernels (icebergs_tpu/ops/pallas_prepass.py,
// contact_prepass_sorted :196-200, contact_extract_sorted_g :746-750)
// measure a pair in metres through the metric factors at the pair's mean
// latitude:
//   lat_ref = 0.5 * (lat1 + lat2)
//   rx = (lon1 - lon2) * (kpr * cos(pi180 * lat_ref))
//   ry = (lat1 - lat2) * kpr
// where kpr is PI_180 * Rearth folded in double and rounded once to float
// (a Python scalar product meeting a float32 array) and pi180 is PI_180
// rounded to float.  Both come from the host.  cosf, not __cosf: torch.cos
// on a CUDA tensor calls the same CUDA math library, so each kernel equals
// its plain PyTorch version bit for bit.
#pragma once

#include <math.h>

// rx, ry of the distance test, Cartesian (LL false) or lat-lon.
template <bool LL>
__device__ __forceinline__ void pair_sep(float lon1, float lat1, float lon2,
                                         float lat2, float kpr, float pi180,
                                         float& rx, float& ry) {
  if (LL) {
    const float lat_ref = 0.5f * (lat1 + lat2);
    rx = (lon1 - lon2) * (kpr * cosf(pi180 * lat_ref));
    ry = (lat1 - lat2) * kpr;
  } else {
    rx = lon1 - lon2;
    ry = lat1 - lat2;
  }
}

// The contact searches' skips bound r2 = rx*rx + ry*ry from below, by
// monotone rounding, over every pair of a berg in the warp's box and a
// candidate in a chunk's box, from their gaps gx (degrees of longitude)
// and gy and a lower bound kx of the metric's x factor.  With L the
// largest |latitude| of both boxes, every pair has |lat_ref| <= L (its
// rounded sum and halving are monotone), so |pi180 * lat_ref| <= pi180 * L
// after rounding and the true cosine at the pair is at least cos(pi180 *
// L) (cos is even and falls on [0, pi]).  cosf is within 2 ulp of the
// true value (CUDA C Programming Guide, the single-precision accuracy
// table), so cosf(pi180 * L) * (1 - 2^-16), clamped at 0, is at most
// every pair's cosf; kpr times it is at most every pair's dx_dlon, and gx
// times that is at most every |rx| (|lon1 - lon2| >= gx).  |ry| >= gy *
// kpr likewise.  The products and the sum round monotonically, so the
// bound is at most r2.  The rounded products pi180 * L keep the order of
// the |latitudes|, so that cosf is the smaller of the two boxes' own
// (box_cos): the searches take one cosf per warp and one per staged
// chunk, not one per warp and chunk, and metric_kx forms kx from the
// two.  An empty box (L = inf) has a NaN cosine: fminf takes the other,
// and the empty chunk's gy = inf gives an infinite bound, which skips it;
// a NaN bound compares false and skips nothing.  (Cartesian: gx*gx +
// gy*gy, argued in csrc/extract_sorted.cu.)
__device__ __forceinline__ float box_cos(float lat_lo, float lat_hi,
                                        float pi180) {
  return cosf(pi180 * fmaxf(fabsf(lat_lo), fabsf(lat_hi)));
}

__device__ __forceinline__ float metric_kx(float cos_w, float cos_c,
                                          float kpr) {
  return kpr * fmaxf(fminf(cos_w, cos_c) * (1.f - 1.f / 65536.f), 0.f);
}

// the bound from the gaps gx (degrees of longitude) and gy with kx from
// metric_kx.  It holds for any sub-box of the two boxes, down to one
// pair's two points (gaps |lon1 - lon2| and |lat1 - lat2|, where gy * kpr
// is |ry| itself), so K2 and K5 bound each lane's pair with a candidate of
// a kept chunk with the chunk's kx and no cosine of its own, and skip the
// candidate when no lane of the warp may engage it (one vote).
__device__ __forceinline__ float gap2_metric(float gx, float gy, float kx,
                                            float kpr) {
  const float gxm = kx > 0.f ? gx * kx : 0.f;
  const float gym = gy * kpr;
  return gxm * gxm + gym * gym;
}
