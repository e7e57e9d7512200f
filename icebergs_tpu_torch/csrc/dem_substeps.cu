// K4: the MTS Part-3 substep loop of bonded DEM conglomerates.
//
// Replaces icebergs_tpu/ops/dem_vmem.py::part3_substeps_vmem (the Pallas
// kernel built by _make_kernel).  For the A68/iKID flag set (DEM, explicit
// inner substeps, broken-bond substep contact) every fast substep is closed
// under conglomerates: bond forces (icebergs.F90:957-1242, with stress
// fracture 1140-1199) and broken-bond contact (806-956 via 1789-1792) reach
// partners through bond_idx only, and drift, kick, short-step grounding
// (6868-6893) and the grounding torque (6986-7034) are per element.  With
// the pack_conglomerates_blocked layout no conglomerate straddles a block of
// block_n slots, so the whole n_sub loop runs per block.
//
// Design: one CTA per block, one thread per element.  The element's
// statics, its 15 carried fields and its bonds' 7 fields live in
// registers (or local memory where they spill) across all substeps; device
// memory sees one read and one write of the state per outer step, as the
// TPU kernel's VMEM residency gave.  The TPU kernel reached partners by
// rolling whole blocks through a few static index deltas (no cheap gather in
// VMEM); here each substep writes the six kinematic fields a partner reads
// (lon_old, lat_old, uvel_old, vvel_old, ang_vel, rot) to shared memory,
// synchronises, and each bond slot reads slot (t + delta) mod block_n:
// exactly the TPU roll's partner, and the slot counts only when its delta is
// in the host-verified set (the TPU kernel's has[b]); other slots read zeros.
// Partner statics are read once, before the loop.
//
// Bound: arithmetic.  ~185 operations per bond slot per substep (three
// sqrt, one sin, five divisions) x the bonded slots x 60 substeps per
// element, against ~510 bytes of state read and written once.  The
// arithmetic follows the TPU kernel expression by expression
// (accumulation over slots b = 0..5, IEEE division, sqrtf, sinf) and the
// library is built with -fmad=false, so it matches the plain PyTorch
// version on the card bit for bit.  Masked lanes compute on clamped
// denominators (lsafe, the tmagp guard, 1e-30) and are discarded by
// multiplying by 0 or selecting, as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 8;    // distinct bond index deltas (dem_vmem.MAX_DELTAS)
constexpr int NCAR = 15;   // carried fields (dem_vmem._CAR_FIELDS order)
constexpr int NBF = 6;     // float bond fields: length, tangd1, tangd2,
                           // rel_rotation, nstress, sstress
constexpr long long SENT = -100000000LL;
constexpr int MAX_BLOCK = 512;

enum : int {
  F_CONST_LW = 1, F_HEX = 2, F_BONDS = 4, F_BREAK_SUB = 8,
  F_SHORT_GROUND = 16, F_GROUND_TORQUE = 32, F_ORIG_MOI = 64,
  F_IGNORE_TANG = 128, F_PMAG = 256
};

// carried field order (dem_vmem._CAR_FIELDS)
enum : int {
  C_LON, C_LAT, C_LON_O, C_LAT_O, C_U, C_V, C_U_O, C_V_O, C_AXF, C_AYF,
  C_BXF, C_BYF, C_ANGV, C_ANGA, C_ROT
};

// Every float scalar is the float32 value the JAX kernel's weak-typed
// Python scalar takes (rounded once from double on the host).
struct DemArgs {
  const uint8_t* alive;
  const float* static_berg;
  const float* thick;
  const float* mass;
  const float* od;
  const float* flk;
  const float* length;
  const float* width;
  const int32_t* bond_idx;       // (N, nslots)
  const float* car_in[NCAR];
  float* car_out[NCAR];
  const int32_t* broken_in;      // (N, nslots)
  int32_t* broken_out;
  const float* bond_in[NBF];     // (N, nslots) each
  float* bond_out[NBF];
  int n_sub, nslots, nd, flags;
  int deltas[MAXD];
  float dtf, dtf2, kspring, poisson1, tn, tt, cs, rad_damp, tan_damp,
      dem_damp, K, A0c, R0c, l0c, R0contact, rho, hexdenom, pi, two_sqrt3,
      rho_ratio, h_ground, neg_cdrag, two_thirds;
};

__device__ __forceinline__ float radius_bond(float A, const DemArgs& a) {
  return (a.flags & F_HEX) ? sqrtf(A * a.hexdenom) : 0.5f * sqrtf(A);
}

__device__ __forceinline__ float radius_contact(float A, const DemArgs& a) {
  if (a.flags & F_HEX) return sqrtf(A * a.hexdenom);
  if (a.flags & F_BONDS) return 0.5f * sqrtf(A);
  return sqrtf(A / a.pi);
}

// gdrag_coeff of _make_kernel ('rect' or 'disk' area)
__device__ float gdrag_coeff(float thick, float od, float mass, float length,
                             float width, bool rect, const DemArgs& a) {
  const float D = a.rho_ratio * thick;
  float gf;
  if (a.h_ground > 0.f) {
    gf = fminf(fmaxf(1.0f - (od - D) / a.h_ground, 0.f), 1.f);
  } else {
    gf = D > od ? 1.f : 0.f;
  }
  float MM, A0;
  if (a.flags & F_CONST_LW) {
    MM = a.A0c * thick * a.rho;
    A0 = a.A0c;
  } else {
    MM = mass;
    A0 = length * width;
  }
  float AA;
  if (rect) {
    AA = A0;
  } else {
    float R1;
    if (a.flags & F_HEX) R1 = sqrtf(A0 * a.hexdenom);
    else if (a.flags & F_BONDS) R1 = 0.5f * sqrtf(A0);
    else R1 = sqrtf(A0 / a.pi);
    AA = a.pi * (R1 * R1);
  }
  return gf > 0.f ? a.neg_cdrag * gf * AA / MM : 0.f;
}

// NB: bond slots per element (the state's max_bonds), a compile-time
// constant so the per-slot arrays stay in registers.
template <int NB>
__global__ void __launch_bounds__(MAX_BLOCK)
dem_substeps_kernel(const DemArgs a) {
  extern __shared__ float sm[];
  const int bn = blockDim.x;
  const int t = threadIdx.x;
  float* s_lon = sm;
  float* s_lat = sm + bn;
  float* s_u = sm + 2 * bn;
  float* s_v = sm + 3 * bn;
  float* s_av = sm + 4 * bn;
  float* s_rt = sm + 5 * bn;
  const long long base = (long long)blockIdx.x * bn;
  const long long i = base + t;
  constexpr int B = NB;
  const int fl = a.flags;
  const bool const_lw = fl & F_CONST_LW;

  const bool alive = a.alive[i] != 0;
  const bool mv = alive && a.static_berg[i] < 0.5f;
  const float thick = a.thick[i];
  const float mass = a.mass[i];
  const float flk = a.flk[i];
  const float length = a.length[i];
  const float width = a.width[i];

  // self geometry
  float R1b, M1b, R1c, M1c, A0self, Mself;
  if (const_lw) {
    R1b = a.R0c;
    M1b = a.A0c * thick * a.rho;
    R1c = a.R0contact;
    M1c = a.A0c * thick * a.rho;
    A0self = a.A0c;
    Mself = a.A0c * thick * a.rho;
  } else {
    const float A1 = length * width;
    R1b = radius_bond(A1, a);
    M1b = mass;
    R1c = radius_contact(A1, a);
    M1c = mass;
    A0self = length * width;
    Mself = mass;
  }
  const float R1moi = (fl & F_HEX) ? sqrtf(A0self / a.two_sqrt3)
                                   : 0.5f * sqrtf(A0self);
  const float gdrag_rect =
      (fl & F_SHORT_GROUND)
          ? gdrag_coeff(thick, a.od[i], mass, length, width, true, a)
          : 0.f;
  const float gdrag_disk =
      (fl & F_GROUND_TORQUE)
          ? gdrag_coeff(thick, a.od[i], mass, length, width, false, a)
          : 0.f;

  // per-slot topology and partner statics (constant across substeps)
  int pl[NB];
  bool has[NB], vstat[NB];
  float thick2[NB], R2b[NB], Rminb[NB], TRminb[NB], l0b[NB], R2c[NB],
      M2c[NB], dampb[NB];
  int bbrok[NB];
  float bl[NB], bt1[NB], bt2[NB], brr[NB], bns[NB], bss[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const long long k = i * B + b;
    const int bi = a.bond_idx[k];
    const long long d = bi >= 0 ? (long long)bi - i : SENT;
    bool h = false;
    for (int q = 0; q < a.nd; ++q) h = h || d == (long long)a.deltas[q];
    has[b] = h;
    const int p = h ? (int)(((t + d) % bn + bn) % bn) : t;
    pl[b] = p;
    const long long gp = base + p;
    const float alive2 = h ? (a.alive[gp] ? 1.f : 0.f) : 0.f;
    const float th2 = h ? a.thick[gp] : 0.f;
    const float flk2 = h ? a.flk[gp] : 0.f;
    const float mass2 = h ? a.mass[gp] : 0.f;
    const float len2 = h ? a.length[gp] : 0.f;
    const float wid2 = h ? a.width[gp] : 0.f;
    vstat[b] = h && alive && alive2 > 0.5f && flk != -1.f && flk2 != -1.f;
    thick2[b] = th2;
    float M2b;
    if (const_lw) {
      R2b[b] = a.R0c;
      M2b = a.A0c * th2 * a.rho;
      Rminb[b] = a.R0c;
      TRminb[b] = th2;
      l0b[b] = a.l0c;
      R2c[b] = a.R0contact;
      M2c[b] = a.A0c * th2 * a.rho;
    } else {
      R2b[b] = radius_bond(len2 * wid2, a);
      M2b = mass2;
      const bool fs = R1b < R2b[b];
      Rminb[b] = fs ? R1b : R2b[b];
      TRminb[b] = fs ? thick : th2;
      l0b[b] = R1b + R2b[b];
      R2c[b] = radius_contact(len2 * wid2, a);
      M2c[b] = mass2;
    }
    dampb[b] = a.dem_damp * sqrtf(a.K * M1b * M2b / (M1b + M2b));
    bbrok[b] = a.broken_in[k];
    bl[b] = a.bond_in[0][k];
    bt1[b] = a.bond_in[1][k];
    bt2[b] = a.bond_in[2][k];
    brr[b] = a.bond_in[3][k];
    bns[b] = a.bond_in[4][k];
    bss[b] = a.bond_in[5][k];
  }

  float lon = a.car_in[C_LON][i], lat = a.car_in[C_LAT][i];
  float lon_o = a.car_in[C_LON_O][i], lat_o = a.car_in[C_LAT_O][i];
  float u = a.car_in[C_U][i], v = a.car_in[C_V][i];
  float u_o = a.car_in[C_U_O][i], v_o = a.car_in[C_V_O][i];
  float axf = a.car_in[C_AXF][i], ayf = a.car_in[C_AYF][i];
  float bxf = a.car_in[C_BXF][i], byf = a.car_in[C_BYF][i];
  float angv = a.car_in[C_ANGV][i], anga = a.car_in[C_ANGA][i];
  float rot = a.car_in[C_ROT][i];

  for (int s = 0; s < a.n_sub; ++s) {
    // drift (icebergs.F90:6790-6831)
    const float uvel2 = u + a.dtf2 * (axf + bxf);
    const float vvel2 = v + a.dtf2 * (ayf + byf);
    const float lonn = lon + a.dtf * uvel2;
    const float latn = lat + a.dtf * vvel2;
    if (mv) {
      lon = lonn;
      lat = latn;
      lon_o = lonn;
      lat_o = latn;
      // u_old <- u*; the v component uses bxf (bug-compat, 6826-6827)
      u_o = u + a.dtf2 * (axf + bxf);
      v_o = v + a.dtf2 * (ayf + bxf);
    }
    const float uvel3 = u + a.dtf2 * (axf + bxf);
    const float vvel3 = v + a.dtf2 * (ayf + byf);

    // partner-visible kinematics of this substep
    __syncthreads();
    s_lon[t] = lon_o;
    s_lat[t] = lat_o;
    s_u[t] = u_o;
    s_v[t] = v_o;
    s_av[t] = angv;
    s_rt[t] = rot;
    __syncthreads();

    float F_x = 0.f, F_y = 0.f, T = 0.f, Fd_x = 0.f, Fd_y = 0.f, T_d = 0.f;
    float cIA_x = 0.f, cIA_y = 0.f, cIAd_x = 0.f, cIAd_y = 0.f;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int p = pl[b];
      const float lon2 = has[b] ? s_lon[p] : 0.f;
      const float lat2 = has[b] ? s_lat[p] : 0.f;
      const float uo2 = has[b] ? s_u[p] : 0.f;
      const float vo2 = has[b] ? s_v[p] : 0.f;
      const float av2 = has[b] ? s_av[p] : 0.f;
      const float rt2 = has[b] ? s_rt[p] : 0.f;
      const bool valid = vstat[b] && bbrok[b] != 1;

      // ---- bond (calculate_force_dem) ----
      const float rx = lon_o - lon2;
      const float ry = lat_o - lat2;
      const float blength = sqrtf(rx * rx + ry * ry);
      const float lsafe = blength > 0.f ? blength : 1.f;
      const float n1 = rx / lsafe;
      const float n2 = ry / lsafe;
      const float half_delta = 0.5f * (l0b[b] - blength);
      const float RR1 = R1b - half_delta;
      const float RR2 = R2b[b] - half_delta;
      const float RR1x = RR1 * n1, RR1y = RR1 * n2;
      const float RR2x = RR2 * n1, RR2y = RR2 * n2;
      const float L = 2.0f * (Rminb[b] + (Rminb[b] - half_delta) *
                                             fabsf(R1b - R2b[b]) / lsafe);
      const float dT = fabsf(thick - thick2[b]);
      const float Thick = TRminb[b] + (Rminb[b] - half_delta) * dT / lsafe;
      const float Fn_mag = a.kspring * Thick * 2.f * half_delta * L / l0b[b];
      const float Fn_x = Fn_mag * n1, Fn_y = Fn_mag * n2;
      const float ur = u_o - uo2;
      const float vr = v_o - vo2;

      const float tmag = bt1[b] * bt1[b] + bt2[b] * bt2[b];
      const float tdotn = bt1[b] * n1 + bt2[b] * n2;
      float t1p = bt1[b] - tdotn * n1;
      float t2p = bt2[b] - tdotn * n2;
      const float tmagp = t1p * t1p + t2p * t2p;
      const float t_rat = tmagp > 0.f ? sqrtf(tmag / tmagp) : 0.f;
      t1p = t_rat * t1p;
      t2p = t_rat * t2p;

      const float rotu = RR1y * angv + RR2y * av2;
      const float rotv = -(RR1x * angv + RR2x * av2);
      const float ur2 = ur + rotu;
      const float vr2 = vr + rotv;
      const float upmag = ur2 * n1 + vr2 * n2;
      const float tangd1 = t1p + (ur2 - upmag * n1) * a.dtf;
      const float tangd2 = t2p + (vr2 - upmag * n2) * a.dtf;

      const float ss_factor =
          (fl & F_IGNORE_TANG)
              ? 0.f
              : -L * Thick * a.kspring / (l0b[b] * 2.0f * a.poisson1);
      const float Fs_x = ss_factor * tangd1;
      const float Fs_y = ss_factor * tangd2;
      const float sstress =
          sqrtf(Fs_x * Fs_x + Fs_y * Fs_y) / fmaxf(L * Thick, (float)1e-30);
      const float Ts = -(RR1x * Fs_y - RR1y * Fs_x);
      const float rel_rotation = brr[b] + (angv - av2) * a.dtf;

      float theta, Tr;
      if (!(fl & F_ORIG_MOI)) {
        theta = sinf(rot - rt2);
        Tr = -a.kspring * (L * (L * L)) * Thick * theta / (12.f * l0b[b]);
      } else {
        theta = rot - rt2;
        const float hl = 0.5f * L;
        Tr = -(a.kspring / l0b[b]) * a.two_thirds * (hl * (hl * hl)) * Thick *
             theta;
      }
      const float nstress = (a.kspring / l0b[b]) *
                            (-2.f * half_delta + fabsf(theta * 0.5f * L));
      const float dw = angv - av2;

      int bnew;
      if (fl & F_BREAK_SUB) {
        const bool breaking = valid && (nstress > a.tn || sstress > a.tt);
        bnew = breaking ? 1 : bbrok[b];
        const float w = (valid && !breaking) ? 1.f : 0.f;
        const float wc = (breaking && nstress < 0.f) ? 1.f : 0.f;
        F_x = F_x + w * (Fn_x + Fs_x) + wc * Fn_x;
        F_y = F_y + w * (Fn_y + Fs_y) + wc * Fn_y;
        T = T + w * (Ts + Tr);
        Fd_x = Fd_x + (w + wc) * (-dampb[b] * ur);
        Fd_y = Fd_y + (w + wc) * (-dampb[b] * vr);
        T_d = T_d + w * (-dampb[b] * dw);
      } else {
        bnew = bbrok[b];
        const float w = valid ? 1.f : 0.f;
        F_x = F_x + w * (Fn_x + Fs_x);
        F_y = F_y + w * (Fn_y + Fs_y);
        T = T + w * (Ts + Tr);
        Fd_x = Fd_x + w * (-dampb[b] * ur);
        Fd_y = Fd_y + w * (-dampb[b] * vr);
        T_d = T_d + w * (-dampb[b] * dw);
      }

      // ---- broken-bond contact (806-956 via 1789-1792) ----
      const bool bm = vstat[b] && bbrok[b] == 1;
      const float crit = R1c + R2c[b];
      const bool active = bm && blength > 0.f && blength < crit;
      const float M_min = fminf(M1c, M2c[b]);
      const float accel_spring = a.cs * (M_min / M1c) * (crit - blength);
      const float af = active ? 1.f : 0.f;
      cIA_x = cIA_x + af * accel_spring * rx / lsafe;
      cIA_y = cIA_y + af * accel_spring * ry / lsafe;
      const float rs2 = lsafe * lsafe;
      const float P11 = (rx * rx) / rs2;
      const float P12 = (rx * ry) / rs2;
      const float P22 = (ry * ry) / rs2;
      const float du = uo2 - u;
      const float dv = vo2 - v;
      const float durel = uo2 - u_o;
      const float dvrel = vo2 - v_o;
      float crad = a.rad_damp * (M_min / M1c);
      float ctan = a.tan_damp * (M_min / M1c);
      if (fl & F_PMAG) {
        float q1 = P11 * du + P12 * dv;
        float q2 = P12 * du + P22 * dv;
        crad = crad * sqrtf(q1 * q1 + q2 * q2);
        const float e11 = 1.f - P11, e12 = -P12, e22 = 1.f - P22;
        q1 = e11 * du + e12 * dv;
        q2 = e12 * du + e22 * dv;
        ctan = ctan * sqrtf(q1 * q1 + q2 * q2);
      }
      const float Pd11 = crad * P11 + ctan * (1.f - P11);
      const float Pd12 = crad * P12 + ctan * (-P12);
      const float Pd22 = crad * P22 + ctan * (1.f - P22);
      cIAd_x = cIAd_x + af * (Pd11 * durel + Pd12 * dvrel);
      cIAd_y = cIAd_y + af * (Pd12 * durel + Pd22 * dvrel);

      if (mv) {
        bbrok[b] = bnew;
        if (valid) {
          bl[b] = blength;
          bt1[b] = tangd1;
          bt2[b] = tangd2;
          brr[b] = rel_rotation;
          bns[b] = nstress;
          bss[b] = sstress;
        }
      }
    }

    // ---- assemble accelerations (_substep_forces) and kick ----
    const float IA_x = cIA_x + F_x / Mself;
    const float IA_y = cIA_y + F_y / Mself;
    const float IAd_x = cIAd_x + Fd_x / Mself;
    const float IAd_y = cIAd_y + Fd_y / Mself;
    const float ang_accel = (T + T_d) / (0.5f * Mself * (R1moi * R1moi));
    float axn = IA_x + IAd_x;
    float ayn = IA_y + IAd_y;
    if (fl & F_SHORT_GROUND) {
      axn = axn + u * gdrag_rect;
      ayn = ayn + v * gdrag_rect;
    }
    const float uveln = uvel3 + a.dtf * (0.5f * axn);
    const float vveln = vvel3 + a.dtf * (0.5f * ayn);
    if (mv) {
      axf = axn;
      ayf = ayn;
      bxf = 0.f;
      byf = 0.f;
      u = uveln;
      v = vveln;
      u_o = uveln;
      v_o = vveln;
      anga = ang_accel;
    }
    // angular kick (icebergs.F90:6986-7034)
    const float gdrag = (fl & F_GROUND_TORQUE) ? gdrag_disk : 0.f;
    const float av = (angv + a.dtf * anga) / (1.f - gdrag * a.dtf);
    if (mv) {
      angv = av;
      rot = rot + a.dtf * av;
    }
  }

  a.car_out[C_LON][i] = lon;
  a.car_out[C_LAT][i] = lat;
  a.car_out[C_LON_O][i] = lon_o;
  a.car_out[C_LAT_O][i] = lat_o;
  a.car_out[C_U][i] = u;
  a.car_out[C_V][i] = v;
  a.car_out[C_U_O][i] = u_o;
  a.car_out[C_V_O][i] = v_o;
  a.car_out[C_AXF][i] = axf;
  a.car_out[C_AYF][i] = ayf;
  a.car_out[C_BXF][i] = bxf;
  a.car_out[C_BYF][i] = byf;
  a.car_out[C_ANGV][i] = angv;
  a.car_out[C_ANGA][i] = anga;
  a.car_out[C_ROT][i] = rot;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const long long k = i * B + b;
    a.broken_out[k] = bbrok[b];
    a.bond_out[0][k] = bl[b];
    a.bond_out[1][k] = bt1[b];
    a.bond_out[2][k] = bt2[b];
    a.bond_out[3][k] = brr[b];
    a.bond_out[4][k] = bns[b];
    a.bond_out[5][k] = bss[b];
  }
}

}  // namespace

// sizeof(DemArgs), checked against the ctypes mirror in ops/dem_substeps.py
extern "C" int ib_dem_args_size() { return (int)sizeof(DemArgs); }

// Launch: one CTA of block_n threads per block of the packed slab, for
// max_bonds (nslots) 4, 6 or 8.
extern "C" int ib_dem_substeps(const void* args, int nblocks, int block_n,
                               void* stream) {
  const DemArgs* a = (const DemArgs*)args;
  if (nblocks == 0) return (int)cudaGetLastError();
  if (block_n > MAX_BLOCK || a->nd > MAXD) return (int)cudaErrorInvalidValue;
  const size_t smem = 6 * (size_t)block_n * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  switch (a->nslots) {
    case 4: dem_substeps_kernel<4><<<nblocks, block_n, smem, st>>>(*a); break;
    case 6: dem_substeps_kernel<6><<<nblocks, block_n, smem, st>>>(*a); break;
    case 8: dem_substeps_kernel<8><<<nblocks, block_n, smem, st>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
