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
// Design: one CTA per block, one thread per element, all substeps in the
// kernel; device memory sees one read and one write of the state per outer
// step, as the TPU kernel's VMEM residency gave.  The TPU kernel reached
// partners by rolling whole blocks through a few static index deltas; here
// each substep writes the six kinematic fields a partner reads (lon_old,
// lat_old, uvel_old, vvel_old, ang_vel, rot) to shared memory, synchronises,
// and each bond slot reads lane (t + delta) mod block_n: exactly the TPU
// roll's partner, and the slot counts only when its delta is in the
// host-verified set (the TPU kernel's has[b]); other slots read zeros.
//
// Bound: instruction throughput and latency.  ~185 operations per bonded slot
// per substep, of them ~15 IEEE divisions, 3-4 sqrtf and one sinf, each a
// sequence of several instructions, in long dependent chains; the state
// (~510 bytes per element) is read and written once.  A warp issues ~330
// (compiled) to ~450 (generic) SASS instructions on an intact-bond slot's
// fast path; at 4 a clock an SM, that is 38-61% of the kernel's time on an
// H100 (chip_smoke.py's K4 rows), the rest stalls.  Such chains are hidden
// only by many resident warps, so every instantiation is compiled for two
// 512-thread CTAs per SM (64 registers, 32 warps; one CTA with more
// registers ran 1.4x slower):
// - the flag set is a template parameter.  Three sets have their own
//   instantiation at 6 slots: the DEM world's (DEM_FLAGS), the same on a
//   lat-lon grid (LL_FLAGS) and with hexagonal elements (HEX_FLAGS).  In
//   each only its branches exist, the setup's and write-out's slot loops
//   unroll, and under constant_interaction_LW the partner radii, l0 and
//   contact radius are the kernel's scalars, and L is one (see the bond);
//   no spills, 13-18% faster than the generic code on the same inputs
//   (H100).  One generic instantiation reads the flags (and the slot
//   count) at run time for every other set;
// - per-slot state lives in shared memory laid out [slot][thread] (a warp
//   reads 32 consecutive words: no bank conflicts): one packed topology
//   word (partner lane, has, vstat, bond_broken == 1), the carried tangd1,
//   tangd2 and rel_rotation, and the damping coefficient.  The partner's
//   kinematics and statics are per-thread arrays read at the partner lane;
//   the carried fields the slot loop does not read (lon, lat, axn_fast,
//   ayn_fast, bxn_fast, byn_fast, ang_accel) and uvel, vvel wait in
//   shared memory.  Every shared array has MAX_BLOCK entries, so each
//   shared address is a lane plus an immediate offset;
// - bond_length, nstress and sstress are only ever assigned, never read.  A
//   slot is valid on a prefix of the substeps (a broken bond never heals),
//   so their final value is the one of the substep where the bond broke or
//   of the last substep: the kernel writes them to device memory there,
//   and copies the input for a slot that was never valid on a moving
//   element;
// - work that adds nothing is skipped warp by warp (see the slot loop):
//   an empty slot, the bond part of a slot with no intact bond and
//   the contact part of a slot with no broken bond.
//
// On a lat-lon grid (F_LATLON: LL_FLAGS' instantiation, or the generic
// one) the drift moves positions in degrees, lon by
// dt u / (kpr cos(pi180 lat)) (an IEEE division) and lat by dt v inv_kpr,
// and every bond and contact measures rx, ry in metres through the metric
// factors at the pair's mean latitude (dem_vmem.py:240-246, 422-428,
// 474-476); cosf, which torch.cos on a CUDA tensor also calls.
//
// The arithmetic follows the TPU kernel expression by expression
// (accumulation over slots b = 0..nslots-1 with its association, IEEE
// division, sqrtf, sinf, no reciprocals) and the library is built with
// -fmad=false, so it matches the plain PyTorch version on the card bit for
// bit.  Masked lanes compute on clamped denominators (lsafe, the tmagp
// guard, 1e-30) and are discarded by multiplying by 0 or selecting, as the
// TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXD = 8;    // distinct bond index deltas (dem_vmem.MAX_DELTAS)
constexpr int NCAR = 15;   // carried fields (dem_vmem._CAR_FIELDS order)
constexpr int NBF = 6;     // float bond fields: length, tangd1, tangd2,
                           // rel_rotation, nstress, sstress
constexpr int MAX_SLOTS = 8;
constexpr long long SENT = -100000000LL;
constexpr int MAX_BLOCK = 512;

enum : int {
  F_CONST_LW = 1, F_HEX = 2, F_BONDS = 4, F_BREAK_SUB = 8,
  F_SHORT_GROUND = 16, F_GROUND_TORQUE = 32, F_ORIG_MOI = 64,
  F_IGNORE_TANG = 128, F_PMAG = 256, F_LATLON = 512
};
// the flag set of tools/bench_dem_1m.py's configuration, and the same on a
// lat-lon grid and with hexagonal elements
constexpr int DEM_FLAGS = F_CONST_LW | F_BONDS | F_BREAK_SUB | F_PMAG;
constexpr int LL_FLAGS = DEM_FLAGS | F_LATLON;
constexpr int HEX_FLAGS = DEM_FLAGS | F_HEX;
constexpr int GENERIC = -1;   // flags read at run time
enum : int { V_GENERIC = 0, V_DEM = 1, V_DEM_LL = 2, V_DEM_HEX = 3 };

// carried field order (dem_vmem._CAR_FIELDS)
enum : int {
  C_LON, C_LAT, C_LON_O, C_LAT_O, C_U, C_V, C_U_O, C_V_O, C_AXF, C_AYF,
  C_BXF, C_BYF, C_ANGV, C_ANGA, C_ROT
};

// the packed per-slot topology word
constexpr uint32_t LANE = 0x1ffu, HAS = 1u << 9, VSTAT = 1u << 10,
                   BROKEN = 1u << 11;

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
  // the lat-lon metric: PI_180 * Rearth, 1 / (PI_180 * Rearth), PI_180
  float kpr, inv_kpr, pi180;
};

// Shared words per thread: the partner-visible kinematics (6) and
// thickness (1), nine carried fields (lon, lat, uvel, vvel, axn_fast,
// ayn_fast, bxn_fast, byn_fast, ang_accel), the partner mass, length and
// width where constant_interaction_LW may be off (3), and per slot the
// topology word, tangd1, tangd2, rel_rotation and damping (5).
constexpr int KIN = 7, OWN = 9, PART = 3, PER_SLOT = 5;
enum : int { O_LON, O_LAT, O_U, O_V, O_AXF, O_AYF, O_BXF, O_BYF, O_ANGA };

// Every shared array has MAX_BLOCK entries whatever block_n is, so that
// all shared addresses are a thread's or a partner's lane plus an
// immediate offset: no register holds an array's address (with a stride
// of block_n the DEM instantiation spilled).  The price is paid at
// block_n < 512, which reserves as much shared memory as 512 threads:
// 128-thread CTAs run 2 to an SM (8 warps; generic with 8 slots, 1).  The
// DEM path packs one conglomerate per 512-slot block by default.
constexpr int SS = MAX_BLOCK;

template <int FL>
__device__ __forceinline__ bool on(int rt, int f) {
  return FL == GENERIC ? (rt & f) != 0 : (FL & f) != 0;
}

// whether flag set FL may read the partner's mass, length and width
template <int FL>
__host__ __device__ constexpr bool partner_statics() {
  return FL == GENERIC || !(FL & F_CONST_LW);
}

// whether FL's radii are the kernel's scalars, one value for every
// element: R1b == R2b (see the bond's L)
template <int FL>
__host__ __device__ constexpr bool const_radii() {
  return FL != GENERIC && (FL & F_CONST_LW) != 0;
}

template <int FL>
__host__ __device__ constexpr int smem_words(int ns) {
  return KIN + OWN + (partner_statics<FL>() ? PART : 0) + PER_SLOT * ns;
}

__device__ __forceinline__ float radius_bond(float A, bool hex,
                                             float hexdenom) {
  return hex ? sqrtf(A * hexdenom) : 0.5f * sqrtf(A);
}

__device__ __forceinline__ float radius_contact(float A, bool hex,
                                                bool bonds, float hexdenom,
                                                float pi) {
  if (hex) return sqrtf(A * hexdenom);
  if (bonds) return 0.5f * sqrtf(A);
  return sqrtf(A / pi);
}

// gdrag_coeff of _make_kernel ('rect' or 'disk' area)
__device__ float gdrag_coeff(float thick, float od, float mass, float length,
                             float width, bool rect, bool const_lw, bool hex,
                             bool bonds, const DemArgs& a) {
  const float D = a.rho_ratio * thick;
  float gf;
  if (a.h_ground > 0.f) {
    gf = fminf(fmaxf(1.0f - (od - D) / a.h_ground, 0.f), 1.f);
  } else {
    gf = D > od ? 1.f : 0.f;
  }
  float MM, A0;
  if (const_lw) {
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
    const float R1 = radius_contact(A0, hex, bonds, a.hexdenom, a.pi);
    AA = a.pi * (R1 * R1);
  }
  return gf > 0.f ? a.neg_cdrag * gf * AA / MM : 0.f;
}

// NB: bond slots per element (0: a.nslots at run time); FL: the flag set
// (GENERIC: a.flags at run time).
template <int NB, int FL>
__global__ void __launch_bounds__(MAX_BLOCK, 2)
dem_substeps_kernel(const __grid_constant__ DemArgs a) {
  extern __shared__ float sm[];
  const int bn = blockDim.x;
  const int t = threadIdx.x;
  const int ns = NB ? NB : a.nslots;
  const int fl = a.flags;
  const bool const_lw = on<FL>(fl, F_CONST_LW);
  const bool hex = on<FL>(fl, F_HEX);
  const bool bonds = on<FL>(fl, F_BONDS);
  const bool latlon = on<FL>(fl, F_LATLON);
  float* s_lon = sm;
  float* s_lat = sm + SS;
  float* s_u = sm + 2 * SS;
  float* s_v = sm + 3 * SS;
  float* s_av = sm + 4 * SS;
  float* s_rt = sm + 5 * SS;
  float* s_th = sm + 6 * SS;
  float* own = sm + KIN * SS + t;            // own[O_* * SS]
  float* s_ms = sm + (KIN + OWN) * SS;       // partner_statics<FL> only
  float* s_ln = s_ms + SS;
  float* s_wd = s_ms + 2 * SS;
  float* slots = sm + (KIN + OWN + (partner_statics<FL>() ? PART : 0)) * SS;
  uint32_t* s_code = reinterpret_cast<uint32_t*>(slots);
  float* s_t1 = slots + ns * SS;             // [slot][thread] each
  float* s_t2 = slots + 2 * ns * SS;
  float* s_rr = slots + 3 * ns * SS;
  float* s_dp = slots + 4 * ns * SS;
  const long long base = (long long)blockIdx.x * bn;
  const long long i = base + t;

  const bool alive = a.alive[i] != 0;
  const bool mv = alive && a.static_berg[i] < 0.5f;
  const float thick = a.thick[i];
  const float flk = a.flk[i];
  const float mass = const_lw ? 0.f : a.mass[i];
  const float length = const_lw ? 0.f : a.length[i];
  const float width = const_lw ? 0.f : a.width[i];

  // self geometry (bond, contact and moment-of-inertia radii; the bond,
  // contact and self masses are one value under both branches)
  float R1b, M1b, R1c, A0self;
  if (const_lw) {
    R1b = a.R0c;
    M1b = a.A0c * thick * a.rho;
    R1c = a.R0contact;
    A0self = a.A0c;
  } else {
    const float A1 = length * width;
    R1b = radius_bond(A1, hex, a.hexdenom);
    M1b = mass;
    R1c = radius_contact(A1, hex, bonds, a.hexdenom, a.pi);
    A0self = length * width;
  }
  const float Mself = M1b;
  const float R1moi = hex ? sqrtf(A0self / a.two_sqrt3) : 0.5f * sqrtf(A0self);
  float gdrag_rect = 0.f, gdrag_disk = 0.f;
  if (on<FL>(fl, F_SHORT_GROUND))
    gdrag_rect = gdrag_coeff(thick, a.od[i], mass, length, width, true,
                             const_lw, hex, bonds, a);
  if (on<FL>(fl, F_GROUND_TORQUE))
    gdrag_disk = gdrag_coeff(thick, a.od[i], mass, length, width, false,
                             const_lw, hex, bonds, a);

  // per-slot topology and partner statics (constant across substeps); the
  // partner's alive and fl_k ride the kinematic arrays until the loop
  s_th[t] = thick;
  if (partner_statics<FL>()) {
    s_ms[t] = mass;
    s_ln[t] = length;
    s_wd[t] = width;
  }
  s_lon[t] = alive ? 1.f : 0.f;
  s_lat[t] = flk;
  __syncthreads();
  const bool pow2 = (bn & (bn - 1)) == 0;
#pragma unroll
  for (int b = 0; b < ns; ++b) {
    const long long k = i * ns + b;
    const int bi = a.bond_idx[k];
    const long long d = bi >= 0 ? (long long)bi - i : SENT;
    bool h = false;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) h = h || (q < a.nd && d == a.deltas[q]);
    // analyze_bond_deltas keeps |delta| < block_n
    const int di = h ? (int)d : 0;
    const int p = !h    ? t
                  : pow2 ? (t + di) & (bn - 1)
                         : ((t + di) % bn + bn) % bn;
    const float alive2 = h ? s_lon[p] : 0.f;
    const float flk2 = h ? s_lat[p] : 0.f;
    const float th2 = h ? s_th[p] : 0.f;
    const bool vst = h && alive && alive2 > 0.5f && flk != -1.f &&
                     flk2 != -1.f;
    const float M2b = const_lw ? a.A0c * th2 * a.rho : (h ? s_ms[p] : 0.f);
    const int o = b * SS + t;
    s_dp[o] = a.dem_damp * sqrtf(a.K * M1b * M2b / (M1b + M2b));
    s_code[o] = (uint32_t)p | (h ? HAS : 0u) | (vst ? VSTAT : 0u) |
                (a.broken_in[k] == 1 ? BROKEN : 0u);
    s_t1[o] = a.bond_in[1][k];
    s_t2[o] = a.bond_in[2][k];
    s_rr[o] = a.bond_in[3][k];
  }

  own[O_LON * SS] = a.car_in[C_LON][i];
  own[O_LAT * SS] = a.car_in[C_LAT][i];
  own[O_U * SS] = a.car_in[C_U][i];
  own[O_V * SS] = a.car_in[C_V][i];
  own[O_AXF * SS] = a.car_in[C_AXF][i];
  own[O_AYF * SS] = a.car_in[C_AYF][i];
  own[O_BXF * SS] = a.car_in[C_BXF][i];
  own[O_BYF * SS] = a.car_in[C_BYF][i];
  own[O_ANGA * SS] = a.car_in[C_ANGA][i];
  float lon_o = a.car_in[C_LON_O][i], lat_o = a.car_in[C_LAT_O][i];
  float u_o = a.car_in[C_U_O][i], v_o = a.car_in[C_V_O][i];
  float angv = a.car_in[C_ANGV][i];
  float rot = a.car_in[C_ROT][i];

  for (int s = 0; s < a.n_sub; ++s) {
    const bool last = s == a.n_sub - 1;
    // drift (icebergs.F90:6790-6831)
    {
      const float u = own[O_U * SS], v = own[O_V * SS];
      const float axf = own[O_AXF * SS], ayf = own[O_AYF * SS];
      const float bxf = own[O_BXF * SS], byf = own[O_BYF * SS];
      const float uvel2 = u + a.dtf2 * (axf + bxf);
      const float vvel2 = v + a.dtf2 * (ayf + byf);
      float lonn, latn;
      if (latlon) {
        const float lat = own[O_LAT * SS];
        const float dxdl = 1.f / (a.kpr * cosf(a.pi180 * lat));
        lonn = own[O_LON * SS] + a.dtf * uvel2 * dxdl;
        latn = lat + a.dtf * vvel2 * a.inv_kpr;
      } else {
        lonn = own[O_LON * SS] + a.dtf * uvel2;
        latn = own[O_LAT * SS] + a.dtf * vvel2;
      }
      if (mv) {
        own[O_LON * SS] = lonn;
        own[O_LAT * SS] = latn;
        lon_o = lonn;
        lat_o = latn;
        // u_old <- u*; the v component uses bxf (bug-compat, 6826-6827)
        u_o = u + a.dtf2 * (axf + bxf);
        v_o = v + a.dtf2 * (ayf + bxf);
      }
    }

    // partner-visible kinematics of this substep (the first barrier also
    // ends the setup's reads of alive and fl_k)
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
    // The slot loop stays rolled in every instantiation: unrolled at 6
    // slots its body (~480 instructions a slot) overflows the instruction
    // cache, and the compiled forms ran 4-13% slower.
#pragma unroll 1
    for (int b = 0; b < ns; ++b) {
      const int o = b * SS + t;
      const uint32_t c = s_code[o];
      const bool h = (c & HAS) != 0;
      // Work that adds nothing is skipped warp by warp, and exactly: a
      // slot no lane of the warp has (has = false makes vstat false), the
      // bond part of a slot no lane holds intact (valid false: w = wc = 0,
      // no breaking, no bond state written) and the contact part of a
      // slot no lane holds broken (bm false: af = 0).  Each would add
      // 0 x (a finite value, for a finite state: an empty slot reads
      // zeros and every denominator is clamped) = +-0 to its sums.  The
      // sums start at +0.f and a float sum is -0 only when both terms
      // are, so no sum is ever -0 and adding +-0 leaves it unchanged.
      // Results of non-moving lanes are discarded.
      if (!__any_sync(0xffffffffu, h)) continue;
      const int p = (int)(c & LANE);
      const bool vst = (c & VSTAT) != 0;
      const bool brk = (c & BROKEN) != 0;     // bond_broken == 1
      const bool valid = vst && !brk;
      const bool bm = vst && brk;
      const float lon2 = h ? s_lon[p] : 0.f;
      const float lat2 = h ? s_lat[p] : 0.f;
      const float uo2 = h ? s_u[p] : 0.f;
      const float vo2 = h ? s_v[p] : 0.f;
      const float th2 = h ? s_th[p] : 0.f;

      // partner geometry
      float R2b, Rminb, TRminb, l0b, R2c, M2c;
      if (const_lw) {
        R2b = a.R0c;
        Rminb = a.R0c;
        TRminb = th2;
        l0b = a.l0c;
        R2c = a.R0contact;
        M2c = a.A0c * th2 * a.rho;
      } else {
        const float len2 = h ? s_ln[p] : 0.f;
        const float wid2 = h ? s_wd[p] : 0.f;
        R2b = radius_bond(len2 * wid2, hex, a.hexdenom);
        const bool fs = R1b < R2b;
        Rminb = fs ? R1b : R2b;
        TRminb = fs ? thick : th2;
        l0b = R1b + R2b;
        R2c = radius_contact(len2 * wid2, hex, bonds, a.hexdenom, a.pi);
        M2c = h ? s_ms[p] : 0.f;
      }
      float rx, ry;
      if (latlon) {
        const float lat_ref = 0.5f * (lat_o + lat2);
        rx = (lon_o - lon2) * (a.kpr * cosf(a.pi180 * lat_ref));
        ry = (lat_o - lat2) * a.kpr;
      } else {
        rx = lon_o - lon2;
        ry = lat_o - lat2;
      }
      const float blength = sqrtf(rx * rx + ry * ry);
      const float lsafe = blength > 0.f ? blength : 1.f;

      // ---- bond (calculate_force_dem) ----
      if (__any_sync(0xffffffffu, valid)) {
        const float av2 = h ? s_av[p] : 0.f;
        const float rt2 = h ? s_rt[p] : 0.f;
        const float dampb = s_dp[o];
        const float bt1 = s_t1[o], bt2 = s_t2[o];
        const float n1 = rx / lsafe;
        const float n2 = ry / lsafe;
        const float half_delta = 0.5f * (l0b - blength);
        const float RR1 = R1b - half_delta;
        const float RR2 = const_radii<FL>() ? RR1 : R2b - half_delta;
        const float RR1x = RR1 * n1, RR1y = RR1 * n2;
        const float RR2x = RR2 * n1, RR2y = RR2 * n2;
        // With const_radii R1b and R2b are one finite scalar R0c >= 0, so
        // fabsf(R1b - R2b) is +0.  For a finite blength (a finite state:
        // |rx|, |ry| below 1.8e19 m; a masked lane reads zeros, so its
        // rx, ry are its own finite position) Rminb - half_delta is
        // finite, its product with +0 is +-0, so is that over lsafe >= 1e-45,
        // and Rminb + +-0 is Rminb (for Rminb = +0 too: +0 + -0 = +0).  So
        // L is 2 Rminb bit for bit: one IEEE division and three operations
        // less a slot, and L, L^3 are scalars.  A non-finite blength would
        // give the plain version's NaN instead.
        const float L = const_radii<FL>()
                            ? 2.0f * Rminb
                            : 2.0f * (Rminb + (Rminb - half_delta) *
                                                  fabsf(R1b - R2b) / lsafe);
        const float dT = fabsf(thick - th2);
        const float Thick = TRminb + (Rminb - half_delta) * dT / lsafe;
        const float Fn_mag = a.kspring * Thick * 2.f * half_delta * L / l0b;
        const float Fn_x = Fn_mag * n1, Fn_y = Fn_mag * n2;
        const float ur = u_o - uo2;
        const float vr = v_o - vo2;

        const float tmag = bt1 * bt1 + bt2 * bt2;
        const float tdotn = bt1 * n1 + bt2 * n2;
        float t1p = bt1 - tdotn * n1;
        float t2p = bt2 - tdotn * n2;
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
            on<FL>(fl, F_IGNORE_TANG)
                ? 0.f
                : -L * Thick * a.kspring / (l0b * 2.0f * a.poisson1);
        const float Fs_x = ss_factor * tangd1;
        const float Fs_y = ss_factor * tangd2;
        const float sstress =
            sqrtf(Fs_x * Fs_x + Fs_y * Fs_y) / fmaxf(L * Thick, (float)1e-30);
        const float Ts = -(RR1x * Fs_y - RR1y * Fs_x);
        const float rel_rotation = s_rr[o] + (angv - av2) * a.dtf;

        float theta, Tr;
        if (!on<FL>(fl, F_ORIG_MOI)) {
          theta = sinf(rot - rt2);
          Tr = -a.kspring * (L * (L * L)) * Thick * theta / (12.f * l0b);
        } else {
          theta = rot - rt2;
          const float hl = 0.5f * L;
          Tr = -(a.kspring / l0b) * a.two_thirds * (hl * (hl * hl)) * Thick *
               theta;
        }
        const float nstress = (a.kspring / l0b) *
                              (-2.f * half_delta + fabsf(theta * 0.5f * L));
        const float dw = angv - av2;

        bool breaking = false;
        if (on<FL>(fl, F_BREAK_SUB)) {
          breaking = valid && (nstress > a.tn || sstress > a.tt);
          const float w = (valid && !breaking) ? 1.f : 0.f;
          const float wc = (breaking && nstress < 0.f) ? 1.f : 0.f;
          F_x = F_x + w * (Fn_x + Fs_x) + wc * Fn_x;
          F_y = F_y + w * (Fn_y + Fs_y) + wc * Fn_y;
          T = T + w * (Ts + Tr);
          Fd_x = Fd_x + (w + wc) * (-dampb * ur);
          Fd_y = Fd_y + (w + wc) * (-dampb * vr);
          T_d = T_d + w * (-dampb * dw);
        } else {
          const float w = valid ? 1.f : 0.f;
          F_x = F_x + w * (Fn_x + Fs_x);
          F_y = F_y + w * (Fn_y + Fs_y);
          T = T + w * (Ts + Tr);
          Fd_x = Fd_x + w * (-dampb * ur);
          Fd_y = Fd_y + w * (-dampb * vr);
          T_d = T_d + w * (-dampb * dw);
        }

        if (mv) {
          if (breaking) s_code[o] = c | BROKEN;
          if (valid) {
            s_t1[o] = tangd1;
            s_t2[o] = tangd2;
            s_rr[o] = rel_rotation;
            if (breaking || last) {      // the slot's last valid substep
              const long long k = i * ns + b;
              a.bond_out[0][k] = blength;
              a.bond_out[4][k] = nstress;
              a.bond_out[5][k] = sstress;
            }
          }
        }
      }

      // ---- broken-bond contact (806-956 via 1789-1792) ----
      if (__any_sync(0xffffffffu, bm)) {
        const float crit = R1c + R2c;
        const bool active = bm && blength > 0.f && blength < crit;
        const float M_min = fminf(M1b, M2c);
        const float accel_spring = a.cs * (M_min / M1b) * (crit - blength);
        const float af = active ? 1.f : 0.f;
        cIA_x = cIA_x + af * accel_spring * rx / lsafe;
        cIA_y = cIA_y + af * accel_spring * ry / lsafe;
        const float rs2 = lsafe * lsafe;
        const float P11 = (rx * rx) / rs2;
        const float P12 = (rx * ry) / rs2;
        const float P22 = (ry * ry) / rs2;
        const float durel = uo2 - u_o;
        const float dvrel = vo2 - v_o;
        float crad = a.rad_damp * (M_min / M1b);
        float ctan = a.tan_damp * (M_min / M1b);
        if (on<FL>(fl, F_PMAG)) {
          const float du = uo2 - own[O_U * SS];
          const float dv = vo2 - own[O_V * SS];
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
      }
    }

    // ---- assemble accelerations (_substep_forces) and kick ----
    const float u = own[O_U * SS], v = own[O_V * SS];
    const float uvel3 = u + a.dtf2 * (own[O_AXF * SS] + own[O_BXF * SS]);
    const float vvel3 = v + a.dtf2 * (own[O_AYF * SS] + own[O_BYF * SS]);
    const float IA_x = cIA_x + F_x / Mself;
    const float IA_y = cIA_y + F_y / Mself;
    const float IAd_x = cIAd_x + Fd_x / Mself;
    const float IAd_y = cIAd_y + Fd_y / Mself;
    const float ang_accel = (T + T_d) / (0.5f * Mself * (R1moi * R1moi));
    float axn = IA_x + IAd_x;
    float ayn = IA_y + IAd_y;
    if (on<FL>(fl, F_SHORT_GROUND)) {
      axn = axn + u * gdrag_rect;
      ayn = ayn + v * gdrag_rect;
    }
    const float uveln = uvel3 + a.dtf * (0.5f * axn);
    const float vveln = vvel3 + a.dtf * (0.5f * ayn);
    if (mv) {
      own[O_AXF * SS] = axn;
      own[O_AYF * SS] = ayn;
      own[O_BXF * SS] = 0.f;
      own[O_BYF * SS] = 0.f;
      own[O_U * SS] = uveln;
      own[O_V * SS] = vveln;
      u_o = uveln;
      v_o = vveln;
      own[O_ANGA * SS] = ang_accel;
    }
    // angular kick (icebergs.F90:6986-7034)
    float av = angv + a.dtf * own[O_ANGA * SS];
    if (on<FL>(fl, F_GROUND_TORQUE)) av = av / (1.f - gdrag_disk * a.dtf);
    if (mv) {
      angv = av;
      rot = rot + a.dtf * av;
    }
  }

  a.car_out[C_LON][i] = own[O_LON * SS];
  a.car_out[C_LAT][i] = own[O_LAT * SS];
  a.car_out[C_LON_O][i] = lon_o;
  a.car_out[C_LAT_O][i] = lat_o;
  a.car_out[C_U][i] = own[O_U * SS];
  a.car_out[C_V][i] = own[O_V * SS];
  a.car_out[C_U_O][i] = u_o;
  a.car_out[C_V_O][i] = v_o;
  a.car_out[C_AXF][i] = own[O_AXF * SS];
  a.car_out[C_AYF][i] = own[O_AYF * SS];
  a.car_out[C_BXF][i] = own[O_BXF * SS];
  a.car_out[C_BYF][i] = own[O_BYF * SS];
  a.car_out[C_ANGV][i] = angv;
  a.car_out[C_ANGA][i] = own[O_ANGA * SS];
  a.car_out[C_ROT][i] = rot;
#pragma unroll
  for (int b = 0; b < ns; ++b) {
    const long long k = i * ns + b;
    const int o = b * SS + t;
    const uint32_t c = s_code[o];
    const int bin = a.broken_in[k];
    a.broken_out[k] = (c & BROKEN) ? 1 : bin;
    a.bond_out[1][k] = s_t1[o];
    a.bond_out[2][k] = s_t2[o];
    a.bond_out[3][k] = s_rr[o];
    // a slot valid at the first substep of a moving element was written in
    // the loop; every other slot keeps its input
    if (!(mv && (c & VSTAT) && bin != 1 && a.n_sub > 0)) {
      a.bond_out[0][k] = a.bond_in[0][k];
      a.bond_out[4][k] = a.bond_in[4][k];
      a.bond_out[5][k] = a.bond_in[5][k];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The dynamic shared memory of a launch with nslots slots.  The first call
// on each device also lets the instantiation take shared memory for its
// largest slot count; the attributes hold for the life of the context.
template <int NB, int FL>
cudaError_t prepare(int nslots, size_t* smem) {
  *smem = (size_t)smem_words<FL>(NB ? NB : nslots) * SS *
          sizeof(float);
  static bool ready[MAX_DEVICES] = {};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && ready[dev])) return e;
  const int most = smem_words<FL>(NB ? NB : MAX_SLOTS) * SS *
                   (int)sizeof(float);
  e = cudaFuncSetAttribute(dem_substeps_kernel<NB, FL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dem_substeps_kernel<NB, FL>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
  return e;
}

// One instantiation's launch (nblocks > 0) or, with ctas non-null, its
// dynamic shared memory and resident CTAs per SM at block_n threads.
template <int NB, int FL>
int run(const DemArgs* a, int nslots, int nblocks, int block_n,
        cudaStream_t st, int* smem_bytes, int* ctas) {
  size_t smem;
  cudaError_t e = prepare<NB, FL>(nslots, &smem);
  if (ctas) {
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas, dem_substeps_kernel<NB, FL>, block_n, smem);
    *smem_bytes = (int)smem;
    return (int)e;
  }
  if (e != cudaSuccess) return (int)e;
  dem_substeps_kernel<NB, FL><<<nblocks, block_n, smem, st>>>(*a);
  return (int)cudaGetLastError();
}

// A variant's instantiation: the compiled ones take exactly their flag set
// and 6 slots (flags < 0: not checked), the generic one any.
int dispatch(int variant, int flags, const DemArgs* a, int nslots,
             int nblocks, int block_n, cudaStream_t st, int* smem_bytes,
             int* ctas) {
  static const int compiled[] = {0, DEM_FLAGS, LL_FLAGS, HEX_FLAGS};
  if (variant == V_GENERIC)
    return run<0, GENERIC>(a, nslots, nblocks, block_n, st, smem_bytes,
                           ctas);
  if (variant < V_DEM || variant > V_DEM_HEX || nslots != 6 ||
      (flags >= 0 && flags != compiled[variant]))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case V_DEM:
      return run<6, DEM_FLAGS>(a, 6, nblocks, block_n, st, smem_bytes, ctas);
    case V_DEM_LL:
      return run<6, LL_FLAGS>(a, 6, nblocks, block_n, st, smem_bytes, ctas);
    default:
      return run<6, HEX_FLAGS>(a, 6, nblocks, block_n, st, smem_bytes, ctas);
  }
}

}  // namespace

// sizeof(DemArgs), checked against the ctypes mirror in ops/dem_substeps.py
extern "C" int ib_dem_args_size() { return (int)sizeof(DemArgs); }

// Launch: one CTA of block_n threads per block of the packed slab.
// Variants V_DEM, V_DEM_LL and V_DEM_HEX take their flag set with 6 slots
// and refuse any other; V_GENERIC takes any flag set with 1..8 slots.
extern "C" int ib_dem_substeps(const void* args, int nblocks, int block_n,
                               int variant, void* stream) {
  const DemArgs* a = (const DemArgs*)args;
  if (nblocks == 0) return (int)cudaGetLastError();
  if (block_n > MAX_BLOCK || a->nd > MAXD || a->nslots < 1 ||
      a->nslots > MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  return dispatch(variant, a->flags, a, a->nslots, nblocks, block_n,
                  (cudaStream_t)stream, nullptr, nullptr);
}

// A variant's dynamic shared memory (bytes) and resident CTAs per SM at
// block_n threads.
extern "C" int ib_dem_config(int variant, int nslots, int block_n,
                             int* smem_bytes, int* ctas_per_sm) {
  return dispatch(variant, -1, nullptr, nslots, 0, block_n, nullptr,
                  smem_bytes, ctas_per_sm);
}
