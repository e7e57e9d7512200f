// K3: per-cell segment sums of the reproducible spreading pass.
//
// Replaces icebergs_tpu/ops/pallas_spread.py::segment_spread_sums (and its
// bitwise twins segment_spread_sums_p / segment_spread_sums_g) together
// with the overflow switch around it (icebergs_tpu/ops/spread.py
// _pallas_spread_sums).  Input is the cell-sorted payload (12 + n_extra
// rows after the sort key, read through a table of row addresses) and
// cell_starts; for each cell it builds every row's 9 rectangle spreading
// weights (pallas_spread._weights_from_rows, icebergs.F90:3960-4001), the
// 36 weight x value products, the 7 per-cell diagnostic columns and the
// n_extra pass-through columns, and sums them over the cell's rows.
//
// Association.  The TPU kernel sums with a 0/1 selection matmul whose
// contraction runs in row order: each cell's rows in (cell, id) order.
// When any 128-cell block's rows overflow that kernel's window, the JAX
// package recomputes the whole call with the slot scatter
// (spread.py:274-300): rank k < K-1 of a cell in slot k, ranks >= K-1 added
// into slot K-1 in row order, then a fixed pairwise tree over the K slots
// (zero-padded at odd levels).  spread_window_flags computes the window
// flags and their count on the device; the sum kernel reads the count and
// takes the tree for every cell when it is > 0, the sequential sum
// otherwise, so the switch costs no host sync.  The tree is evaluated as a
// binary counter over the slots: pushing slot k merges it with the pending
// left siblings at the levels where k has a 1 bit, which is the tree's own
// left + right order.  Slots past the cell's rows are +0 and are not added:
// no partial sum here is -0 (0 + x is never -0, and a sum of two values is
// -0 only if both are), so x + 0 == x and the result is bitwise the
// padded tree's.
//
// Bound: memory.  Every payload row is read once (12 + n_extra floats; the
// key is not needed, the cell comes from cell_starts), 10 table rows of
// the CTA's cells, and every cell writes 43 + n_extra sums once.  The
// design:
//
// - One CTA per CB = 32 consecutive cells; their rows are the contiguous
//   range [cs[c0], cs[c0 + CB]), read coalesced.
// - Row-parallel products: each thread computes one row's weights (with
//   the new spreading a sqrt and four divisions) once and stages 20 +
//   n_extra values in shared memory (the 9 weights, the 4 values, the 7
//   cell columns, the extras; a row's 36 products are formed from them
//   when summed).  A CTA stages 256 rows a round, so a dense block
//   streams through in chunks.
// - Sums per (cell, column): thread t owns pairs p = t + i * 256 of the
//   CTA's (cell, column) grid, column fastest, and adds its cell's staged
//   rows in row order into a register; a cell spanning chunks carries its
//   partial sums across them.  Pair p is also the offset of its sum in S
//   from the CTA's first cell, so the stores are coalesced.
// - n_extra = 3 (the persistent lanes) and 14 (the per-step and DEM
//   paths) are compile-time instantiations; other widths take a generic
//   one.
// - The other slot-sum methods' sums of given columns (K3's
//   pass-through) are a kernel of their own, csrc/segment_sums.cu.
//
// It runs at ~3x its bound at the headline (PERF.md).  No profiler says
// why on that machine; the likely cause is latency: each CTA waits on two
// dependent loads (its cell starts, then its rows) and two barriers per
// round, and at 3.8 rows per cell a round holds only ~120 rows, so few
// bytes are in flight per SM, while the rows' arithmetic is cheap.
//
// No atomics: each sum has one owner thread.  Build with -fmad=false so
// that the weight products round as the reference's separate multiplies
// and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// payload rows after the key (icebergs_tpu/ops/pallas_spread.py:47-60,
// each one less: R_KEY is not read)
constexpr int P_XI = 0, P_YJ = 1, P_AREA = 2, P_MASS = 3, P_LWMS = 4,
              P_U = 5, P_V = 6, P_MASSMS = 7, P_VIRT = 8, P_BITS = 9,
              P_FLB = 10, P_FLBB = 11, P_NFIX = 12;
// per-cell table rows: 9 neighbour masks then the cell area
constexpr int T_AREA = 9, T_USED = 10;
constexpr int NSPREAD = 36, NFIXOUT = 43, MAX_EXTRA = 16;
// staged values per row: 9 weights, 4 values, 7 cell columns, the extras
constexpr int S_VAL = 9, S_CELL = 13, S_FIX = 20;
// 5 CTAs per SM (48 registers): 0.097 ms at n_extra 3 and 0.123 at 14 on
// the headline slab, against 0.109 / 0.126 at 4 CTAs per SM (64
// registers), 0.101 / 0.124 at 6, 0.090 / 0.143 at 8 (spills), 0.096 /
// 0.126 for 16 cells, 128 threads, 10 CTAs per SM (NVIDIA H100,
// tools/time_k3_shapes.py)
constexpr int CB = 32, NT = 256, MIN_CTAS = 5;
constexpr int TREE_MIN_ROWS = 32;    // rows a tree-mode chunk stages at least
constexpr int MAX_K = 32;          // slots of the overflow association

struct RowTable {
  const float* p[P_NFIX + MAX_EXTRA];
};

// odd, so that thread t's stores at t * width hit distinct banks
__host__ __device__ constexpr int stage_width(int ne) {
  return (S_FIX + ne) | 1;
}

__host__ __device__ constexpr int log2_ceil(int k) {
  int l = 0;
  while ((1 << l) < k) ++l;
  return l;
}

// shared floats: sequential rounds stage NT rows; tree rounds keep the
// pending slot sums (log2_ceil(K) levels of CB * OUT) and stage the rest
size_t region_floats(int ne, int K) {
  const int out = NFIXOUT + ne;
  const size_t seq = (size_t)NT * stage_width(ne);
  const size_t tree = (size_t)log2_ceil(K) * CB * out +
                      (size_t)TREE_MIN_ROWS * stage_width(ne);
  return seq > tree ? seq : tree;
}

// summand of staged row s for output column col (the S column order)
__device__ __forceinline__ float summand(const float* s, int col) {
  return col < NSPREAD ? s[col >> 2] * s[S_VAL + (col & 3)]
                       : s[S_CELL + (col - NSPREAD)];
}

__global__ void spread_window_flags(const int32_t* __restrict__ cs,
                                    int ncells, int cell_block, int nblocks,
                                    int wl, uint8_t* __restrict__ bad,
                                    int32_t* __restrict__ nbad) {
  __shared__ int s_cnt[32];
  int cnt = 0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    const long long b0 = (long long)b * cell_block;
    const long long ws = cs[b0 < ncells ? b0 : ncells];
    const long long wend = cs[b0 + cell_block < ncells ? b0 + cell_block
                                                        : ncells];
    const bool f = wend - (ws / 128) * 128 > wl;
    bad[b] = f;
    cnt += f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_cnt[w];
    *nbad = total;
  }
}

// pushes slot k (k < K-1) of pair p: merges it with the pending left
// siblings at the levels where k has a 1 bit and parks the result at the
// first 0 bit, which exists below `levels` since k < 2^levels - 1
__device__ __forceinline__ void tree_push(float* pend, int stride, int p,
                                          int k, float cur, int levels) {
  for (int l = 0; l < levels; ++l) {
    float* q = pend + l * stride + p;
    if ((k >> l) & 1) {
      cur = *q + cur;
    } else {
      *q = cur;
      return;
    }
  }
}

// NE_T: n_extra, or -1 for the run-time value
template <int NE_T>
__global__ void __launch_bounds__(NT, MIN_CTAS)
segment_spread_kernel(RowTable rows, const int32_t* __restrict__ cs,
                      const float* __restrict__ tbl, int ncells,
                      float* __restrict__ S, const int32_t* __restrict__ nbad,
                      int ne_rt, int K, int region, int use_old_spreading) {
  const int ne = NE_T >= 0 ? NE_T : ne_rt;
  const int out = NFIXOUT + ne;
  const int stg_w = stage_width(ne);
  constexpr int NPT =
      (CB * (NFIXOUT + (NE_T >= 0 ? NE_T : MAX_EXTRA)) + NT - 1) / NT;
  extern __shared__ float sm[];
  __shared__ int s_cs[CB + 1];
  __shared__ float s_tbl[T_USED][CB];

  const int t = threadIdx.x;
  const int c0 = blockIdx.x * CB;
  const int ncb = min(CB, ncells - c0);
  const int npairs = ncb * out;
  if (t <= ncb) s_cs[t] = cs[c0 + t];
  for (int e = t; e < T_USED * CB; e += NT) {
    const int k = e / CB, c = e % CB;
    s_tbl[k][c] = c < ncb ? tbl[(long long)k * ncells + c0 + c] : 0.f;
  }
  const bool tree = *nbad > 0;                   // the same in every CTA
  const int levels = tree ? log2_ceil(K) : 0;
  const int pstride = CB * out;
  float* pend = sm;                              // tree: [levels][CB * out]
  float* stg = sm + levels * pstride;
  const int chunk = tree ? min(NT, (region - levels * pstride) / stg_w) : NT;

  float acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) acc[i] = 0.f;
  __syncthreads();
  const int r0 = s_cs[0], r1 = s_cs[ncb];

  for (int base = r0; base < r1; base += chunk) {
    const int m = min(chunk, r1 - base);
    if (t < m) {
      const int r = base + t;
      // the cell of row r: the last c with s_cs[c] <= r
      int lo = 0, hi = ncb - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_cs[mid] <= r) lo = mid;
        else hi = mid - 1;
      }
      const int c = lo;
      const float area_cell = s_tbl[T_AREA][c];
      const float area_c = fmaxf(area_cell, 1e-30f);
      const float x = rows.p[P_XI][r];
      const float y = rows.p[P_YJ][r];
      float xL, xR, yD, yU;
      if (use_old_spreading) {
        xL = fminf(0.5f, fmaxf(0.f, 0.5f - x));
        xR = fminf(0.5f, fmaxf(0.f, x - 0.5f));
        yD = fminf(0.5f, fmaxf(0.f, 0.5f - y));
        yU = fminf(0.5f, fmaxf(0.f, y - 0.5f));
      } else {
        const float Area = rows.p[P_AREA][r];
        const float L = area_cell > 0.f
                            ? fminf(sqrtf(Area / area_c), 1.f)
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
      float* s = stg + t * stg_w;
      const float w0 = yD * xL * s_tbl[0][c];
      const float w1 = yD * xC * s_tbl[1][c];
      const float w2 = yD * xR * s_tbl[2][c];
      const float w3 = yC * xL * s_tbl[3][c];
      const float w5 = yC * xR * s_tbl[5][c];
      const float w6 = yU * xL * s_tbl[6][c];
      const float w7 = yU * xC * s_tbl[7][c];
      const float w8 = yU * xR * s_tbl[8][c];
      s[0] = w0;
      s[1] = w1;
      s[2] = w2;
      s[3] = w3;
      s[4] = 1.f - (((w0 + w8) + (w2 + w6)) + ((w3 + w5) + (w1 + w7)));
      s[5] = w5;
      s[6] = w6;
      s[7] = w7;
      s[8] = w8;
      const float lwms = rows.p[P_LWMS][r];
      const float u = rows.p[P_U][r];
      const float v = rows.p[P_V][r];
      s[S_VAL + 0] = rows.p[P_MASS][r];
      s[S_VAL + 1] = lwms;
      s[S_VAL + 2] = u * lwms;
      s[S_VAL + 3] = v * lwms;
      const float w_cell = rows.p[P_MASSMS][r] / area_c;
      s[S_CELL + 0] = w_cell;
      s[S_CELL + 1] = w_cell * u;
      s[S_CELL + 2] = w_cell * v;
      s[S_CELL + 3] = rows.p[P_VIRT][r];
      s[S_CELL + 4] = rows.p[P_BITS][r];
      s[S_CELL + 5] = rows.p[P_FLB][r];
      s[S_CELL + 6] = rows.p[P_FLBB][r];
#pragma unroll
      for (int e = 0; e < (NE_T >= 0 ? NE_T : MAX_EXTRA); ++e) {
        if (NE_T >= 0 || e < ne) s[S_FIX + e] = rows.p[P_NFIX + e][r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int p = t + i * NT;
      if (p < npairs) {
        const int cell = p / out, col = p - cell * out;
        const int cbeg = s_cs[cell];
        const int ra = max(cbeg, base), rb = min(s_cs[cell + 1], base + m);
        float a = acc[i];
        if (!tree) {
          for (int r = ra; r < rb; ++r) {
            const float* sr = stg + (r - base) * stg_w;
            a = a + summand(sr, col);
          }
        } else {
          for (int r = ra; r < rb; ++r) {
            const int k = r - cbeg;
            const float* sr = stg + (r - base) * stg_w;
            const float v = summand(sr, col);
            if (k < K - 1) tree_push(pend, pstride, p, k, 0.f + v, levels);
            else a = k == K - 1 ? 0.f + v : a + v;
          }
        }
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  float* Sb = S + (long long)c0 * out;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int p = t + i * NT;
    if (p >= npairs) continue;
    float v = acc[i];
    if (tree) {
      // fold the pending subtrees, lowest level first, onto the tail slot
      // K-1 when the cell reached it (empty right subtrees add +0)
      const int cell = p / out;
      const int n = s_cs[cell + 1] - s_cs[cell];
      const int j = min(n, K - 1);
      bool have = n >= K;
      for (int l = 0; l < levels; ++l) {
        if ((j >> l) & 1) {
          const float q = pend[l * pstride + p];
          v = have ? q + v : q;
          have = true;
        }
      }
      if (!have) v = 0.f;
    }
    Sb[p] = v;
  }
}

typedef void (*KernelFn)(RowTable, const int32_t*, const float*, int, float*,
                         const int32_t*, int, int, int, int);

// instantiations: 0 = n_extra 3 (the persistent lane), 1 = n_extra 14 (the
// per-step and DEM paths), 2 = generic
enum { V_E3 = 0, V_E14 = 1, V_GENERIC = 2 };

KernelFn kernel_of(int variant) {
  switch (variant) {
    case V_E3: return segment_spread_kernel<3>;
    case V_E14: return segment_spread_kernel<14>;
    default: return segment_spread_kernel<-1>;
  }
}

int variant_of(int n_extra, int generic) {
  if (!generic && n_extra == 3) return V_E3;
  if (!generic && n_extra == 14) return V_E14;
  return V_GENERIC;
}

bool valid_args(int n_extra, int K) {
  return n_extra >= 0 && n_extra <= MAX_EXTRA && K >= 1 && K <= MAX_K;
}

}  // namespace

extern "C" int ib_max_spread_extra() { return MAX_EXTRA; }
extern "C" int ib_max_spread_slots() { return MAX_K; }

// rows: host array of the 12 + n_extra payload row pointers (the rows after
// the key, float, stride 1); tbl: (16, ncells) float; S: (ncells,
// 43 + n_extra) float; bad: (ceil(ncells / cell_block),) bytes; nbad: one
// int32.  wl: the TPU window's rows (128-aligned), K: the slots of the
// overflow association.
extern "C" int ib_segment_spread_sums(const void* const* rows,
                                      const void* cell_starts, const void* tbl,
                                      void* S, void* bad, void* nbad,
                                      int ncells, int n_extra, int cell_block,
                                      int wl, int K, int use_old_spreading,
                                      int generic, void* stream) {
  if (!valid_args(n_extra, K) || cell_block < 1)
    return (int)cudaErrorInvalidValue;
  if (ncells == 0) return (int)cudaGetLastError();
  RowTable tab;
  for (int k = 0; k < P_NFIX + MAX_EXTRA; ++k)
    tab.p[k] = k < P_NFIX + n_extra ? (const float*)rows[k] : nullptr;
  const int nblocks = (ncells + cell_block - 1) / cell_block;
  spread_window_flags<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell_starts, ncells, cell_block, nblocks, wl,
      (uint8_t*)bad, (int32_t*)nbad);
  const int region = (int)region_floats(n_extra, K);
  kernel_of(variant_of(n_extra, generic))<<<(ncells + CB - 1) / CB, NT,
                                            region * sizeof(float),
                                            (cudaStream_t)stream>>>(
      tab, (const int32_t*)cell_starts, (const float*)tbl, ncells, (float*)S,
      (const int32_t*)nbad, n_extra, K, region, use_old_spreading);
  return (int)cudaGetLastError();
}

// The instantiation a launch takes, its dynamic shared memory and its
// resident CTAs per SM.
extern "C" int ib_spread_config(int n_extra, int K, int generic, int* variant,
                                int* smem, int* ctas_per_sm) {
  if (!valid_args(n_extra, K)) return (int)cudaErrorInvalidValue;
  *variant = variant_of(n_extra, generic);
  *smem = (int)(region_floats(n_extra, K) * sizeof(float));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel_of(*variant), NT, (size_t)*smem);
}
