// K3's pass-through: per-cell sums of given cell-sorted columns in a fixed
// association, one launch a call.
//
// Replaces the sums that icebergs_tpu/ops/pallas_spread.py's K3 entry
// (segment_spread_sums, pallas_call at :257) leaves to the other slot-sum
// methods of icebergs_tpu/ops/spread.py: the slot scatter
// _cell_slot_sums_scatter_t (:274-300) and the block sums of
// _cell_slot_sums_gather (:218).  Input: F float32 columns of N rows in
// (cell, id) order and cell_starts (ncells + 1); output S (ncells, F),
// row-major, written once.  Two associations, chosen by the `tree`
// argument:
//
// - sequential (tree 0): each cell's rows added in row order onto +0;
// - slot tree (tree 1): rank k < K-1 of a cell in slot k (0 + r_k), ranks
//   >= K-1 added into slot K-1 in row order, then a fixed pairwise tree
//   over the K slots, zero-padded at odd levels.
//
// The tree is evaluated as a binary counter over the slots: pushing slot k
// merges it with the pending left siblings at the levels where k has a 1
// bit, which is the tree's own left + right order; the pending sums are
// registers (K <= 32: at most 5 levels, every level index a compile-time
// constant).  Slots past the cell's rows are +0 and are not added: no
// partial sum here is -0 (0 + x is never -0, and a sum of two values is -0
// only if both are), so x + 0 == x and the result is bitwise the padded
// tree's.
//
// Bound: memory.  Every column row of a live cell is read once, cell_starts
// once, and S written once: 218 MB for 43 columns of 1M rows on 262,144
// cells, 0.065 ms at 3.35 TB/s.  The arithmetic is one add a row.  The
// design keeps many independent loads in flight and stores whole lines:
//
// - A CTA owns CB = 32 consecutive cells and up to FC columns (the grid's
//   y covers wider column sets).  Lane l of every warp owns cell c0 + l,
//   and the CTA's NW warps take its columns in turn.  A lane loads its
//   cell's rank k straight from global memory, U ranks per round before it
//   adds them, so each lane has U loads in flight; a warp's loads of one
//   rank span the 32 cells' rows (about 120 consecutive floats at 3.8 rows
//   a cell), a few 128-byte lines that the next ranks hit again in L1.  A
//   700-row cell costs its warp a long loop, not a wrong answer.
// - Each warp parks its sums in a shared tile of the CTA's 32 cells x FC
//   columns (row stride FC | 1, so that the 32 lanes' stores fall in
//   distinct banks), and after one barrier the CTA stores the tile as the
//   cells' contiguous S rows.
// - The column addresses come in a table in the kernel's parameters, or as
//   a base pointer and a row stride when the columns are rows of one
//   matrix (any F), so nothing is copied before the launch.
//
// No atomics: each sum has one owner thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cells a CTA (one a lane), warps a CTA, column slots of a CTA's tile,
// ranks loaded ahead of their adds.  On the headline slab's 43 columns
// (NVIDIA H100 80GB HBM3, 700 W, tools/time_k3_pass.py), tree /
// sequential ms: 4 x 64 x 8 0.112 / 0.087, 8 x 64 x 4 0.114 / 0.095,
// 8 x 64 x 8 0.121 / 0.088, 8 x 64 x 2 0.152 / 0.116, 16 x 64 x 4 0.122 /
// 0.097, 2 x 64 x 4 0.133 / 0.123, 8 x 48 x 4 0.115 / 0.096
constexpr int CB = 32, NW = 4, FC = 64, U = 8;
constexpr int NT = 32 * NW;
constexpr int TILE_W = FC | 1;
constexpr int MAX_K = 32, LEVELS = 5;          // 2^LEVELS >= MAX_K
constexpr int MAX_TABLE = 128;                 // columns by address

struct ColTable {
  const float* p[MAX_TABLE];
};

// pushes slot k (k < K-1 <= 30) with value cur: merges it with the pending
// left siblings at the levels where k has a 1 bit and parks the result at
// its first 0 bit, which lies below LEVELS
__device__ __forceinline__ void tree_push(float (&pend)[LEVELS], int k,
                                          float cur) {
  bool done = false;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    if (!done) {
      if ((k >> l) & 1) {
        cur = pend[l] + cur;
      } else {
        pend[l] = cur;
        done = true;
      }
    }
  }
}

// the sum of one cell's n rows at x in the association TREE
template <bool TREE>
__device__ __forceinline__ float cell_sum(const float* __restrict__ x, int n,
                                          int K) {
  float acc = 0.f;
  float pend[LEVELS];
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) pend[l] = 0.f;
  for (int k0 = 0; k0 < n; k0 += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = k0 + u < n ? __ldg(x + k0 + u) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u;
      if (k >= n) break;
      if (!TREE) {
        acc = acc + v[u];
      } else if (k < K - 1) {
        tree_push(pend, k, 0.f + v[u]);
      } else {
        acc = k == K - 1 ? 0.f + v[u] : acc + v[u];
      }
    }
  }
  if (!TREE) return acc;
  // fold the pending subtrees, lowest level first, onto the tail slot K-1
  // when the cell reached it (empty right subtrees add +0)
  const int j = min(n, K - 1);
  bool have = n >= K;
#pragma unroll
  for (int l = 0; l < LEVELS; ++l) {
    if ((j >> l) & 1) {
      acc = have ? pend[l] + acc : pend[l];
      have = true;
    }
  }
  return have ? acc : 0.f;
}

template <bool TREE>
__global__ void __launch_bounds__(NT)
segment_sums_kernel(ColTable tab, const float* __restrict__ base,
                    long long stride, const int32_t* __restrict__ cs,
                    int ncells, int F, int K, float* __restrict__ S) {
  __shared__ float tile[CB * TILE_W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CB, f0 = blockIdx.y * FC;
  const int ncb = min(CB, ncells - c0), fc = min(FC, F - f0);
  int s = 0, n = 0;
  if (lane < ncb) {
    s = cs[c0 + lane];
    n = cs[c0 + lane + 1] - s;
  }
  for (int j = warp; j < fc; j += NW) {
    const int f = f0 + j;
    const float* col = base ? base + f * stride : tab.p[f];
    tile[lane * TILE_W + j] = cell_sum<TREE>(col + s, n, K);
  }
  __syncthreads();
  float* out = S + (long long)c0 * F + f0;
  for (int i = threadIdx.x; i < ncb * fc; i += NT) {
    const int c = i / fc, j = i - c * fc;
    out[(long long)c * F + j] = tile[c * TILE_W + j];
  }
}

}  // namespace

// cols: host array of F column addresses (float, stride 1), read when base
// is null (F <= MAX_TABLE); else column f is base + f * stride.
// cell_starts: (ncells + 1,) int32; S: (ncells, F) float.  tree: nonzero
// the slot tree over K slots (1 <= K <= 32), 0 sequential.
extern "C" int ib_segment_sums(const void* const* cols, const void* base,
                               long long stride, const void* cell_starts,
                               void* S, int ncells, int F, int K, int tree,
                               void* stream) {
  if (F < 0 || K < 1 || K > MAX_K || (!base && F > MAX_TABLE))
    return (int)cudaErrorInvalidValue;
  if (ncells == 0 || F == 0) return (int)cudaGetLastError();
  ColTable tab;
  for (int f = 0; f < MAX_TABLE; ++f)
    tab.p[f] = !base && f < F ? (const float*)cols[f] : nullptr;
  const dim3 grid((ncells + CB - 1) / CB, (F + FC - 1) / FC);
  if (tree)
    segment_sums_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        tab, (const float*)base, stride, (const int32_t*)cell_starts, ncells,
        F, K, (float*)S);
  else
    segment_sums_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        tab, (const float*)base, stride, (const int32_t*)cell_starts, ncells,
        F, K, (float*)S);
  return (int)cudaGetLastError();
}
