// K1: the packed row transport, out[c, i] = R[c, idx[i]] on 32-bit words.
//
// Replaces icebergs_tpu/ops/pallas_pack.py::pack_rows_to_lanes and
// ::unpack_lanes_to_rows together with the jnp.take between them: on the
// TPU the (C, N) -> (N, 128) block transpose exists so that one row gather
// moves up to 128 columns, and the inverse transpose brings them back.  It
// moves bits only (int32 view of f32 / i32 / 0-1 columns).  idx == nsrc is
// the dead key and reads 0, so no caller appends a zero column.
//
// Three kernels, one per layout of the source:
//
// permute_cols_kernel (column gather).  The C source columns are read
//   through a table of pointers and element strides passed by value, so a
//   caller hands over the tensors it has (rows of a matrix, columns of a
//   2-D state leaf, separate 1-D tensors) and stacks nothing; a null
//   pointer is a column of zeros and is never read.  One thread per output
//   index reads idx once and keeps PC_GROUP column loads in flight;
//   blockIdx.y walks column groups slowest, so the blocks in flight read
//   the same PC_GROUP columns (PC_GROUP * nsrc * 4 B, 16 MB at 1M rows)
//   and a random gather finds its sectors in L2 (8 columns, 32 MB, ran
//   1.3x slower at C = 49: more than the L2 keeps).  Bound: where idx is
//   local (the persistent re-sort), the bytes; where it is random, the
//   L2's sector requests, one 32-byte sector for each 4-byte word.
//
// pack_rows_kernel (columns -> rows).  The same column table written as a
//   row-major (nsrc, C) matrix through a shared-memory transpose: reads and
//   writes coalesced.
//
// gather_rows_kernel (rows by index -> columns).  A row-major (nsrc, ldt)
//   table gathered by idx: a warp reads a row's C words as consecutive
//   addresses, so each sector it fetches is used whole (64 words: 8
//   sectors, against 64 sectors for the column gather at a random idx).
//   The rows land in shared memory, [c][j] padded to GR_TILE + 1 words so
//   that neither the row writes nor the column reads conflict, and leave
//   as coalesced runs of GR_TILE words of each output column.
//   Bound: bytes.
//
// pack_rows + gather_rows is the row route, four passes over the data
// instead of one gather of scattered words.  On an H100 it wins only
// where idx is random and the columns are many: the cell table by the
// per-step slab's keys (C = 64: 0.28 against 0.51 ms) and the first sort
// (C = 49: 0.39 against 0.46).  Near-identity, sorted or conglomerate-
// local orders, and random ones at C <= 27, take the column gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K1_MAX_COLS = 128;   // columns per launch (the table below)
constexpr int PC_THREADS = 256, PC_GROUP = 4;
constexpr int PR_TILE = 32, PR_THREADS = 256;
constexpr int PR_ROWS = PR_THREADS / PR_TILE;         // columns read at once
constexpr int PR_MAX_K = K1_MAX_COLS / PR_ROWS;       // loads per thread
constexpr int GR_TILE = 64, GR_THREADS = 256;
constexpr int GR_WARPS = GR_THREADS / 32, GR_ROWS_PER_WARP = GR_TILE / GR_WARPS;
constexpr int GR_MAX_Q = K1_MAX_COLS / 32;   // words of a row per lane

// The source columns, by value in the kernel's parameters (2 KB): column c
// is src[c][r * stride[c]], r < nsrc; src[c] == nullptr is all zeros.
struct ColTable {
  const int32_t* src[K1_MAX_COLS];
  long long stride[K1_MAX_COLS];
};

__global__ void __launch_bounds__(PC_THREADS)
permute_cols_kernel(ColTable tab, const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int C, long long nsrc,
                    long long n) {
  const long long i = (long long)blockIdx.x * PC_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long s = idx[i];
  const bool live = s < nsrc;        // idx == nsrc: the dead key, reads 0
  const int c0 = blockIdx.y * PC_GROUP;
  int32_t v[PC_GROUP];
#pragma unroll
  for (int k = 0; k < PC_GROUP; ++k) {
    const int c = c0 + k;
    v[k] = 0;
    if (c < C && live) {
      const int32_t* p = tab.src[c];
      if (p != nullptr) v[k] = __ldg(p + s * tab.stride[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < PC_GROUP; ++k)
    if (c0 + k < C) out[(long long)(c0 + k) * n + i] = v[k];
}

__global__ void __launch_bounds__(PR_THREADS)
pack_rows_kernel(ColTable tab, int32_t* __restrict__ T, int C,
                 long long nsrc) {
  extern __shared__ int32_t sm[];                    // [C][PR_TILE + 1]
  const long long r0 = (long long)blockIdx.x * PR_TILE;
  const int t = threadIdx.x;
  const int j = t % PR_TILE;
  const long long r = r0 + j;
  // every load of the thread in flight before the first store
  int32_t v[PR_MAX_K];
#pragma unroll
  for (int k = 0; k < PR_MAX_K; ++k) {
    const int c = t / PR_TILE + k * PR_ROWS;
    v[k] = 0;
    if (c < C && r < nsrc) {
      const int32_t* p = tab.src[c];
      if (p != nullptr) v[k] = __ldg(p + r * tab.stride[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < PR_MAX_K; ++k) {
    const int c = t / PR_TILE + k * PR_ROWS;
    if (c < C) sm[c * (PR_TILE + 1) + j] = v[k];
  }
  __syncthreads();
  const long long rows = nsrc - r0 < PR_TILE ? nsrc - r0 : PR_TILE;
  const int m = (int)rows * C;
  int32_t* dst = T + r0 * C;
  for (int e = t; e < m; e += PR_THREADS) {
    const int jj = e / C, c = e - jj * C;
    dst[e] = sm[c * (PR_TILE + 1) + jj];
  }
}

__global__ void __launch_bounds__(GR_THREADS)
gather_rows_kernel(const int32_t* __restrict__ T, long long ldt,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int C, long long nsrc,
                   long long n) {
  extern __shared__ int32_t sm[];                    // [C][GR_TILE + 1]
  const long long i0 = (long long)blockIdx.x * GR_TILE;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jw = w * GR_ROWS_PER_WARP;
  // lane b < GR_ROWS_PER_WARP holds the index of the warp's b-th row
  int mine = (int)nsrc;
  if (lane < GR_ROWS_PER_WARP && i0 + jw + lane < n) mine = idx[i0 + jw + lane];
#pragma unroll
  for (int b = 0; b < GR_ROWS_PER_WARP; ++b) {
    const long long s = __shfl_sync(0xffffffffu, mine, b);
    const int32_t* row = T + s * ldt;
    const bool live = s < nsrc;
#pragma unroll
    for (int q = 0; q < GR_MAX_Q; ++q) {
      const int c = lane + 32 * q;
      if (c < C) sm[c * (GR_TILE + 1) + jw + b] = live ? __ldg(row + c) : 0;
    }
  }
  __syncthreads();
  const long long rows = n - i0 < GR_TILE ? n - i0 : GR_TILE;
  for (int e = threadIdx.x; e < C * GR_TILE; e += GR_THREADS) {
    const int c = e / GR_TILE, j = e % GR_TILE;
    if (j < rows) out[(long long)c * n + i0 + j] = sm[c * (GR_TILE + 1) + j];
  }
}

cudaError_t fill_table(ColTable* tab, const void* const* ptrs,
                       const long long* strides, int C) {
  if (C < 1 || C > K1_MAX_COLS) return cudaErrorInvalidValue;
  for (int c = 0; c < C; ++c) {
    tab->src[c] = (const int32_t*)ptrs[c];
    tab->stride[c] = strides[c];
  }
  for (int c = C; c < K1_MAX_COLS; ++c) {
    tab->src[c] = nullptr;
    tab->stride[c] = 0;
  }
  return cudaSuccess;
}

}  // namespace

// ptrs / strides: host arrays of C column pointers (null = zeros) and
// element strides; out: (C, n) int32.
extern "C" int ib_permute_cols(const void* const* ptrs,
                               const long long* strides, int C,
                               const void* idx, void* out, long long nsrc,
                               long long n, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  ColTable tab;
  cudaError_t e = fill_table(&tab, ptrs, strides, C);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((n + PC_THREADS - 1) / PC_THREADS),
            (unsigned)((C + PC_GROUP - 1) / PC_GROUP));
  permute_cols_kernel<<<grid, PC_THREADS, 0, (cudaStream_t)stream>>>(
      tab, (const int32_t*)idx, (int32_t*)out, C, nsrc, n);
  return (int)cudaGetLastError();
}

// T: (nsrc, C) int32, row-major, written whole.
extern "C" int ib_pack_rows(const void* const* ptrs, const long long* strides,
                            int C, void* T, long long nsrc, void* stream) {
  if (nsrc == 0) return (int)cudaGetLastError();
  ColTable tab;
  cudaError_t e = fill_table(&tab, ptrs, strides, C);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)C * (PR_TILE + 1) * sizeof(int32_t);
  pack_rows_kernel<<<(unsigned)((nsrc + PR_TILE - 1) / PR_TILE), PR_THREADS,
                     smem, (cudaStream_t)stream>>>(tab, (int32_t*)T, C, nsrc);
  return (int)cudaGetLastError();
}

// Kernel k (0 column gather, 1 pack, 2 row gather) at C columns: its
// threads per block, dynamic shared memory and resident CTAs per SM.
extern "C" int ib_k1_config(int k, int C, int* threads, int* smem,
                            int* ctas_per_sm) {
  if (C < 1 || C > K1_MAX_COLS) return (int)cudaErrorInvalidValue;
  const void* fn;
  if (k == 0) {
    fn = (const void*)permute_cols_kernel;
    *threads = PC_THREADS;
    *smem = 0;
  } else if (k == 1) {
    fn = (const void*)pack_rows_kernel;
    *threads = PR_THREADS;
    *smem = C * (PR_TILE + 1) * (int)sizeof(int32_t);
  } else if (k == 2) {
    fn = (const void*)gather_rows_kernel;
    *threads = GR_THREADS;
    *smem = C * (GR_TILE + 1) * (int)sizeof(int32_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fn, *threads, (size_t)*smem);
}

// T: (nsrc, ldt) int32 with rows of at least C words; out: (C, n) int32.
extern "C" int ib_gather_rows(const void* T, long long ldt, int C,
                              const void* idx, void* out, long long nsrc,
                              long long n, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (C < 1 || C > K1_MAX_COLS || ldt < C) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * (GR_TILE + 1) * sizeof(int32_t);
  gather_rows_kernel<<<(unsigned)((n + GR_TILE - 1) / GR_TILE), GR_THREADS,
                       smem, (cudaStream_t)stream>>>(
      (const int32_t*)T, ldt, (const int32_t*)idx, (int32_t*)out, C, nsrc, n);
  return (int)cudaGetLastError();
}
