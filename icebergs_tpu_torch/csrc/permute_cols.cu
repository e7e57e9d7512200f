// K1: column permutation of a (C, Nsrc) 32-bit matrix, out[c, i] = R[c, idx[i]].
//
// Replaces icebergs_tpu/ops/pallas_pack.py::pack_rows_to_lanes and
// ::unpack_lanes_to_rows together with the jnp.take between them: on the
// TPU the (C, N) -> (N, 128) block transpose exists so that one row gather
// moves up to 128 columns, and the inverse transpose brings them back.  On
// the GPU a separate transpose buys nothing, so this kernel fuses
// pack -> take -> unpack into one pass.  It moves bits only (int32 view of
// f32 / i32 / 0-1 bool columns).
//
// Bound: memory.  Each output element costs one 4-byte read and one
// 4-byte write, plus one read of idx per (column chunk, row).  Threads run
// along i, so writes and idx reads are coalesced; reads R[c, idx[i]] are
// a gather whose locality follows idx (near-identity for the persistent
// re-sort, cell-local for the table interpolation).  gridDim.y splits the
// columns so that one launch fills the card for any C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void permute_cols_kernel(const int32_t* __restrict__ R,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int C,
                                    long long nsrc, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long s = idx[i];
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    out[c * n + i] = R[c * nsrc + s];
  }
}

}  // namespace

extern "C" int ib_permute_cols_u32(const void* R, const void* idx, void* out,
                                   int C, long long nsrc, long long n,
                                   void* stream) {
  if (n == 0 || C == 0) return (int)cudaGetLastError();
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)(C < 16 ? C : 16));
  permute_cols_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)R, (const int32_t*)idx, (int32_t*)out, C, nsrc, n);
  return (int)cudaGetLastError();
}
