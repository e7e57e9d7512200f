"""K1: the permute transport behind every packed row gather.

Counterpart of ``icebergs_tpu/ops/pallas_pack.py``.  The JAX package
moves C <= 128 u32 columns by ``pack_rows_to_lanes`` (a (C, N) -> (N, 128)
block transpose), one ``jnp.take`` of rows, and ``unpack_lanes_to_rows``.
Together those compute ``out[c, i] = R[c, idx[i]]``; the CUDA kernel
(``csrc/permute_cols.cu``) computes exactly that in one pass.

Columns travel as int32 bit patterns (``Tensor.view(torch.int32)``): the
transport is exact for f32/i32, and bools go as 0/1.
"""

from __future__ import annotations

import torch

from .. import cuda_build


def permute_cols_u32_plain(R, idx):
    """Plain version: ``R[:, idx]``."""
    return R[:, idx.long()]


def permute_cols_u32(R, idx):
    """``out[c, i] = R[c, idx[i]]`` for a (C, Nsrc) int32 matrix ``R`` and
    (N,) int32 indices in ``[0, Nsrc)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``permute_cols_u32.launches``)."""
    if R.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"R {tuple(R.shape)}, idx {tuple(idx.shape)}")
    if R.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"R {R.dtype}, idx {idx.dtype}: need int32")
    if R.device != idx.device:
        raise ValueError(f"R on {R.device}, idx on {idx.device}")
    if R.device.type == "cpu":
        return permute_cols_u32_plain(R, idx)
    if R.device.type != "cuda":
        raise NotImplementedError(f"no K1 kernel for {R.device}")
    if not (R.is_contiguous() and idx.is_contiguous()):
        raise ValueError("permute_cols_u32 needs contiguous tensors")
    C, nsrc = R.shape
    n = idx.shape[0]
    out = torch.empty((C, n), dtype=torch.int32, device=R.device)
    lib = cuda_build.library()
    cuda_build.check(lib.ib_permute_cols_u32(
        R.data_ptr(), idx.data_ptr(), out.data_ptr(), C, nsrc, n,
        cuda_build.stream_ptr(R.device)), "permute_cols_u32")
    permute_cols_u32.launches += 1
    return out


permute_cols_u32.launches = 0


def to_bits(col):
    """One (N,) column as its int32 bit pattern (bool -> 0/1)."""
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    return col.view(torch.int32)


def from_bits(bits, dtype):
    """Inverse of :func:`to_bits`."""
    if dtype == torch.bool:
        return bits > 0
    return bits.view(dtype)
