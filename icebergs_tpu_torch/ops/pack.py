"""K1: the permute transport behind every packed row gather.

Counterpart of ``icebergs_tpu/ops/pallas_pack.py``.  The JAX package
moves C <= 128 u32 columns by ``pack_rows_to_lanes`` (a (C, N) -> (N, 128)
block transpose), one ``jnp.take`` of rows, and ``unpack_lanes_to_rows``.
Together those compute ``out[c, i] = R[c, idx[i]]``.  The CUDA source
(``csrc/permute_cols.cu``) has three entries, one per layout of the
source, each with its wrapper here and its launch count:

- :func:`permute_cols_u32`: ``out[c, i] = R[c, idx[i]]`` with the C
  columns handed over as they lie (a matrix, or a list of 1-D tensors of
  any stride, ``None`` for a column of zeros): the callers stack nothing.
  ``via_rows=True`` moves them through :func:`pack_rows_u32` and
  :func:`gather_rows_u32` instead, which reads whole rows: faster where
  ``idx`` is random and the columns are many (the per-step table gather,
  the first sort; ``csrc/permute_cols.cu``);
- :func:`pack_rows_u32`: the columns as one row-major (nsrc, C) matrix;
- :func:`gather_rows_u32`: ``out[c, i] = T[idx[i], c]`` from a row-major
  table.

``idx`` lies in ``[0, nsrc]``; ``idx == nsrc`` is the dead key and reads 0.
Columns travel as int32 bit patterns (``Tensor.view(torch.int32)``): the
transport is exact for f32/i32, and bools go as 0/1.  A float64 column
travels as its int64 bits, which only the plain versions (CPU tensors)
take: the float64 model runs on the CPU.
"""

from __future__ import annotations

import array
import ctypes

import torch

from .. import cuda_build

MAX_COLS = 128                  # columns per launch (csrc/permute_cols.cu)


def _bits_type_ok(t):
    """int32 columns, or int64 ones (float64 bits) on the CPU."""
    return t.dtype == torch.int32 or (t.dtype == torch.int64
                                      and t.device.type == "cpu")


def _source(R, what):
    """The columns ``R`` (a (C, nsrc) matrix, or a sequence of (nsrc,)
    tensors and ``None``) checked to be int32 on one device (or int64 on
    the CPU), as ``(C, nsrc, device, pointers, element strides)``
    (pointer None for a column of zeros)."""
    if isinstance(R, torch.Tensor):
        if R.dim() != 2 or not _bits_type_ok(R):
            raise TypeError(f"{what}: R {R.dtype} {tuple(R.shape)}, need "
                            "(C, nsrc) int32")
        C, nsrc = R.shape
        b, s0 = R.data_ptr(), 4 * R.stride(0)
        return C, nsrc, R.device, [b + s0 * c for c in range(C)], \
            [R.stride(1)] * C
    ptrs, strides, nsrc, dev = [], [], None, None
    for c in R:
        if c is None:
            ptrs.append(None)
            strides.append(0)
            continue
        shape = c.shape
        if nsrc is None:
            nsrc, dev = shape[0], c.device
        if not _bits_type_ok(c) or shape != (nsrc,) or c.device != dev:
            raise TypeError(f"{what}: column {c.dtype} {tuple(shape)} on "
                            f"{c.device}, need ({nsrc},) int32 on {dev}")
        ptrs.append(c.data_ptr())
        strides.append(c.stride()[0])
    if nsrc is None:
        raise ValueError(f"{what}: no tensor among the columns")
    return len(ptrs), nsrc, dev, ptrs, strides


def _matrix_plain(R):
    """The columns as one (C, nsrc) matrix (zeros for ``None``)."""
    if isinstance(R, torch.Tensor):
        return R
    like = next(c for c in R if c is not None)
    wide = any(c is not None and c.dtype == torch.int64 for c in R)
    z = like.new_zeros(like.shape[0],
                       dtype=torch.int64 if wide else torch.int32)
    return torch.stack([z if c is None else c.to(z.dtype) for c in R])


def _check_idx(idx, device, what):
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != device:
        raise TypeError(f"{what}: idx {idx.dtype} {tuple(idx.shape)} on "
                        f"{idx.device}, need (n,) int32 on {device}")


def _device_kernel(device, what):
    if device.type != "cuda":
        raise NotImplementedError(f"{what}: no K1 kernel for {device}")


def _table_args(ptrs, strides):
    """Host arrays of the columns' pointers (0 for zeros) and element
    strides, as the C entries take them (the arrays ride along, so that
    they live through the call)."""
    p = array.array("Q", [0 if q is None else q for q in ptrs])
    s = array.array("q", strides)
    return p.buffer_info()[0], s.buffer_info()[0], p, s


def permute_cols_u32_plain(R, idx):
    """Plain version: ``R[:, idx]`` with a zero column at ``nsrc``."""
    M = _matrix_plain(R)
    M = torch.cat([M, M.new_zeros(M.shape[0], 1)], dim=1)
    return M[:, idx.long()]


def permute_cols_u32(R, idx, *, via_rows: bool = False):
    """``out[c, i] = R[c, idx[i]]`` (0 where ``idx[i] == nsrc``) for C
    int32 source columns ``R`` (a (C, nsrc) matrix, or a sequence of
    (nsrc,) tensors of any stride with ``None`` for zeros) and (n,) int32
    ``idx``.  Returns a (C, n) int32 matrix.

    ``via_rows`` takes the row route (:func:`pack_rows_u32` then
    :func:`gather_rows_u32`), bitwise the same; the call sites choose it
    where ``idx`` is random (``PERF.md``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``permute_cols_u32.launches``, one per launch of at
    most 128 columns)."""
    C, nsrc, dev, ptrs, strides = _source(R, "permute_cols_u32")
    _check_idx(idx, dev, "permute_cols_u32")
    if dev.type == "cpu":
        return permute_cols_u32_plain(R, idx)
    _device_kernel(dev, "permute_cols_u32")
    if not idx.is_contiguous():
        raise ValueError("permute_cols_u32 needs a contiguous idx")
    n = idx.shape[0]
    out = torch.empty((C, n), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    for lo in range(0, C, MAX_COLS):
        p, s = ptrs[lo:lo + MAX_COLS], strides[lo:lo + MAX_COLS]
        if via_rows:
            _gather_rows_into(_pack(p, s, nsrc, dev), idx,
                              out[lo:lo + len(p)])
            continue
        pa, sa, *_keep = _table_args(p, s)
        cuda_build.check(lib.ib_permute_cols(
            pa, sa, len(p), idx.data_ptr(), out[lo].data_ptr(), nsrc, n,
            cuda_build.stream_ptr(dev)), "permute_cols_u32")
        permute_cols_u32.launches += 1
    return out


permute_cols_u32.launches = 0


def pack_rows_u32_plain(R):
    """Plain version: the columns stacked along dim 1."""
    return _matrix_plain(R).T.contiguous()


def pack_rows_u32(R):
    """The C <= 128 int32 columns ``R`` (as :func:`permute_cols_u32` takes
    them) as one row-major (nsrc, C) int32 matrix.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``pack_rows_u32.launches``)."""
    C, nsrc, dev, ptrs, strides = _source(R, "pack_rows_u32")
    if dev.type == "cpu":
        return pack_rows_u32_plain(R)
    _device_kernel(dev, "pack_rows_u32")
    if C > MAX_COLS:
        raise ValueError(f"pack_rows_u32: {C} columns > {MAX_COLS}")
    return _pack(ptrs, strides, nsrc, dev)


pack_rows_u32.launches = 0


def _pack(ptrs, strides, nsrc, dev):
    T = torch.empty((nsrc, len(ptrs)), dtype=torch.int32, device=dev)
    pa, sa, *_keep = _table_args(ptrs, strides)
    cuda_build.check(cuda_build.library().ib_pack_rows(
        pa, sa, len(ptrs), T.data_ptr(), nsrc, cuda_build.stream_ptr(dev)),
        "pack_rows_u32")
    pack_rows_u32.launches += 1
    return T


def gather_rows_u32_plain(T, idx):
    """Plain version: ``T.T[:, idx]`` with a zero column at ``nsrc``."""
    M = torch.cat([T, T.new_zeros(1, T.shape[1])]).T
    return M[:, idx.long()].contiguous()


def gather_rows_u32(T, idx):
    """``out[c, i] = T[idx[i], c]`` (0 where ``idx[i] == nsrc``) for a
    row-major (nsrc, C <= 128) int32 table ``T`` (rows may be strided:
    ``T.stride(1) == 1``) and (n,) int32 ``idx``.  Returns (C, n) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``gather_rows_u32.launches``)."""
    if T.dim() != 2 or T.dtype != torch.int32:
        raise TypeError(f"T {T.dtype} {tuple(T.shape)}: need (nsrc, C) "
                        "int32")
    _check_idx(idx, T.device, "gather_rows_u32")
    if T.device.type == "cpu":
        return gather_rows_u32_plain(T, idx)
    _device_kernel(T.device, "gather_rows_u32")
    out = torch.empty((T.shape[1], idx.shape[0]), dtype=torch.int32,
                      device=T.device)
    _gather_rows_into(T, idx, out)
    return out


gather_rows_u32.launches = 0


def _gather_rows_into(T, idx, out):
    """Launch the row gather of ``T`` by ``idx`` into the contiguous
    (C, n) int32 ``out``."""
    nsrc, C = T.shape
    if C > MAX_COLS or T.stride(1) != 1 or not idx.is_contiguous():
        raise ValueError(f"gather_rows_u32: T {tuple(T.shape)} strides "
                         f"{T.stride()}: need C <= {MAX_COLS}, unit column "
                         "stride and a contiguous idx")
    cuda_build.check(cuda_build.library().ib_gather_rows(
        T.data_ptr(), T.stride(0), C, idx.data_ptr(), out.data_ptr(), nsrc,
        idx.shape[0], cuda_build.stream_ptr(T.device)), "gather_rows_u32")
    gather_rows_u32.launches += 1


_KERNELS = (("permute_cols_kernel", "columns"), ("pack_rows_kernel", "pack"),
            ("gather_rows_kernel", "rows"))


def kernel_resources(C: int = 64) -> dict:
    """Each K1 kernel's registers, stack and spill bytes (the library's
    ``-Xptxas -v`` report) and, at ``C`` columns on the current CUDA
    device, its threads per block, dynamic shared memory and resident
    CTAs per SM."""
    report = cuda_build.resource_report()
    lib = cuda_build.library()
    out = {}
    for k, (fn, name) in enumerate(_KERNELS):
        r = next((v for m, v in report.items() if fn in m), {})
        threads, smem, ctas = (ctypes.c_int(), ctypes.c_int(),
                               ctypes.c_int())
        cuda_build.check(lib.ib_k1_config(k, C, ctypes.byref(threads),
                                          ctypes.byref(smem),
                                          ctypes.byref(ctas)), "k1_config")
        out[name] = dict(r, C=C, threads=threads.value, smem=smem.value,
                         ctas=ctas.value)
    return out


def to_bits(col):
    """One (N,) column as its int32 bit pattern (bool -> 0/1; a float64
    column as its int64 bits); ``None`` (a column of zeros) stays
    ``None``."""
    if col is None:
        return None
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    if col.element_size() == 8:
        return col.view(torch.int64)
    return col.view(torch.int32)


def from_bits(bits, dtype):
    """Inverse of :func:`to_bits` (a 4-byte column that travelled beside
    float64 ones comes back from int64)."""
    if dtype == torch.bool:
        return bits > 0
    if bits.dtype == torch.int64 and torch.empty(
            (), dtype=dtype).element_size() == 4:
        bits = bits.to(torch.int32)
    return bits.view(dtype)
