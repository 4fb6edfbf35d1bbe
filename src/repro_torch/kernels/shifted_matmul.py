"""Rank-1-corrected matmul ``C = op(A) @ B - u w^T`` — the wrapper of the
hand-written sm_90a CUDA kernel ``csrc/shifted_matmul.cu``.

It replaces the TPU kernel ``repro/kernels/shifted_matmul.py::
matmul_rank1`` (Pallas body ``_kernel``): the f32 accumulator tile stays
on chip across the contraction and the rank-1 term is subtracted in the
epilogue before the single write of C.  Its bound, and what the design
does about it, are noted in the source.

Dispatch follows the tensors' device: CPU tensors take the plain version
(``kernels/ref.py::matmul_rank1_ref``); CUDA tensors launch the kernel,
and any failure to build, load or launch it raises — there is no
fallback to the plain version.  ``matmul_rank1.launches`` counts the
kernel's launches (``launches_transposed`` those with ``transpose_a``).

Precision: TF32 is switched off for PyTorch's own float32 matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
(``torch.backends.cudnn.allow_tf32``) when this module is imported, so
the plain products beside the kernel on the main path (``X @ Omega``,
``Q @ U1``) stay true float32: TF32 keeps about three decimal digits and
would break f32 parity with the reference at 2e-4.  The kernel itself
never uses tensor cores.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_rank1_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the kernel's dtype codes (``srsvd_matmul_rank1``'s first argument)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _library() -> ctypes.CDLL:
    lib = _build.load("shifted_matmul")
    fn = lib.srsvd_matmul_rank1
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.srsvd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.srsvd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def matmul_rank1(A: torch.Tensor, B: torch.Tensor, u: torch.Tensor,
                 w: torch.Tensor, *, transpose_a: bool = False
                 ) -> torch.Tensor:
    """``op(A) @ B - u w^T`` with the rank-1 term fused into the epilogue.

    A: (m, n) [or (n, m) when transpose_a];  B: (n, K);  u: (m,);
    w: (K,).  Returns (m, K) in the promoted dtype of A and B; operands
    are cast to it first, as the TPU kernel does.  The kernel takes
    float32, bfloat16 and float64.
    """
    devices = {t.device for t in (A, B, u, w)}
    if len(devices) != 1:
        raise ValueError(f"matmul_rank1 operands span devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return matmul_rank1_ref(A, B, u, w, transpose_a=transpose_a)
    if device.type != "cuda":
        raise ValueError(f"matmul_rank1 runs on cpu or cuda, got {device}")
    return _launch(A, B, u, w, transpose_a)


def _launch(A, B, u, w, transpose_a):
    from repro_torch.core.contact import result_dtype
    out_dtype = result_dtype(A.dtype, B.dtype)
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA matmul_rank1 kernel takes "
                        f"{sorted(map(str, DTYPE_CODES))}; the operands "
                        f"promote to {out_dtype}")
    if A.dim() != 2 or B.dim() != 2 or u.dim() != 1 or w.dim() != 1:
        raise ValueError("matmul_rank1 needs 2-D A and B, 1-D u and w")
    m, n_ = (A.shape[1], A.shape[0]) if transpose_a else A.shape
    if B.shape[0] != n_ or u.shape[0] != m or w.shape[0] != B.shape[1]:
        raise ValueError(
            f"matmul_rank1 shapes disagree: A {tuple(A.shape)} "
            f"(transpose_a={transpose_a}), B {tuple(B.shape)}, "
            f"u {tuple(u.shape)}, w {tuple(w.shape)}")
    K = B.shape[1]
    A = A.to(out_dtype)
    B = B.to(out_dtype)
    u = u.to(out_dtype).contiguous()
    w = w.to(out_dtype).contiguous()
    # The kernel reads A with unit stride along its last axis; a
    # column-major A (e.g. a transposed view) is read as its row-major
    # transpose with the flag flipped, so no copy is made either way.
    trans = transpose_a
    if A.stride(1) != 1 and A.stride(0) == 1 and A.shape[1] > 1:
        A, trans = A.T, not trans
    elif A.stride(1) != 1:
        A = A.contiguous()
    if B.stride(1) != 1:
        B = B.contiguous()
    C = torch.empty((m, K), dtype=out_dtype, device=A.device)
    if m == 0 or K == 0:
        return C
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.srsvd_matmul_rank1(
            DTYPE_CODES[out_dtype], int(trans), A.data_ptr(), B.data_ptr(),
            u.data_ptr(), w.data_ptr(), C.data_ptr(), m, K, n_,
            max(A.stride(0), 1), max(B.stride(0), 1), C.stride(0), stream)
    if err != 0:
        msg = lib.srsvd_cuda_error_string(err).decode()
        raise RuntimeError(f"matmul_rank1 CUDA kernel launch failed: "
                           f"error {err} ({msg})")
    matmul_rank1.launches += 1
    if transpose_a:
        matmul_rank1.launches_transposed += 1
    return C


#: launches of the CUDA kernel (never of the plain version), all and
#: those with ``transpose_a=True``
matmul_rank1.launches = 0
matmul_rank1.launches_transposed = 0
