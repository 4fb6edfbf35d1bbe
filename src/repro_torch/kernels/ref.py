"""Plain PyTorch versions of the hand-written kernels.

``matmul_rank1_ref`` is the ``torch`` backend body of the contact-engine
registry (:mod:`repro_torch.core.contact`), the version the kernel
wrapper runs for CPU tensors, and the reference the CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import torch


def matmul_rank1_ref(A, B, u, w, *, transpose_a: bool = False):
    """``op(A) @ B - u w^T``, plain PyTorch.

    Operands are cast to the promoted result dtype (as the reference and
    the kernel do), the product and the rank-1 term are formed in the
    accumulator dtype, and the result is rounded to the result dtype
    once — the arithmetic of the kernel's epilogue, in another order.
    """
    from repro_torch.core.contact import result_dtype
    out = result_dtype(A.dtype, B.dtype)
    acc = torch.float64 if out == torch.float64 else torch.float32
    a = A.T if transpose_a else A
    P = a.to(out).to(acc) @ B.to(out).to(acc)
    corr = u.to(out).to(acc)[:, None] * w.to(out).to(acc)[None, :]
    return (P - corr).to(out)
