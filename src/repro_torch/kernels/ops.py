"""Public wrappers around the fused kernels, dispatched through the
contact-engine backend registry (:mod:`repro_torch.core.contact`):
``cuda`` (the hand kernel's wrapper; CPU tensors take its plain version)
when a card is present, ``torch`` (the plain composition) otherwise.
"""
from __future__ import annotations

from repro_torch.core import contact


def shifted_matmat(X, B, mu, *, backend: str | None = None):
    """(X - mu 1^T) @ B without materializing the shifted matrix."""
    return contact.get_engine(backend).dense_shifted_matmat(X, B, mu)


def shifted_rmatmat(X, B, mu, *, backend: str | None = None):
    """(X - mu 1^T)^T @ B without materializing the shifted matrix."""
    return contact.get_engine(backend).dense_shifted_rmatmat(X, B, mu)


def xbar_fro_norm2(X, mu, *, backend: str | None = None):
    """``||X - mu 1^T||_F^2`` without materializing the shift — the
    ``fro_norm2`` probe plus one K=1 matmat."""
    from repro_torch.core.linop import as_linop
    return contact.get_engine(backend).xbar_fro_norm2(as_linop(X), mu)


def matmul_rank1(A, B, u, w, *, transpose_a: bool = False,
                 backend: str | None = None):
    """The raw rank-1-corrected matmul primitive ``op(A) @ B - u w^T``."""
    return contact.get_engine(backend).matmul_rank1(
        A, B, u, w, transpose_a=transpose_a)
