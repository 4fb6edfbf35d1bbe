"""ContactEngine — the single owner of every product S-RSVD performs.

PyTorch counterpart of ``repro.core.contact``.  The algorithm touches
the data matrix only through products, so the shifted matrix
``X - mu 1^T`` never exists:

  (X - mu 1^T)   @ B  ==  X   @ B - u w^T   with  u = mu,   w = 1^T B
  (X - mu 1^T)^T @ B  ==  X^T @ B - u w^T   with  u = 1_n,  w = mu^T B

Both contact points reduce to one primitive — the rank-1-corrected
matmul ``op(A) @ B - u w^T`` — and backends are implementations of it:

  cuda   the wrapper of the hand-written sm_90a kernel
         (``kernels/shifted_matmul.py``): a CUDA tensor launches the
         kernel (or raises), a CPU tensor takes the plain version
  torch  the plain PyTorch composition (``kernels/ref.py``) on any
         device — the reference the kernel is held against

The default is ``cuda`` when a card is present and ``torch`` otherwise,
so the backend follows the tensors' device.  ``ContactEngine`` binds a
backend and exposes the operator-level contact points that ``srsvd``
and ``PCA`` call.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

# --------------------------------------------------------------------------
# The rank-1 shift algebra.  Every shift correction in the port is one of
# these four functions.
# --------------------------------------------------------------------------


def shift_vectors_matmat(B: torch.Tensor, mu: torch.Tensor):
    """(u, w) such that (X - mu 1^T) @ B == X @ B - u w^T."""
    return mu, B.sum(dim=0)


def shift_vectors_rmatmat(B: torch.Tensor, mu: torch.Tensor, n: int, dtype):
    """(u, w) such that (X - mu 1^T)^T @ B == X^T @ B - u w^T."""
    return torch.ones((n,), dtype=dtype, device=B.device), mu @ B


def rank1_correct(P: torch.Tensor, u: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``P - u w^T`` — the only place the shift outer product is spelled
    outside the fused primitive.  Operands are cast to their promoted
    result dtype first (an integer operator's ``u = 1_n`` meets a float
    ``w``)."""
    P, u, w = _upcast_correction(P, u, w)
    return P - u[:, None] * w[None, :]


def rank1_restore(P: torch.Tensor, u: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``P + u w^T`` — the inverse correction."""
    P, u, w = _upcast_correction(P, u, w)
    return P + u[:, None] * w[None, :]


def _upcast_correction(P, u, w):
    dt = result_dtype(P.dtype, u.dtype, w.dtype)
    return P.to(dt), u.to(dt), w.to(dt)


def result_dtype(*dtypes) -> torch.dtype:
    """Promotion of ``dtypes`` (torch dtypes): integer with float gives
    the float, bf16 with f32 gives f32 — the same lattice points the
    JAX reference reaches for the dtypes this slice takes."""
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


# --------------------------------------------------------------------------
# Backend registry.  A backend is one function: the rank-1-corrected
# matmul primitive ``op(A) @ B - u w^T``.
# --------------------------------------------------------------------------

# (A, B, u, w, transpose_a) -> op(A) @ B - u w^T
MatmulRank1 = Callable[..., torch.Tensor]

_REGISTRY: dict[str, MatmulRank1] = {}
_ENGINES: dict[str, ContactEngine] = {}


def register_backend(name: str, matmul_rank1: MatmulRank1,
                     *, overwrite: bool = False) -> None:
    """Register a rank-1-corrected matmul implementation under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = matmul_rank1
    _ENGINES.pop(name, None)


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def default_backend() -> str:
    """``cuda`` (the hand kernel's wrapper) when a card is present,
    ``torch`` (the plain composition) otherwise."""
    return "cuda" if torch.cuda.is_available() else "torch"


def resolve_backend(backend: str | None = None) -> str:
    """Registry key for ``backend`` (default: hardware-resolved); an
    unknown name raises instead of falling back."""
    if backend is None:
        return default_backend()
    if backend not in _REGISTRY:
        raise KeyError(f"unknown contact backend {backend!r}; "
                       f"registered: {available_backends()}")
    return backend


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ContactEngine:
    """All matrix contact points, bound to one backend.

    Operator-level entry points take anything satisfying the ``LinOp``
    protocol; ``mu=None`` uniformly means "unshifted".
    """

    backend: str

    @property
    def _matmul_rank1(self) -> MatmulRank1:
        return _REGISTRY[self.backend]

    # -- dense-array contact points ------------------------------------
    def matmul_rank1(self, A, B, u, w, *, transpose_a: bool = False):
        """``op(A) @ B - u w^T`` on this engine's backend."""
        return self._matmul_rank1(A, B, u, w, transpose_a=transpose_a)

    def dense_shifted_matmat(self, X, B, mu):
        """(X - mu 1^T) @ B for a dense on-device X."""
        u, w = shift_vectors_matmat(B, mu)
        return self.matmul_rank1(X, B, u, w)

    def dense_shifted_rmatmat(self, X, B, mu):
        """(X - mu 1^T)^T @ B for a dense on-device X (A^T is read
        through X's strides by the kernel, never copied)."""
        u, w = shift_vectors_rmatmat(B, mu, X.shape[1], X.dtype)
        return self.matmul_rank1(X, B, u, w, transpose_a=True)

    # -- operator-level contact points ---------------------------------
    def matmat(self, op, B):
        return op.matmat(B)

    def rmatmat(self, op, B):
        return op.rmatmat(B)

    def shifted_matmat(self, op, B, mu):
        """(X - mu 1^T) @ B through ``op``; plain ``X @ B`` when mu is
        None.  Operators exposing a dense array via ``contact_array``
        get the fused backend primitive; any other operator computes the
        product and applies the correction."""
        if mu is None:
            return op.matmat(B)
        X = getattr(op, "contact_array", None)
        if X is not None:
            return self.dense_shifted_matmat(X, B, mu)
        return rank1_correct(op.matmat(B), *shift_vectors_matmat(B, mu))

    def shifted_rmatmat(self, op, B, mu):
        """(X - mu 1^T)^T @ B through ``op``; ``X^T @ B`` when mu is None."""
        if mu is None:
            return op.rmatmat(B)
        X = getattr(op, "contact_array", None)
        if X is not None:
            return self.dense_shifted_rmatmat(X, B, mu)
        u, w = shift_vectors_rmatmat(B, mu, op.shape[1], op.dtype)
        return rank1_correct(op.rmatmat(B), u, w)

    def shifted_gram_matmat(self, op, B, mu):
        """(X - mu 1^T)(X - mu 1^T)^T @ B — the spectral schedules' Gram
        contact, composed from the two contact points above."""
        return self.shifted_matmat(op, self.shifted_rmatmat(op, B, mu), mu)

    def col_mean(self, op):
        return op.col_mean()

    def fro_norm2(self, op):
        return op.fro_norm2()

    def xbar_fro_norm2(self, op, mu):
        """``||X - mu 1^T||_F^2`` without materializing the shift:

            ||Xbar||_F^2 = ||X||_F^2 - 2 (X 1) . mu + n ||mu||^2

        — the ``fro_norm2`` probe plus one K=1 ``matmat``; the setup
        probe behind ``ResidualStop``, the posterior certificate and
        ``PCA.mse``.
        """
        f = self.fro_norm2(op)
        if mu is None:
            return f
        n = op.shape[1]
        ones = torch.ones((n, 1), dtype=op.dtype, device=op.device)
        row_sum = self.matmat(op, ones)[:, 0]
        dt = result_dtype(f.dtype, row_sum.dtype, mu.dtype)
        f, row_sum, mu = f.to(dt), row_sum.to(dt), mu.to(dt)
        return f - 2.0 * (row_sum @ mu) + n * (mu @ mu)


def get_engine(backend: str | None = None) -> ContactEngine:
    """Engine for ``backend`` (default: hardware-resolved).  Cached —
    engines are stateless beyond their registry binding."""
    name = resolve_backend(backend)
    eng = _ENGINES.get(name)
    if eng is None:
        eng = _ENGINES[name] = ContactEngine(name)
    return eng


# --------------------------------------------------------------------------
# Built-in backends
# --------------------------------------------------------------------------


def _torch_matmul_rank1(A, B, u, w, *, transpose_a: bool = False):
    from repro_torch.kernels import ref
    return ref.matmul_rank1_ref(A, B, u, w, transpose_a=transpose_a)


def _cuda_matmul_rank1(A, B, u, w, *, transpose_a: bool = False):
    from repro_torch.kernels.shifted_matmul import matmul_rank1
    return matmul_rank1(A, B, u, w, transpose_a=transpose_a)


register_backend("torch", _torch_matmul_rank1)
register_backend("cuda", _cuda_matmul_rank1)
