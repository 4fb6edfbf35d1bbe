"""Linear-operator abstraction over the data matrix X (dense slice).

PyTorch counterpart of ``repro.core.linop``.  The algorithm touches X
only through products (``X @ B``, ``X.T @ B``), a column mean and a
Frobenius norm, so every entry point accepts anything satisfying the
``LinOp`` protocol.  Shifted products are not implemented here: the
rank-1 shift algebra lives in :mod:`repro_torch.core.contact`, and
``DenseOp`` advertises its tensor through ``contact_array`` so the
engine can use the fused kernel; callers reach shifted products through
an engine (the reference's ``LinOp.shifted_*`` conveniences are not
ported).

This slice ports the dense operator; the sparse, blocked, chained and
callable operators of the reference are still to be ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.contact import result_dtype


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) needs a card and raises without one — the port
    never carries on silently on the CPU; pass ``device="cpu"`` to run
    there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


class LinOp:
    """Protocol: an (m, n) operator touched only via products."""

    shape: tuple[int, int]
    dtype: torch.dtype
    device: torch.device

    #: dense tensor for fused backend contact, or None.
    contact_array = None

    def matmat(self, B: torch.Tensor) -> torch.Tensor:    # X @ B
        raise NotImplementedError

    def rmatmat(self, B: torch.Tensor) -> torch.Tensor:   # X.T @ B
        raise NotImplementedError

    def col_mean(self) -> torch.Tensor:                   # (m,)
        raise NotImplementedError

    def fro_norm2(self) -> torch.Tensor:                  # ||X||_F^2
        raise NotImplementedError


def _float_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else result_dtype(dt, torch.float32)


@dataclasses.dataclass(frozen=True)
class DenseOp(LinOp):
    X: torch.Tensor

    @property
    def shape(self):
        return tuple(self.X.shape)

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    @property
    def contact_array(self):
        return self.X

    def matmat(self, B):
        X = self.X
        if X.dtype != B.dtype:
            # integer-operator rule: products promote, cast explicitly
            dt = result_dtype(X.dtype, B.dtype)
            return X.to(dt) @ B.to(dt)
        return X @ B

    def rmatmat(self, B):
        X = self.X
        if X.dtype != B.dtype:
            dt = result_dtype(X.dtype, B.dtype)
            return X.to(dt).T @ B.to(dt)
        return X.T @ B

    def col_mean(self):
        return self.X.mean(dim=1, dtype=_float_dtype(self.X.dtype))

    def fro_norm2(self):
        X = self.X.to(_float_dtype(self.X.dtype))
        return (X * X).sum()


def as_linop(X, device=None) -> LinOp:
    """Wrap ``X`` (a tensor, a numpy array or a ``LinOp``) as an operator.

    ``device`` places a dense ``X`` there (a copy only when it lies
    elsewhere); a ``LinOp`` is returned as it is, and must already live
    on ``device``.
    """
    if device is not None:
        device = resolve_device(device)
    if isinstance(X, LinOp):
        if device is not None and X.device.type != device.type:
            raise ValueError(f"operator lives on {X.device}, but "
                             f"device={device} was requested")
        return X
    if isinstance(X, np.ndarray):
        X = torch.from_numpy(np.ascontiguousarray(X))
    X = torch.as_tensor(X)
    return DenseOp(X if device is None else X.to(device))
