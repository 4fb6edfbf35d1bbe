"""Carry a factorization or a fitted PCA across from the JAX package.

Both functions take plain numpy arrays (``np.asarray`` of the JAX
package's results), so this module imports neither ``jax`` nor
``repro``.  The port's ``transform``, ``inverse_transform``, ``mse`` and
``warm_start`` then compute what the JAX ones do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.linop import resolve_device
from repro_torch.core.pca import PCA
from repro_torch.core.srsvd import SVDResult


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def svd_result_from_numpy(U, S, Vt, *, device="cuda") -> SVDResult:
    """An ``SVDResult`` from ``U`` (m, k), ``S`` (k,) and ``Vt`` (k, n)."""
    device = resolve_device(device)
    return SVDResult(_tensor(U, device), _tensor(S, device),
                     _tensor(Vt, device))


def pca_from_numpy(components_, singular_values_, mean_, *, k: int,
                   center: bool = True, device="cuda") -> PCA:
    """A fitted ``PCA`` from a fitted PCA's ``components_`` (k, m),
    ``singular_values_`` (k,) and ``mean_`` (m,)."""
    device = resolve_device(device)
    p = PCA(k=k, center=center, device=device)
    p.components_ = _tensor(components_, device)
    p.singular_values_ = _tensor(singular_values_, device)
    p.mean_ = _tensor(mean_, device)
    return p
