"""The port's rank-1 thin-QR update against the JAX package and the numpy
oracle ``core/ref.py::qr_rank1_update_ref``.  QR sign conventions differ
between LAPACK, XLA and the Givens sweeps, so factors are compared
through invariants: ``Q' R'``, orthonormality, triangularity and the
spanned subspace."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qr_rank1_update as jax_qr_rank1_update
from repro_torch.core import qr_rank1_update
from repro_torch.core.ref import qr_rank1_update_ref

torch.set_num_threads(1)


def _update(Q, R, u, v):
    Q2, R2 = qr_rank1_update(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (Q, R, u, v)))
    return Q2.numpy(), R2.numpy()


def _assert_thin_qr_of(Q2, R2, target, K, tol=5e-5):
    scale = max(1.0, np.abs(target).max())
    np.testing.assert_allclose(Q2 @ R2, target, atol=tol * scale)
    np.testing.assert_allclose(Q2.T @ Q2, np.eye(K), atol=tol)
    assert np.abs(np.tril(R2, -1)).max() < tol * scale


def _same_span(Qa, Qb, tol=1e-4):
    np.testing.assert_allclose(Qa @ Qa.T, Qb @ Qb.T, atol=tol)


@pytest.mark.parametrize("m,K", [(16, 4), (64, 16), (200, 16), (33, 7)])
def test_qr_rank1_update_matches_jax_and_oracle(m, K, rng):
    A = rng.standard_normal((m, K)).astype(np.float32)
    Q, R = np.linalg.qr(A)
    u = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(K).astype(np.float32)
    Q2, R2 = _update(Q, R, u, v)
    _assert_thin_qr_of(Q2, R2, A + np.outer(u, v), K, tol=2e-5)
    Qj, Rj = map(np.asarray, jax_qr_rank1_update(
        *map(jnp.asarray, (Q, R, u, v))))
    Qo, _ = qr_rank1_update_ref(Q.astype(np.float64), R, u, v)
    # the Givens sweeps are the same rotations in both packages
    np.testing.assert_allclose(Q2, Qj, atol=1e-4)
    np.testing.assert_allclose(R2, Rj, atol=1e-4 * np.abs(Rj).max())
    _same_span(Q2, Qo)


def test_qr_update_zero_vectors(rng):
    m, K = 40, 8
    A = rng.standard_normal((m, K)).astype(np.float32)
    Q, R = np.linalg.qr(A)
    Q2, R2 = _update(Q, R, np.zeros(m, np.float32), np.zeros(K, np.float32))
    np.testing.assert_allclose(Q2 @ R2, A, atol=2e-5)


def test_qr_update_u_in_range_of_q(rng):
    """u inside range(Q): the extension column is pure cancellation
    noise; the CGS2 pass keeps the result orthonormal."""
    m, K = 30, 6
    A = rng.standard_normal((m, K)).astype(np.float32)
    Q, R = np.linalg.qr(A)
    u = (Q @ rng.standard_normal(K)).astype(np.float32)
    v = rng.standard_normal(K).astype(np.float32)
    Q2, R2 = _update(Q, R, u, v)
    np.testing.assert_allclose(Q2 @ R2, A + np.outer(u, v), atol=3e-5)
    np.testing.assert_allclose(Q2.T @ Q2, np.eye(K), atol=3e-5)


@pytest.mark.parametrize("zeros", [1, 3, 6])
def test_qr_update_exactly_singular_diagonal_R(rng, zeros):
    """Exactly-zero pivots: the ``_givens`` tiny guard passes identity
    rotations through them."""
    m, K = 40, 8
    Q, _ = np.linalg.qr(rng.standard_normal((m, K)).astype(np.float32))
    s = np.concatenate([np.linspace(9.0, 1.0, K - zeros),
                        np.zeros(zeros)]).astype(np.float32)
    R = np.diag(s)
    u = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(K).astype(np.float32)
    Q2, R2 = _update(Q, R, u, v)
    _assert_thin_qr_of(Q2, R2, Q @ R + np.outer(u, v), K)
    Qj, Rj = map(np.asarray, jax_qr_rank1_update(
        *map(jnp.asarray, (Q, R, u, v))))
    np.testing.assert_allclose(Q2 @ R2, Qj @ Rj, atol=5e-5 * 9.0)


def test_qr_downdate_to_singular(rng):
    """A downdate that zeroes the last column: no division by the
    vanishing pivot, and R' exposes the singularity."""
    m, K = 32, 5
    A = rng.standard_normal((m, K)).astype(np.float32)
    Q, R = np.linalg.qr(A)
    u = (-A[:, K - 1]).astype(np.float32)
    v = np.zeros(K, np.float32)
    v[K - 1] = 1.0
    Q2, R2 = _update(Q, R, u, v)
    _assert_thin_qr_of(Q2, R2, A + np.outer(u, v), K)
    assert np.abs(R2[:, K - 1]).max() < 5e-5 * max(1.0, np.abs(A).max())


def test_qr_update_float64(rng):
    m, K = 50, 9
    A = rng.standard_normal((m, K))
    Q, R = np.linalg.qr(A)
    u, v = rng.standard_normal(m), rng.standard_normal(K)
    Q2, R2 = _update(Q, R, u, v)
    assert Q2.dtype == np.float64
    _assert_thin_qr_of(Q2, R2, A + np.outer(u, v), K, tol=1e-12)
    Qo, _ = qr_rank1_update_ref(Q, R, u, v)
    _same_span(Q2, Qo, tol=1e-12)
