"""Pure-numpy oracles for the paper's algorithms.

A copy of ``repro.core.ref``, kept in the port so that it imports
nothing of the JAX package.  These are the ground-truth implementations
every path is tested against: Halko et al. (2011) randomized SVD
(Algorithm RSVD), and Basirat (2019) Shifted Randomized SVD (Algorithm
1, S-RSVD).  Written for clarity, not speed — used only in tests and
benchmarks.
"""
from __future__ import annotations

import numpy as np


def rsvd_ref(X: np.ndarray, k: int, K: int | None = None, q: int = 0,
             seed: int = 0):
    """Halko et al. randomized SVD of X, rank-k, oversampled to K."""
    m, n = X.shape
    K = 2 * k if K is None else K
    rng = np.random.default_rng(seed)
    omega = rng.standard_normal((n, K))
    Q, _ = np.linalg.qr(X @ omega)
    for _ in range(q):
        Qp, _ = np.linalg.qr(X.T @ Q)
        Q, _ = np.linalg.qr(X @ Qp)
    Y = Q.T @ X
    U1, S, Vt = np.linalg.svd(Y, full_matrices=False)
    U = Q @ U1
    return U[:, :k], S[:k], Vt[:k, :]


def srsvd_ref(X: np.ndarray, mu: np.ndarray, k: int, K: int | None = None,
              q: int = 0, seed: int = 0):
    """Basirat (2019) Algorithm 1: rank-k SVD of X - mu 1^T, implicitly.

    Every contact with X is a plain product; the shifted matrix is never
    formed.  The basis update after QR(X @ omega) is done with an exact
    re-factorization here (the oracle is about *math*, not the QR-update's
    flop count): QR of (Q1 R1 - mu 1^T) restricted to the sample columns.
    """
    m, n = X.shape
    K = 2 * k if K is None else K
    mu = np.asarray(mu).reshape(m)
    rng = np.random.default_rng(seed)
    omega = rng.standard_normal((n, K))
    X1 = X @ omega                                    # line 3
    Q1, R1 = np.linalg.qr(X1)                         # line 4
    if np.any(mu != 0):                               # line 5
        # line 6: QR-update of Q1 R1 - mu (1^T omega);  note the sample
        # matrix of X-bar is (X - mu 1^T) omega = X1 - mu (1^T omega).
        shifted_sample = Q1 @ R1 - np.outer(mu, omega.sum(axis=0))
        Q, _ = np.linalg.qr(shifted_sample)
    else:
        Q = Q1
    for _ in range(q):                                # lines 8-11
        Zt = X.T @ Q - np.outer(np.ones(n), mu @ Q)   # line 9 (Eq. 7)
        Qp, _ = np.linalg.qr(Zt)
        Z = X @ Qp - np.outer(mu, Qp.sum(axis=0))     # line 10 (Eq. 8)
        Q, _ = np.linalg.qr(Z)
    Y = Q.T @ X - np.outer(Q.T @ mu, np.ones(n))      # line 12 (Eq. 10)
    U1, S, Vt = np.linalg.svd(Y, full_matrices=False) # line 13
    U = Q @ U1                                        # line 14
    return U[:, :k], S[:k], Vt[:k, :]


def pca_mse_ref(X: np.ndarray, U: np.ndarray, mu: np.ndarray | None = None
                ) -> float:
    """Mean squared L2 reconstruction error of columns of X projected onto
    the subspace spanned by the columns of U (paper's MSE metric)."""
    m, n = X.shape
    if mu is None:
        mu = np.zeros(m)
    Xb = X - mu[:, None]
    R = Xb - U @ (U.T @ Xb)
    return float(np.mean(np.sum(R * R, axis=0)))


def qr_rank1_update_ref(Q: np.ndarray, R: np.ndarray, u: np.ndarray,
                        v: np.ndarray):
    """Oracle for the Golub & Van Loan rank-1 QR update: QR of Q@R + u v^T,
    thin form.  Direct re-factorization (exact)."""
    A = Q @ R + np.outer(u, v)
    return np.linalg.qr(A)
