"""PCA on top of S-RSVD — the paper's primary application (§2, §5).

PyTorch counterpart of ``repro.core.pca`` on the fixed-k, single-device
path: ``PCA.fit`` computes the column mean through the operator
protocol and passes it to ``srsvd`` as the shifting vector, so the
centered matrix never exists.  ``PCA(tol=...)`` and
``fit(streamed=..., mesh=...)`` are still to be ported (ROADMAP Queue 1
items 9 and 11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import contact
from repro_torch.core.linop import as_linop, resolve_device
from repro_torch.core.schedule import ShiftSchedule
from repro_torch.core.srsvd import SVDResult, srsvd
from repro_torch.core.stopping import ConvergenceReport, StopRule


@dataclasses.dataclass
class PCA:
    """Principal component analysis via shifted randomized SVD.

    Attributes after ``fit``:
      components_: (k, m) rows are principal axes (left singular
        vectors^T).
      mean_: (m,) column mean used as the shifting vector.
      singular_values_: (k,).
      report_: the ``ConvergenceReport`` when a stop rule was attached
        (None otherwise).
      n_iter_: power iterations actually run (None without a rule).

    ``device`` (default ``"cuda"``) is where ``fit`` and ``transform``
    run; without a card it raises unless ``device="cpu"``.
    """

    k: int | None = None
    K: int | None = None
    q: int = 0
    tol: float | None = None
    center: bool = True
    backend: str | None = None
    shift: ShiftSchedule | None = None
    stop: StopRule | None = None
    device: str | torch.device = "cuda"
    components_: torch.Tensor | None = None
    mean_: torch.Tensor | None = None
    singular_values_: torch.Tensor | None = None
    report_: ConvergenceReport | None = None
    n_iter_: int | None = None

    @property
    def _engine(self) -> contact.ContactEngine:
        return contact.get_engine(self.backend)

    def _check_fitted(self, method: str) -> None:
        if self.components_ is None or self.mean_ is None:
            raise ValueError(
                f"PCA.{method} called before fit: this PCA(k={self.k}) "
                "has no fitted components yet — call "
                ".fit(X, generator=torch.Generator(...)) first")

    def fit(self, X, *, generator: torch.Generator, mesh=None,
            streamed: bool = False, warm_start=None) -> PCA:
        """Fit on X.  ``warm_start`` seeds the sketch from a prior
        factorization (an ``SVDResult`` or its ``Vt``); a fitted ``PCA``
        is not accepted — it keeps only the left factors."""
        if self.tol is not None:
            raise NotImplementedError(
                "PCA(tol=...) needs the adaptive range finder, not yet "
                "ported (ROADMAP Queue 1 item 9)")
        if streamed or mesh is not None:
            raise NotImplementedError(
                "PCA.fit(streamed=..., mesh=...) needs the distributed "
                "drivers, not yet ported (ROADMAP Queue 1 items 8 and 11)")
        if self.k is None:
            raise ValueError("pass PCA(k=...) (the fixed component count)")
        if isinstance(warm_start, PCA):
            raise TypeError(
                "pass the prior factorization's SVDResult (or its Vt) "
                "as warm_start — a fitted PCA keeps only the left "
                "factors U^T, which span the wrong side of the sketch")
        op = as_linop(X, self.device)
        eng = self._engine
        mu = eng.col_mean(op) if self.center else None
        res: SVDResult = srsvd(op, mu, self.k, self.K, self.q,
                               generator=generator, shift=self.shift,
                               stop=self.stop, warm_start=warm_start,
                               engine=eng, device=self.device)
        if self.stop is not None:
            res, self.report_ = res
            self.n_iter_ = self.report_.iters_run
        self.components_ = res.U.T
        self.singular_values_ = res.S
        m = op.shape[0]
        self.mean_ = (mu if mu is not None
                      else torch.zeros((m,), dtype=res.U.dtype,
                                       device=op.device))
        return self

    def transform(self, X) -> torch.Tensor:
        """Project columns of X: Y = U^T (X - mu 1^T), computed implicitly."""
        self._check_fitted("transform")
        op = as_linop(X, self.device)
        return self._engine.shifted_rmatmat(
            op, self.components_.T, self.mean_).T           # (k, n)

    def inverse_transform(self, Y) -> torch.Tensor:
        self._check_fitted("inverse_transform")
        Y = torch.as_tensor(Y).to(resolve_device(self.device))
        return self.components_.T @ Y + self.mean_[:, None]

    def mse(self, X) -> torch.Tensor:
        """Mean squared L2 column reconstruction error (paper's metric):
        ``(||Xbar||_F^2 - ||U^T Xbar||_F^2) / n``, never materializing
        the centered matrix."""
        self._check_fitted("mse")
        op = as_linop(X, self.device)
        n = op.shape[1]
        xbar2 = self._engine.xbar_fro_norm2(op, self.mean_)
        Y = self.transform(op)
        return (xbar2 - torch.sum(Y * Y)) / n
