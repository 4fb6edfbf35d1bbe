"""Shifted Randomized SVD (Basirat 2019, Algorithm 1) and the Halko et al.
(2011) randomized SVD baseline, in PyTorch.

PyTorch counterpart of ``repro.core.srsvd``.  ``srsvd`` computes a
rank-k SVD of ``X - mu 1^T`` touching X only through products — the
shifted matrix never exists.  Every shifted contact routes through a
:class:`repro_torch.core.contact.ContactEngine`, which launches the
hand-written CUDA kernel on the card; one fit at ``q`` power iterations
launches it ``2q + 1`` times (two shifted contacts per iteration and the
final projection).

The entry point runs on ``device="cuda"`` unless the caller asks for the
CPU, and raises when no card is present.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import (contact, rangefinder as _rangefinder,
                              schedule as _schedule, stopping as _stopping)
from repro_torch.core.linop import as_linop
from repro_torch.core.schedule import ShiftSchedule
from repro_torch.core.stopping import StopRule


@dataclasses.dataclass
class SVDResult:
    U: torch.Tensor    # (m, k)
    S: torch.Tensor    # (k,)
    Vt: torch.Tensor   # (k, n)

    def reconstruct(self) -> torch.Tensor:
        return (self.U * self.S) @ self.Vt


ShiftMode = Literal["exact", "paper"]
PowerLoop = Literal["python", "fori"]


def srsvd(X, mu, k: int, K: int | None = None, q: int = 0, *,
          generator: torch.Generator, use_qr_update: bool = True,
          shift_mode: ShiftMode = "exact",
          shift: ShiftSchedule | torch.Tensor | None = None,
          stop: StopRule | int | None = None,
          loop: PowerLoop = "python",
          warm_start=None,
          engine: contact.ContactEngine | None = None,
          device="cuda"):
    """Rank-k SVD of ``X - mu 1^T`` (Algorithm 1).

    Args:
      X: (m, n) tensor, numpy array, or ``LinOp``; a dense X is moved to
        ``device`` (a ``LinOp`` must already live there).
      mu: (m,) shifting vector, or None for the unshifted algorithm.
      k: target rank.  K: sampling rank (default 2k).  q: power
        iterations.
      generator: ``torch.Generator`` on ``device`` for the Gaussian
        test matrix.
      use_qr_update: line 6 via the Givens rank-1 QR update (paper)
        instead of a QR re-factorization (same math).
      shift_mode: "exact" uses v = Omega^T 1 (the basis of the true
        shifted sample); "paper" uses v = 1_K, as printed.
      shift: a ``ShiftSchedule`` for the power iterations, or a shifting
        vector (equivalent to passing it as ``mu``).
      stop: a ``StopRule``, an int (``FixedIters``), or None.  With a
        rule the return value is ``(SVDResult, ConvergenceReport)``.
      loop: "python" or "fori" — both run the host loop here.
      warm_start: a prior ``SVDResult`` or its ``Vt`` to seed the sketch
        from (DESIGN.md §17).
      engine: contact engine (default: the hardware-resolved backend).
      device: where the factorization runs (default ``"cuda"``).
    """
    op = as_linop(X, device)
    eng = engine if engine is not None else contact.get_engine()
    m, n = op.shape
    dt = _rangefinder.work_dtype(op)
    if K is None:
        K = 2 * k
    if not (k <= K <= min(m, n)):
        raise ValueError(f"need k <= K <= min(m, n), got {k=} {K=} {m=} {n=}")
    mu, sched = _schedule.resolve_shift(mu, shift)
    if mu is not None:
        mu = torch.as_tensor(mu).to(device=op.device, dtype=dt).reshape(m)
    rule = _stopping.as_rule(stop)
    _stopping.validate_rule_schedule(rule, sched, mu is not None)

    # Phase 1 — range finding (lines 2-11).
    if warm_start is not None:
        prior_Vt = getattr(warm_start, "Vt", warm_start)
        finder = _rangefinder.WarmStartRangeFinder(
            K=K, use_qr_update=use_qr_update, shift_mode=shift_mode,
            loop=loop, prior_Vt=torch.as_tensor(prior_Vt))
    else:
        finder = _rangefinder.FixedRangeFinder(
            K=K, use_qr_update=use_qr_update, shift_mode=shift_mode,
            loop=loop)
    Q, growth = finder.find(eng, op, mu, sched, rule, generator=generator,
                            k=k, q=q)

    # Phase 2 — line 12 / Eq. 10:  Y = ((Xbar)^T Q)^T, then lines 13-14.
    Y = eng.shifted_rmatmat(op, Q, mu).T                    # (K, n)
    U1, S, Vt = torch.linalg.svd(Y, full_matrices=False)    # line 13
    U = Q @ U1                                              # line 14
    res = SVDResult(U[:, :k], S[:k], Vt[:k, :])
    if rule is None:
        return res
    return res, _stopping.build_report(rule, growth.tstate, S[:k], m,
                                       growth.qmax, growth.fro2,
                                       k_found=growth.k_found)


def rsvd(X, k: int, K: int | None = None, q: int = 0, *,
         generator: torch.Generator,
         shift: ShiftSchedule | None = None,
         stop: StopRule | int | None = None,
         engine: contact.ContactEngine | None = None, device="cuda"):
    """Halko et al. (2011) randomized SVD — ``srsvd`` with ``mu=None``."""
    return srsvd(X, None, k, K, q, generator=generator, shift=shift,
                 stop=stop, engine=engine, device=device)


def expected_error_bound(m: int, k: int, q: int, sigma_k1: float) -> float:
    """Paper Eq. 12: E||Xbar - U S V^T|| <= [1 + 4 sqrt(2m/(k-1))]^(1/(2q+1))
    * sigma_{k+1}."""
    if k <= 1:
        raise ValueError(
            "expected_error_bound needs k >= 2 (the bound divides by "
            f"k - 1), got k={k}")
    return (1.0 + 4.0 * (2.0 * m / (k - 1)) ** 0.5) ** (1.0 / (2 * q + 1)) \
        * sigma_k1
