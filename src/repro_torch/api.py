"""repro_torch.api — the front door for factorization (DESIGN.md §15).

PyTorch counterpart of ``repro.api.factorize`` on its single-device
dense route: :func:`factorize` always returns ``(SVDResult,
ConvergenceReport)``, attaching a ``FixedIters`` monitor when the
caller brings no rule, so every factorization carries its posterior
error certificate.

Still to be ported (ROADMAP Queue 1): ``tol=`` (adaptive rank, item 9),
``mesh=`` (the distributed routes, item 11), sparse and blocked
operators (items 7-8), and ``factorize_batched`` / ``refresh_*`` /
``FactorizationRequest`` / ``run_request`` (items 9-10); the first two
raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import torch

from repro_torch.core import contact
from repro_torch.core.linop import as_linop, resolve_device
from repro_torch.core.schedule import ShiftSchedule, resolve_shift
from repro_torch.core.srsvd import SVDResult, srsvd
from repro_torch.core.stopping import (ConvergenceReport, FixedIters,
                                       StopRule, as_rule)

__all__ = ["factorize"]


def _warm_vt(warm_start):
    """A prior ``Vt`` (or None) from the ``(SVDResult, report)`` pair
    :func:`factorize` returns, a bare ``SVDResult``, or a raw array."""
    if isinstance(warm_start, tuple):
        warm_start = warm_start[0]
    return getattr(warm_start, "Vt", warm_start)


def factorize(x_or_op, k: int | None = None, *, K: int | None = None,
              q: int = 0, tol: float | None = None, mu=None,
              center: bool = False,
              shift: ShiftSchedule | torch.Tensor | None = None,
              stop: StopRule | int | None = None, mesh=None,
              generator: torch.Generator | None = None, seed: int = 0,
              warm_start=None,
              engine: contact.ContactEngine | None = None,
              device="cuda") -> tuple[SVDResult, ConvergenceReport]:
    """Rank-k factorization of ``X - mu 1^T``.

    Args:
      x_or_op: dense tensor, numpy array, or ``LinOp``.
      k / K / q: target rank, sampling rank (default 2k), power-
        iteration ceiling.
      mu: (m,) shifting vector, or None.  ``center=True`` computes the
        column mean through the operator instead (implicit-centering
        PCA).
      shift: a ``ShiftSchedule`` or a shifting vector.
      stop: a ``StopRule``, an int (``FixedIters``), or None — None
        attaches ``FixedIters()``, so the return value is always the
        pair and carries the posterior certificate.
      generator / seed: the Gaussian test matrix's generator; a given
        ``generator`` wins, else a generator on ``device`` seeded with
        ``seed``.
      warm_start: a prior factorization (the pair this returns, an
        ``SVDResult``, or a raw ``Vt``) to seed the sketch from.
      engine: contact engine override.
      device: where the factorization runs (default ``"cuda"``).
    """
    if tol is not None:
        raise NotImplementedError(
            "factorize(tol=...) needs the adaptive range finder, not yet "
            "ported (ROADMAP Queue 1 item 9)")
    if mesh is not None:
        raise NotImplementedError(
            "factorize(mesh=...) needs the distributed drivers, not yet "
            "ported (ROADMAP Queue 1 item 11)")
    if k is None:
        raise ValueError("pass k (the target rank)")
    if center and mu is not None:
        raise ValueError("pass either center=True or an explicit mu, "
                         "not both")
    rule = as_rule(stop)
    if rule is None:
        rule = FixedIters()
    mu, sched = resolve_shift(mu, shift)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    op = as_linop(x_or_op, device)
    eng = engine if engine is not None else contact.get_engine()
    if center and mu is None:
        mu = eng.col_mean(op)
    return srsvd(op, mu, k, K, q, generator=generator, shift=sched,
                 stop=rule, warm_start=_warm_vt(warm_start), engine=eng,
                 device=device)
