"""Shift schedules for the S-RSVD power iteration (DESIGN.md §9).

PyTorch counterpart of ``repro.core.schedule``.  A ``ShiftSchedule``
decides, for every power iteration ``t``, which shift the iteration runs
under, through the hooks ``init(dtype, device)``, ``scale_at(t)``,
``shift_at(mu, t)``, ``spectral``, ``alpha(state)`` and
``update(state, R)``:

  rank-1 shift   ``X - mu_t 1^T``      — the paper's implicit centering
  spectral shift ``Xbar Xbar^T - a I`` — dashSVD's damping (Feng et al.,
                                         arXiv:2404.09276), applied
                                         outside the contact points

The port's power loop is a host loop, so ``t`` is always a Python int.
"""
from __future__ import annotations

import dataclasses

import torch


class ShiftSchedule:
    """Base schedule: the constant (paper) shift profile."""

    #: whether this schedule carries a spectral (Gram) shift alpha.
    #: (deliberately un-annotated: dataclass subclasses must not pick
    #: this up as a constructor field)
    spectral = False

    def init(self, dtype, device=None):
        """Initial loop-carried state (empty for stateless schedules)."""
        return ()

    def scale_at(self, t: int):
        """Multiplier ``c_t`` on the rank-1 shifting vector at ``t``."""
        return 1.0

    def shift_at(self, mu, t: int):
        """``c_t * mu``; ``None`` propagates, and a multiplier of exactly
        1.0 returns ``mu`` itself (bit-for-bit the fixed path)."""
        if mu is None:
            return None
        c = self.scale_at(t)
        if c == 1.0:
            return mu
        return mu * c

    @property
    def runs_target_shift(self) -> bool:
        """Whether every iteration runs under the target ``mu`` itself."""
        return True

    def alpha(self, state):
        raise TypeError(f"{type(self).__name__} carries no spectral shift")

    def update(self, state, R):
        return state


@dataclasses.dataclass(frozen=True)
class FixedShift(ShiftSchedule):
    """The paper's constant shift: ``mu_t = mu`` for every iteration."""


@dataclasses.dataclass(frozen=True)
class DecayingShift(ShiftSchedule):
    """Annealed shift: ``mu_t = (floor + (1 - floor) gamma^t) mu``;
    ``gamma = 1`` degenerates to :class:`FixedShift` exactly."""

    gamma: float = 0.9
    floor: float = 0.75

    def __post_init__(self):
        if not (0.0 <= self.gamma <= 1.0 and 0.0 <= self.floor <= 1.0):
            raise ValueError(
                f"need 0 <= gamma, floor <= 1, got {self.gamma=} "
                f"{self.floor=}")

    @property
    def runs_target_shift(self) -> bool:
        return self.gamma == 1.0 or self.floor == 1.0

    def scale_at(self, t: int):
        if self.gamma == 1.0:
            return 1.0
        return self.floor + (1.0 - self.floor) * self.gamma ** t


@dataclasses.dataclass(frozen=True)
class DynamicShift(ShiftSchedule):
    """Per-iteration dynamic shift à la Feng et al. (dashSVD, Alg. 4):

        W_t = (Xbar Xbar^T - alpha_t I) Q_t,   Q_{t+1} R_t = qr(W_t)
        alpha_{t+1} = max(alpha_t, (sigma_min(R_t) + alpha_t) / 2)

    The state is the scalar ``alpha`` as a 0-dim device tensor.
    """

    alpha0: float = 0.0
    spectral = True

    def init(self, dtype, device=None):
        return torch.tensor(self.alpha0, dtype=dtype, device=device)

    def alpha(self, state):
        return state

    def update(self, state, R):
        smin = torch.linalg.svdvals(R)[-1]
        return torch.maximum(state, (smin + state) * 0.5)


#: one shared instance serves every fixed-shift call.
FIXED = FixedShift()


def as_schedule(shift) -> ShiftSchedule:
    """Normalize ``shift`` to a schedule: ``None`` means fixed."""
    if shift is None:
        return FIXED
    if isinstance(shift, ShiftSchedule):
        return shift
    raise TypeError(
        f"shift must be a ShiftSchedule or None, got {type(shift).__name__}"
        " (pass a shifting *vector* positionally as mu)")


def resolve_shift(mu, shift):
    """Normalize ``srsvd``'s ``(mu, shift=)`` pair to ``(mu, schedule)``:
    ``shift`` may be a schedule, a shifting vector, or None; a vector
    passed both ways raises."""
    if shift is None or isinstance(shift, ShiftSchedule):
        return mu, as_schedule(shift)
    if mu is not None:
        raise ValueError(
            "pass the shifting vector either positionally (mu) or as "
            "shift=, not both")
    return shift, FIXED


def power_step(sched: ShiftSchedule, eng, op, Q, mu, t: int, state):
    """One scheduled power iteration through engine contact points:
    the paper's two-QR body (lines 9-10 of Algorithm 1) or, for spectral
    schedules, the dashSVD single-QR Gram body — two contacts with X
    either way.  Returns ``(Q, state, R)``."""
    mu_t = sched.shift_at(mu, t)
    if sched.spectral:
        W = eng.shifted_gram_matmat(op, Q, mu_t)
        W = W - sched.alpha(state) * Q
        Q, R = torch.linalg.qr(W, mode="reduced")
    else:
        Zt = eng.shifted_rmatmat(op, Q, mu_t)
        Qp, _ = torch.linalg.qr(Zt, mode="reduced")
        Z = eng.shifted_matmat(op, Qp, mu_t)
        Q, R = torch.linalg.qr(Z, mode="reduced")
    return Q, sched.update(state, R), R
