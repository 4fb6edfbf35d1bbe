"""Convergence control for the S-RSVD power iteration (DESIGN.md §12).

PyTorch counterpart of ``repro.core.stopping``:

  ``StopRule``            decides, after every power iteration, whether
                          the basis has converged — from the R factor of
                          the iteration's QR, never a new contact with X.
  ``ConvergenceReport``   returned alongside the factors: iterations
                          run, the per-component PVE trace, and the
                          posterior error certificate.

Rules: ``FixedIters`` (exactly ``q`` iterations, still recording the
trace), ``PVEStop`` (dashSVD's per-vector-error stop) and
``ResidualStop`` (the certified shifted Frobenius residual).  Under a
spectral schedule the R factor estimates ``sigma^2 - alpha``, so
``sigma_estimates`` back-corrects with ``sqrt(max(s + alpha, 0))``.

The port runs the power loop on the host for both spellings of
``loop=``: ``StopState.t`` is a Python int, every other field a device
tensor, and an early-stopping rule reads ``done`` once per iteration.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def sigma_estimates(R: torch.Tensor, alpha=None) -> torch.Tensor:
    """Descending singular-value estimates from an iteration's R factor,
    alpha back-corrected under a spectral schedule."""
    s = torch.linalg.svdvals(R)
    if alpha is None:
        return s
    return torch.sqrt(torch.clamp(s + alpha, min=0.0))


@dataclasses.dataclass
class StopState:
    """Convergence-monitor state.

    ``t`` counts completed iterations; ``prev_s`` holds the previous
    iteration's sigma estimates (zeros before the first, so no rule
    fires before two estimates); ``trace`` is the (qmax, K) PVE history,
    NaN where no iteration ran; ``fro2`` is ``||Xbar||_F^2`` when a rule
    asked for it (0 otherwise); ``mask`` selects the monitored
    components (the first min(k, K)).
    """

    t: int
    done: torch.Tensor
    prev_s: torch.Tensor
    pve: torch.Tensor
    trace: torch.Tensor
    fro2: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass
class ConvergenceReport:
    """What the power loop did, returned alongside the factors.

    Attributes: ``iters_run`` (int), ``pve_trace`` (qmax, K),
    ``sigma_estimates`` (K,), ``posterior_rel_err`` (0-dim, or None
    without a certificate), ``xbar_fro2`` (0-dim or None), ``qmax``,
    ``k_eff`` (0-dim int32: monitored components whose final PVE sits
    inside the rule's band) and ``k_found`` (the basis width used).
    """

    iters_run: int
    pve_trace: torch.Tensor
    sigma_estimates: torch.Tensor
    posterior_rel_err: torch.Tensor | None
    xbar_fro2: torch.Tensor | None
    qmax: int = 0
    k_eff: torch.Tensor | None = None
    k_found: int | None = None

    @property
    def stopped_early(self) -> bool:
        return self.iters_run < self.qmax


class StopRule:
    """Protocol: decide per iteration whether the power loop is done.

    ``qmax = rule.resolve_q(q)``; ``state = rule.init(dtype, K, qmax, k,
    fro2, device)``; per iteration ``state = rule.update(state, R,
    alpha)``, stopping when ``state.done`` — checked before the next
    iteration, so ``state.t`` is the number of iterations run.
    """

    #: False for rules that can never fire (FixedIters).
    can_stop_early = True

    def resolve_q(self, q: int) -> int:
        own = getattr(self, "qmax", None)
        return q if own is None else own

    @property
    def needs_fro2(self) -> bool:
        return self.certificate

    def init(self, dtype, K: int, qmax: int, k: int, fro2=None,
             device=None) -> StopState:
        own_k = getattr(self, "k", None)
        kmon = min(k if own_k is None else own_k, K)
        return StopState(
            t=0,
            done=torch.zeros((), dtype=torch.bool, device=device),
            prev_s=torch.zeros((K,), dtype=dtype, device=device),
            pve=torch.full((K,), math.inf, dtype=dtype, device=device),
            trace=torch.full((max(qmax, 0), K), math.nan, dtype=dtype,
                             device=device),
            fro2=(torch.zeros((), dtype=dtype, device=device) if fro2 is None
                  else torch.as_tensor(fro2, dtype=dtype, device=device)),
            mask=torch.arange(K, device=device) < kmon)

    def update(self, state: StopState, R: torch.Tensor,
               alpha=None) -> StopState:
        """Advance the monitor with this iteration's R factor (O(K^3),
        never a contact with X)."""
        s = sigma_estimates(R, alpha)
        denom = torch.clamp(s[0], min=torch.finfo(s.dtype).tiny)
        pve = torch.abs(s - state.prev_s) / denom
        trace = state.trace
        if trace.shape[0]:
            trace = trace.clone()
            trace[state.t] = pve
        done = state.done | self.decide(s, pve, state)
        return StopState(t=state.t + 1, done=done, prev_s=s, pve=pve,
                         trace=trace, fro2=state.fro2, mask=state.mask)

    def decide(self, s, pve, state) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=s.device)

    @property
    def k_eff_band(self) -> float:
        band = getattr(self, "tol", None)
        return 1e-2 if band is None else float(band)


@dataclasses.dataclass(frozen=True)
class FixedIters(StopRule):
    """Run exactly ``q`` iterations (``q=None`` takes the call's ``q``);
    the factors are those of the unruled path, plus the report."""

    q: int | None = None
    certificate: bool = True
    can_stop_early = False

    def resolve_q(self, q: int) -> int:
        return q if self.q is None else self.q


@dataclasses.dataclass(frozen=True)
class PVEStop(StopRule):
    """dashSVD per-vector-error early stopping (Feng et al. §4): stop once
    ``max_{i < k} |s_i^(t) - s_i^(t-1)| / s_1^(t) <= tol``."""

    tol: float = 1e-2
    qmax: int | None = None
    k: int | None = None
    certificate: bool = True

    def __post_init__(self):
        if not (self.tol >= 0.0):
            raise ValueError(f"need tol >= 0, got {self.tol=}")

    def decide(self, s, pve, state):
        worst = torch.max(torch.where(state.mask, pve,
                                      torch.full_like(pve, -math.inf)))
        return worst <= self.tol


@dataclasses.dataclass(frozen=True)
class ResidualStop(StopRule):
    """Shifted Frobenius-residual early stopping: stop once
    ``sqrt(max(0, ||Xbar||_F^2 - sum_i s_i^2)) / ||Xbar||_F <= tol``.
    Needs ``||Xbar||_F^2`` once at setup, and every iteration under the
    target shift (``validate_rule_schedule``)."""

    tol: float = 1e-2
    qmax: int | None = None
    certificate: bool = True

    def __post_init__(self):
        if not (self.tol >= 0.0):
            raise ValueError(f"need tol >= 0, got {self.tol=}")
        if not self.certificate:
            raise ValueError(
                "ResidualStop always needs ||Xbar||_F^2 — its criterion "
                "consumes it — so certificate=False would not skip the "
                "probe; use PVEStop(certificate=False) to stop without "
                "any fro_norm2 contact")

    @property
    def needs_fro2(self) -> bool:
        return True

    def init(self, dtype, K, qmax, k, fro2=None, device=None):
        if fro2 is None:
            raise ValueError(
                "ResidualStop needs ||Xbar||_F^2 at init — drivers must "
                "compute it via engine.xbar_fro_norm2")
        return super().init(dtype, K, qmax, k, fro2, device)

    def decide(self, s, pve, state):
        fro2 = torch.clamp(state.fro2, min=torch.finfo(s.dtype).tiny)
        rel2 = torch.clamp(1.0 - torch.sum(s * s) / fro2, min=0.0)
        return rel2 <= self.tol * self.tol


def as_rule(stop) -> StopRule | None:
    """None passes through, an int becomes ``FixedIters(int)``, a rule
    is itself."""
    if stop is None or isinstance(stop, StopRule):
        return stop
    if isinstance(stop, int) and not isinstance(stop, bool):
        return FixedIters(stop)
    raise TypeError(
        f"stop must be a StopRule, an int, or None; got "
        f"{type(stop).__name__}")


def validate_certified_schedule(sched, shifted: bool, *,
                                what: str) -> None:
    """Reject schedules whose iterates break the captured-energy
    certificate: an annealed profile iterates ``X - c_t mu 1^T``, whose
    un-removed mean energy would certify garbage."""
    if not shifted or sched.runs_target_shift:
        return
    raise ValueError(
        f"{what}'s residual certificate is only valid when every "
        "iteration runs under the target shift itself; "
        f"{type(sched).__name__} anneals it (scale_at != 1), which "
        "would inflate the captured energy and certify garbage. "
        f"Use PVEStop / FixedIters with this schedule, or a "
        f"constant-scale schedule with {what}")


def validate_rule_schedule(rule: StopRule | None, sched,
                           shifted: bool) -> None:
    """Reject criterion/schedule pairings whose math does not hold."""
    if isinstance(rule, ResidualStop):
        validate_certified_schedule(sched, shifted, what="ResidualStop")


def resolve_fro2(rule: StopRule | None, eng, op, mu):
    """``||Xbar||_F^2`` when the rule needs it, None otherwise."""
    if rule is None or not rule.needs_fro2:
        return None
    try:
        return eng.xbar_fro_norm2(op, mu)
    except NotImplementedError as e:
        raise ValueError(
            f"{type(rule).__name__} needs ||Xbar||_F^2 but "
            f"{type(op).__name__} provides no fro_norm2 probe; pass "
            "certificate=False to skip the posterior certificate "
            "(PVEStop / FixedIters), or implement fro_norm2 on the "
            "operator (ResidualStop cannot run without it)") from e


def posterior_rel_err(S, fro2, m: int, K: int | None = None):
    """Certified relative Frobenius error of rank-k factors built from an
    orthonormal (m, K) basis:

        ||Xbar - U_k S_k Vt_k||_F^2 = ||Xbar||_F^2 - sum_{i<=k} S_i^2

    plus the slack ``8 eps sqrt(m K)``, which makes it an upper bound in
    floating point too."""
    if K is None:
        K = S.shape[0]
    eps = torch.finfo(S.dtype).eps
    fro2 = torch.clamp(torch.as_tensor(fro2, dtype=S.dtype, device=S.device),
                       min=torch.finfo(S.dtype).tiny)
    rel2 = torch.clamp(1.0 - torch.sum(S * S) / fro2, min=0.0)
    return torch.sqrt(rel2) + 8.0 * eps * math.sqrt(float(m * K))


def build_report(rule: StopRule, state: StopState, S, m: int,
                 qmax: int, fro2=None, *,
                 k_found: int | None = None) -> ConvergenceReport:
    """Assemble the report from the final stop state and the returned
    top-k singular values."""
    post = None if fro2 is None else posterior_rel_err(
        S, fro2, m, K=state.prev_s.shape[0])
    k_eff = torch.sum(state.mask & (state.pve <= rule.k_eff_band)) \
        .to(torch.int32)
    return ConvergenceReport(
        iters_run=state.t, pve_trace=state.trace,
        sigma_estimates=state.prev_s, posterior_rel_err=post,
        xbar_fro2=fro2, qmax=qmax, k_eff=k_eff, k_found=k_found)


def run_power_loop(sched, rule: StopRule | None, eng, op, Q, mu,
                   qmax: int, sstate, tstate, *, loop: str):
    """Drive the scheduled power loop under an optional stop rule.

    Both ``loop="python"`` and ``loop="fori"`` run this host loop (the
    reference's ``fori`` spelling is its jit form, which PyTorch does
    not need); a rule that can fire early breaks it.  Returns ``(Q,
    schedule_state, stop_state)``.
    """
    if loop not in ("python", "fori"):
        raise ValueError(f"loop must be 'python' or 'fori', got {loop!r}")
    from repro_torch.core import schedule as _schedule
    early = rule is not None and rule.can_stop_early
    for t in range(qmax):
        if early and bool(tstate.done):
            break
        a = (sched.alpha(sstate) if rule is not None and sched.spectral
             else None)
        Q, sstate, R = _schedule.power_step(sched, eng, op, Q, mu, t, sstate)
        if rule is not None:
            tstate = rule.update(tstate, R, a)
    return Q, sstate, tstate
