"""Range finders for the shifted randomized SVD (DESIGN.md §16).

PyTorch counterpart of the fixed-K finders of ``repro.core.rangefinder``:
a range finder builds the orthonormal basis Q of the sample space, and
``srsvd``'s shift-corrected post-process turns it into factors.

  ``FixedRangeFinder``      the paper's one-shot sketch + scheduled power
                            loop (lines 2-11 of Algorithm 1).  The draw is
                            the ``_draw`` seam, which tests replace to
                            hand both packages the same Omega.
  ``WarmStartRangeFinder``  the same body with the sketch seeded from a
                            prior factorization's ``Vt`` (DESIGN.md §17).

A ``torch.Generator`` takes the place of the reference's PRNG key; the
two never give the same numbers.  The blocked adaptive finder
(``srsvd_tol``) is still to be ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import contact, stopping as _stopping
from repro_torch.core.qr_update import qr_rank1_update


def _qr(A):
    return torch.linalg.qr(A, mode="reduced")


def warm_omega(generator: torch.Generator, n: int, K: int, dt, device,
               prior_Vt=None):
    """The (n, K) sample matrix of a possibly warm-started sketch.

    With no prior this is exactly the cold draw ``randn(n, K)``.  With a
    prior ``Vt`` (k_prior, n) the leading ``k_used = min(k_prior, K - 1)``
    columns are the prior right singular vectors and the rest are fresh
    Gaussians from the same generator (the reference draws them from
    ``fold_in(key, k_used)``); at least one fresh column is kept.
    """
    if prior_Vt is None:
        return torch.randn((n, K), generator=generator, dtype=dt,
                           device=device)
    Vp = torch.as_tensor(prior_Vt).to(device=device, dtype=dt)
    if Vp.dim() != 2 or Vp.shape[1] != n:
        raise ValueError(
            "warm_omega needs the prior as Vt rows over the operator's "
            f"n={n} columns, got shape {tuple(Vp.shape)}")
    k_used = min(int(Vp.shape[0]), max(K - 1, 0))
    fresh = torch.randn((n, K - k_used), generator=generator, dtype=dt,
                        device=device)
    if k_used == 0:
        return fresh
    return torch.cat([Vp[:k_used].T, fresh], dim=1)


def work_dtype(op) -> torch.dtype:
    """The dtype all basis/QR/SVD algebra runs in: the operator's own
    float dtype, or the float result type of an integer operator."""
    dt = op.dtype
    if not dt.is_floating_point:
        dt = contact.result_dtype(dt, torch.float32)
    return dt


@dataclasses.dataclass
class GrowthState:
    """What a range finder did, for the post-process and the report:
    ``k_found`` (basis width), ``qmax`` (the iteration ceiling), ``fro2``
    (``||Xbar||_F^2`` or None) and ``tstate`` (the stop rule's final
    state or None).  The reference's adaptive-finder fields come with
    that finder."""

    k_found: int
    qmax: int
    fro2: torch.Tensor | None
    tstate: _stopping.StopState | None


@dataclasses.dataclass(frozen=True)
class FixedRangeFinder:
    """The paper's one-shot sketch + scheduled power loop (Algorithm 1
    lines 2-11): draw a (n, K) Gaussian, one plain matmat, QR, the O(mK)
    rank-1 shift correction (Givens update or re-factorization), then the
    scheduled power loop under the optional stop rule."""

    K: int
    use_qr_update: bool = True
    shift_mode: str = "exact"
    loop: str = "python"

    def _draw(self, generator, n, K, dt, device):
        """The line-2 sample draw — the seam
        :class:`WarmStartRangeFinder` overrides."""
        return torch.randn((n, K), generator=generator, dtype=dt,
                           device=device)

    def find(self, eng, op, mu, sched, rule, *, generator, k, q):
        m, n = op.shape
        dt = work_dtype(op)
        device = op.device
        K = self.K

        omega = self._draw(generator, n, K, dt, device)          # line 2
        X1 = eng.matmat(op, omega)                                # line 3
        Q1, R1 = _qr(X1)                                          # line 4

        if mu is not None:                                        # lines 5-7
            v = (omega.sum(dim=0) if self.shift_mode == "exact"
                 else torch.ones(K, dtype=dt, device=device))
            if self.use_qr_update:
                Q, _ = qr_rank1_update(Q1, R1, -mu, v)            # line 6
            else:
                Q, _ = _qr(contact.rank1_correct(Q1 @ R1, mu, v))
        else:
            Q = Q1

        # lines 8-11 under the shift schedule and the stop rule, every
        # shifted product through the engine's fused contact points.
        qmax = q if rule is None else rule.resolve_q(q)
        state = sched.init(dt, device)
        tstate = None
        fro2 = _stopping.resolve_fro2(rule, eng, op, mu)
        if rule is not None:
            tstate = rule.init(dt, K, qmax, k, fro2, device)
        Q, _, tstate = _stopping.run_power_loop(
            sched, rule, eng, op, Q, mu, qmax, state, tstate,
            loop=self.loop)
        return Q, GrowthState(k_found=K, qmax=qmax, fro2=fro2,
                              tstate=tstate)


@dataclasses.dataclass(frozen=True, eq=False)
class WarmStartRangeFinder(FixedRangeFinder):
    """:class:`FixedRangeFinder` with omega's leading columns seeded
    from ``prior_Vt`` (see :func:`warm_omega`); ``prior_Vt=None`` is the
    cold finder, draw for draw."""

    prior_Vt: torch.Tensor | None = None

    def _draw(self, generator, n, K, dt, device):
        return warm_omega(generator, n, K, dt, device, self.prior_Vt)
