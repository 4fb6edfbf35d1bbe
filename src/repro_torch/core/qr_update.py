"""Rank-1 thin-QR update (Golub & Van Loan, Matrix Computations §12.5).

PyTorch counterpart of ``repro.core.qr_update.qr_rank1_update``: given a
thin ``A = Q R`` (Q: m x K, R: K x K) and vectors ``u`` (m,), ``v``
(K,), compute a thin QR of ``A + u v^T`` in O(mK + K^2) — the paper's
line 6, which folds the shift ``-mu 1^T`` into the sample basis without
touching X again.

The reference drives its two Givens sweeps with ``lax.fori_loop``; here
they are host loops of 2K rotations.  ``c`` and ``s`` stay 0-dim device
tensors (no ``.item()``), so the loop never waits for the device, but
each rotation is a handful of small launches — O(K) launch overhead per
update on the card.  The rotations update ``Qe``/``Re``/``we``, fresh
tensors of this call, in place.  The ``_givens`` tiny guard and the
second Gram-Schmidt pass (CGS2) of the extension column are kept as in
the reference, for the same singular-downdate edge (DESIGN.md §16).
"""
from __future__ import annotations

import torch


def _givens(a, b):
    """(c, s) with [[c, s], [-s, c]] @ [a, b] = [r, 0]; identity when
    ``hypot(a, b)`` is below the dtype's tiny."""
    r = torch.hypot(a, b)
    safe = r > torch.finfo(a.dtype).tiny
    rs = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, a / rs, torch.ones_like(r))
    s = torch.where(safe, b / rs, torch.zeros_like(r))
    return c, s


def _rotate(Qe, Re, i, c, s):
    """Left-apply the rotation to rows (i, i+1) of Re and right-apply
    its transpose to columns (i, i+1) of Qe, in place."""
    G = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    Re[i:i + 2] = G.T @ Re[i:i + 2]
    Qe[:, i:i + 2] = Qe[:, i:i + 2] @ G


def qr_rank1_update(Q: torch.Tensor, R: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR of ``Q @ R + u v^T``.

    Returns (Q', R') with Q': m x K orthonormal, R': K x K upper
    triangular.
    """
    m, K = Q.shape
    dt = Q.dtype
    u = u.to(dt)
    v = v.to(dt)

    # u = Q w + rho q_ext, with a second Gram-Schmidt pass folded into w
    # so an in-span u leaves orthogonal (not oblique) noise behind.
    w = Q.T @ u
    r = u - Q @ w
    c2 = Q.T @ r
    r = r - Q @ c2
    w = w + c2
    rho = torch.linalg.vector_norm(r)
    q_ext = r / torch.clamp(rho, min=torch.finfo(dt).tiny)

    Qe = torch.cat([Q, q_ext[:, None]], dim=1)                 # m x (K+1)
    we = torch.cat([w, rho[None]])                             # (K+1,)
    Re = torch.cat([R, torch.zeros((1, K), dtype=dt, device=R.device)])

    # Sweep 1 (bottom-up): rotate w to ||w|| e1; R becomes Hessenberg.
    for i in range(K - 1, -1, -1):
        c, s = _givens(we[i], we[i + 1])
        wi = c * we[i] + s * we[i + 1]
        we[i] = wi
        we[i + 1] = 0
        _rotate(Qe, Re, i, c, s)

    # The rank-1 add now touches only the first row.
    Re[0] += we[0] * v

    # Sweep 2 (top-down): restore upper-triangular form.
    for i in range(K):
        c, s = _givens(Re[i, i], Re[i + 1, i])
        _rotate(Qe, Re, i, c, s)

    return Qe[:, :K], Re[:K, :]
