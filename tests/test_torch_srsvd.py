"""The port's dense shifted RSVD (range finder, schedules, stop rules,
``srsvd``) against the JAX package on the same Omega.

Torch cannot reproduce JAX's PRNG, so each test draws Omega once with
numpy and hands it to both packages through their ``FixedRangeFinder
._draw`` seams (``monkeypatch``; nothing in ``src/repro`` changes).
Results are compared through invariants — singular values, ``U S Vt``,
the certificate and iteration counts — never raw Q, whose signs differ
between QR implementations.  The JAX side runs ``loop="python"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.rangefinder as jrf
import repro_torch.core.rangefinder as trf
from repro.core import DecayingShift as JDecayingShift
from repro.core import DynamicShift as JDynamicShift
from repro.core import PVEStop as JPVEStop
from repro.core import ResidualStop as JResidualStop
from repro.core import contact as jcontact
from repro.core import srsvd as jax_srsvd
from repro_torch.core import (DecayingShift, DynamicShift, PVEStop,
                              ResidualStop, expected_error_bound, rsvd,
                              srsvd)
from repro_torch.core.ref import srsvd_ref
from repro_torch.core.srsvd import SVDResult

torch.set_num_threads(1)

M, N, RANK = 64, 200, 8


def _data(seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, RANK)))
    V, _ = np.linalg.qr(rng.standard_normal((n, RANK)))
    s = 40.0 * 0.6 ** np.arange(RANK)
    X = (U * s) @ V.T + 2.0 + 0.3 * rng.standard_normal((m, 1)) \
        + 0.01 * rng.standard_normal((m, n))
    return X.astype(np.float32), rng


@pytest.fixture
def shared_omega(monkeypatch):
    """Hand both packages the same Omega; returns a setter."""
    box = {}

    def jdraw(self, key, n, K, dt):
        return jnp.asarray(box["omega"], dt)

    def tdraw(self, generator, n, K, dt, device):
        return torch.from_numpy(box["omega"]).to(device=device, dtype=dt)

    monkeypatch.setattr(jrf.FixedRangeFinder, "_draw", jdraw)
    monkeypatch.setattr(trf.FixedRangeFinder, "_draw", tdraw)

    def set_omega(omega):
        box["omega"] = omega.astype(np.float32)
    return set_omega


def _both(X, mu, k, K, q, shared_omega, rng, *, jkw=None, tkw=None,
          jengine=None):
    shared_omega(rng.standard_normal((X.shape[1], K)))
    jres = jax_srsvd(jnp.asarray(X), None if mu is None else jnp.asarray(mu),
                     k, K, q, key=jax.random.PRNGKey(0), loop="python",
                     engine=jengine, **(jkw or {}))
    tres = srsvd(torch.from_numpy(X),
                 None if mu is None else torch.from_numpy(mu), k, K, q,
                 generator=torch.Generator().manual_seed(0), device="cpu",
                 **(tkw or {}))
    return jres, tres


def _assert_same_factors(jres, tres, tol=1e-4):
    S_j, S_t = np.asarray(jres.S), tres.S.numpy()
    np.testing.assert_allclose(S_t, S_j, rtol=tol)
    Rj = (np.asarray(jres.U) * S_j) @ np.asarray(jres.Vt)
    Rt = tres.reconstruct().numpy()
    assert np.linalg.norm(Rt - Rj) <= tol * np.linalg.norm(Rj)


@pytest.mark.parametrize("q", [0, 2])
@pytest.mark.parametrize("use_qr_update", [True, False])
@pytest.mark.parametrize("shift_mode", ["exact", "paper"])
def test_srsvd_matches_jax_same_omega(shift_mode, use_qr_update, q,
                                      shared_omega):
    X, rng = _data()
    mu = X.mean(axis=1)
    kw = dict(use_qr_update=use_qr_update, shift_mode=shift_mode)
    jres, tres = _both(X, mu, 6, 12, q, shared_omega, rng, jkw=kw, tkw=kw)
    _assert_same_factors(jres, tres)


def test_srsvd_matches_jax_pallas_interpret_engine(shared_omega):
    """Against the JAX package with its Pallas kernel run in interpret
    mode for every shifted contact."""
    X, rng = _data(1)
    mu = X.mean(axis=1)
    jres, tres = _both(X, mu, 6, 12, 2, shared_omega, rng,
                       jengine=jcontact.get_engine("interpret"))
    _assert_same_factors(jres, tres)


def test_rsvd_unshifted_matches_jax(shared_omega):
    X, rng = _data(2)
    jres, tres = _both(X, None, 6, 12, 1, shared_omega, rng)
    _assert_same_factors(jres, tres)
    r = rsvd(torch.from_numpy(X), 6, 12, 1,
             generator=torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_allclose(r.S.numpy(), tres.S.numpy(), rtol=1e-6)


@pytest.mark.parametrize("sched", ["decaying", "dynamic"])
def test_schedules_match_jax(sched, shared_omega):
    X, rng = _data(3)
    mu = X.mean(axis=1)
    jsched, tsched = {"decaying": (JDecayingShift(), DecayingShift()),
                      "dynamic": (JDynamicShift(), DynamicShift())}[sched]
    jres, tres = _both(X, mu, 6, 12, 2, shared_omega, rng,
                       jkw=dict(shift=jsched), tkw=dict(shift=tsched))
    _assert_same_factors(jres, tres)


@pytest.mark.parametrize("rule", ["pve", "residual", "dynamic_pve"])
def test_stop_rules_match_jax(rule, shared_omega):
    """Early stopping: equal iteration counts and certificates."""
    X, rng = _data(4)
    mu = X.mean(axis=1)
    jkw, tkw = {
        "pve": (dict(stop=JPVEStop(1e-3)), dict(stop=PVEStop(1e-3))),
        "residual": (dict(stop=JResidualStop(5e-2)),
                     dict(stop=ResidualStop(5e-2))),
        "dynamic_pve": (dict(stop=JPVEStop(1e-3), shift=JDynamicShift()),
                        dict(stop=PVEStop(1e-3), shift=DynamicShift())),
    }[rule]
    (jres, jrep), (tres, trep) = _both(X, mu, 6, 12, 8, shared_omega, rng,
                                       jkw=jkw, tkw=tkw)
    _assert_same_factors(jres, tres)
    assert trep.iters_run == int(jrep.iters_run)
    assert trep.stopped_early == bool(jrep.stopped_early)
    assert int(trep.k_eff) == int(jrep.k_eff)
    # ||Xbar||_F^2 comes from f32 sums in another order (1e-4); the
    # certificate sqrt(1 - sum S^2 / fro2) divides that by 2 * rel^2
    # (~0.005 here), so it is held at 5e-4 absolute, not relative.
    np.testing.assert_allclose(float(trep.xbar_fro2),
                               float(jrep.xbar_fro2), rtol=1e-4)
    np.testing.assert_allclose(float(trep.posterior_rel_err),
                               float(jrep.posterior_rel_err), atol=5e-4)
    np.testing.assert_allclose(trep.sigma_estimates.numpy(),
                               np.asarray(jrep.sigma_estimates), rtol=1e-4)
    jt, tt = np.asarray(jrep.pve_trace), trep.pve_trace.numpy()
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))


def test_fori_spelling_runs_the_same_loop(shared_omega):
    X, rng = _data(5)
    mu = X.mean(axis=1)
    shared_omega(rng.standard_normal((N, 12)))
    args = (torch.from_numpy(X), torch.from_numpy(mu), 6, 12, 3)
    kw = dict(generator=torch.Generator(), device="cpu", stop=PVEStop(1e-3))
    (a, ra), (b, rb) = (srsvd(*args, loop=lp, **kw)
                        for lp in ("python", "fori"))
    assert torch.equal(a.S, b.S) and ra.iters_run == rb.iters_run
    with pytest.raises(ValueError, match="loop must be"):
        srsvd(*args, loop="while", **kw)


def test_srsvd_matches_numpy_oracle_on_low_rank():
    """Exact-rank data: the sketch captures the range, so the port's
    factors match the numpy oracle's for any Omega."""
    rng = np.random.default_rng(6)
    X = (rng.standard_normal((50, 5)) @ rng.standard_normal((5, 120))
         + 1.5).astype(np.float32)
    mu = X.mean(axis=1)
    res = srsvd(torch.from_numpy(X), torch.from_numpy(mu), 5, 10, 1,
                generator=torch.Generator().manual_seed(0), device="cpu")
    _, S_ref, _ = srsvd_ref(X.astype(np.float64), mu, 5, 10, 1)
    np.testing.assert_allclose(res.S.numpy(), S_ref, rtol=1e-4)
    target = X - mu[:, None]
    err = np.linalg.norm(res.reconstruct().numpy() - target)
    assert err <= 1e-4 * np.linalg.norm(target)


def test_warm_start_leading_columns_are_prior():
    _, rng = _data(7)
    prior = SVDResult(torch.zeros(M, 3), torch.ones(3),
                      torch.from_numpy(rng.standard_normal((3, N))
                                       .astype(np.float32)))
    om = trf.warm_omega(torch.Generator().manual_seed(0), N, 10,
                        torch.float32, "cpu", prior.Vt)
    assert om.shape == (N, 10)
    assert torch.equal(om[:, :3], prior.Vt.T)
    cold = trf.warm_omega(torch.Generator().manual_seed(0), N, 10,
                          torch.float32, "cpu")
    assert torch.equal(cold, torch.randn((N, 10), generator=torch
                                         .Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="prior as Vt rows"):
        trf.warm_omega(None, N + 1, 10, torch.float32, "cpu", prior.Vt)


def test_srsvd_validates_like_jax():
    X, _ = _data()
    g = torch.Generator()
    with pytest.raises(ValueError, match="k <= K"):
        srsvd(X, None, 8, 4, generator=g, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        srsvd(X, X.mean(axis=1), 4, generator=g, device="cpu",
              shift=X.mean(axis=1))
    with pytest.raises(ValueError, match="anneals"):
        srsvd(X, X.mean(axis=1), 4, generator=g, device="cpu",
              shift=DecayingShift(), stop=ResidualStop())
    np.testing.assert_allclose(expected_error_bound(100, 5, 2, 0.5),
                               (1 + 4 * (200 / 4) ** 0.5) ** 0.2 * 0.5)
    with pytest.raises(ValueError, match="k >= 2"):
        expected_error_bound(100, 1, 2, 0.5)


def test_default_device_needs_a_card():
    """Entry points run on the card by default and never carry on
    silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, _ = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srsvd(X, None, 4, generator=torch.Generator())
