"""The port's ``PCA`` and ``factorize`` front door against the JAX package
on the same Omega, and a JAX-fitted PCA carried across by
``repro_torch.convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.rangefinder as jrf
import repro_torch.core.rangefinder as trf
from repro.api import factorize as jax_factorize
from repro.core import PCA as JPCA
from repro.core import PVEStop as JPVEStop
from repro_torch.api import factorize
from repro_torch.convert import pca_from_numpy, svd_result_from_numpy
from repro_torch.core import PCA, PVEStop
from repro_torch.core.ref import pca_mse_ref

torch.set_num_threads(1)


def _data(seed=0, m=40, n=240):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((m, 5))
    V = rng.standard_normal((5, n))
    X = (U @ V + 4.0 + 0.1 * rng.standard_normal((m, n))).astype(np.float32)
    return X, rng


@pytest.fixture
def shared_omega(monkeypatch):
    box = {}
    monkeypatch.setattr(jrf.FixedRangeFinder, "_draw",
                        lambda self, key, n, K, dt:
                        jnp.asarray(box["omega"], dt))
    monkeypatch.setattr(trf.FixedRangeFinder, "_draw",
                        lambda self, gen, n, K, dt, device:
                        torch.from_numpy(box["omega"]).to(device, dt))

    def set_omega(omega):
        box["omega"] = omega.astype(np.float32)
    return set_omega


def _gen():
    return torch.Generator().manual_seed(0)


def test_pca_fit_transform_mse_match_jax(shared_omega):
    X, rng = _data()
    shared_omega(rng.standard_normal((X.shape[1], 10)))
    jp = JPCA(k=5, q=1).fit(jnp.asarray(X), key=jax.random.PRNGKey(0))
    tp = PCA(k=5, q=1, device="cpu").fit(torch.from_numpy(X),
                                         generator=_gen())
    np.testing.assert_allclose(tp.mean_.numpy(), np.asarray(jp.mean_),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.singular_values_.numpy(),
                               np.asarray(jp.singular_values_), rtol=1e-4)
    # components agree up to sign: compare the projectors
    Ct, Cj = tp.components_.numpy(), np.asarray(jp.components_)
    np.testing.assert_allclose(Ct.T @ Ct, Cj.T @ Cj, atol=1e-4)
    Yt, Yj = tp.transform(X).numpy(), np.asarray(jp.transform(X))
    np.testing.assert_allclose(np.abs(Yt), np.abs(Yj), rtol=1e-3,
                               atol=1e-3 * np.abs(Yj).max())
    np.testing.assert_allclose(tp.inverse_transform(tp.transform(X)).numpy(),
                               np.asarray(jp.inverse_transform(
                                   jp.transform(X))), atol=1e-3)
    np.testing.assert_allclose(float(tp.mse(X)), float(jp.mse(X)),
                               rtol=2e-3, atol=1e-3)


def test_pca_mse_identity_matches_explicit():
    X, _ = _data(1)
    p = PCA(k=5, q=1, device="cpu").fit(X, generator=_gen())
    expl = pca_mse_ref(X, p.components_.T.numpy(), p.mean_.numpy())
    np.testing.assert_allclose(float(p.mse(X)), expl, rtol=2e-3, atol=1e-3)
    Xr = p.inverse_transform(p.transform(X)).numpy()
    assert np.linalg.norm(Xr - X) / np.linalg.norm(X) < 0.03


def test_centered_beats_uncentered_on_offcenter_data():
    """The paper's central experimental claim (Fig 1, Table 1)."""
    X, _ = _data(2)
    mse_c = float(PCA(k=3, device="cpu").fit(X, generator=_gen()).mse(X))
    p_u = PCA(k=3, center=False, device="cpu").fit(X, generator=_gen())
    mse_u = pca_mse_ref(X, p_u.components_.T.numpy(), X.mean(axis=1))
    assert mse_c < mse_u


def test_pca_stop_rule_report_matches_jax(shared_omega):
    X, rng = _data(3)
    shared_omega(rng.standard_normal((X.shape[1], 10)))
    jp = JPCA(k=5, q=6, stop=JPVEStop(1e-3)).fit(
        jnp.asarray(X), key=jax.random.PRNGKey(0))
    tp = PCA(k=5, q=6, stop=PVEStop(1e-3), device="cpu").fit(
        X, generator=_gen())
    assert tp.n_iter_ == int(jp.n_iter_)
    assert tp.report_.qmax == jp.report_.qmax


@pytest.mark.parametrize("center", [True, False])
def test_factorize_certificate_matches_jax(center, shared_omega):
    """stop=None still attaches FixedIters and returns the certificate."""
    X, rng = _data(4)
    shared_omega(rng.standard_normal((X.shape[1], 10)))
    jres, jrep = jax_factorize(jnp.asarray(X), 5, K=10, q=2, center=center)
    tres, trep = factorize(X, 5, K=10, q=2, center=center, device="cpu")
    np.testing.assert_allclose(tres.S.numpy(), np.asarray(jres.S),
                               rtol=1e-4)
    assert trep.iters_run == int(jrep.iters_run) == 2
    assert trep.qmax == jrep.qmax and trep.k_found == jrep.k_found
    assert torch.isfinite(trep.posterior_rel_err)
    np.testing.assert_allclose(float(trep.xbar_fro2),
                               float(jrep.xbar_fro2), rtol=1e-4)
    np.testing.assert_allclose(float(trep.posterior_rel_err),
                               float(jrep.posterior_rel_err), atol=5e-4)


def test_factorize_seed_and_generator():
    X, _ = _data(5)
    a, _ = factorize(X, 4, q=1, seed=3, device="cpu")
    b, _ = factorize(X, 4, q=1, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.S, b.S)


def test_jax_pca_carried_across_computes_the_same(rng):
    X, _ = _data(6)
    jp = JPCA(k=4, q=1).fit(jnp.asarray(X), key=jax.random.PRNGKey(1))
    tp = pca_from_numpy(np.asarray(jp.components_),
                        np.asarray(jp.singular_values_),
                        np.asarray(jp.mean_), k=4, device="cpu")
    Xn = (X + 0.05 * rng.standard_normal(X.shape)).astype(np.float32)
    np.testing.assert_allclose(tp.transform(Xn).numpy(),
                               np.asarray(jp.transform(Xn)), rtol=1e-4,
                               atol=1e-4)
    Y = rng.standard_normal((4, 7)).astype(np.float32)
    np.testing.assert_allclose(tp.inverse_transform(Y).numpy(),
                               np.asarray(jp.inverse_transform(Y)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tp.mse(Xn)), float(jp.mse(Xn)),
                               rtol=1e-3)


def test_jax_factorization_warm_starts_the_port():
    """A JAX factorization carried across seeds the port's sketch: a
    refresh of slightly-changed data converges under PVEStop in no more
    iterations than a cold start, with a good certificate."""
    X, rng = _data(7)
    jres, _ = jax_factorize(jnp.asarray(X), 5, K=10, q=4, center=True)
    prior = svd_result_from_numpy(np.asarray(jres.U), np.asarray(jres.S),
                                  np.asarray(jres.Vt), device="cpu")
    Xn = (X + 0.01 * rng.standard_normal(X.shape)).astype(np.float32)
    stop = PVEStop(1e-4)
    _, warm = factorize(Xn, 5, K=10, q=8, center=True, stop=stop,
                        warm_start=prior, device="cpu")
    _, cold = factorize(Xn, 5, K=10, q=8, center=True, stop=stop,
                        device="cpu")
    assert warm.iters_run <= cold.iters_run
    assert float(warm.posterior_rel_err) < 0.1


def test_unported_routes_raise():
    X, _ = _data()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        PCA(tol=0.1, device="cpu").fit(X, generator=_gen())
    with pytest.raises(NotImplementedError, match="items 8 and 11"):
        PCA(k=2, device="cpu").fit(X, generator=_gen(), streamed=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        factorize(X, tol=0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        factorize(X, 2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="before fit"):
        PCA(k=2, device="cpu").transform(X)
    with pytest.raises(TypeError, match="SVDResult"):
        PCA(k=2, device="cpu").fit(X, generator=_gen(),
                                   warm_start=PCA(k=2))


def test_integer_data_fits_in_float32():
    rng = np.random.default_rng(8)
    Xi = rng.integers(0, 50, size=(16, 40)).astype(np.int32)
    p = PCA(k=4, q=1, device="cpu").fit(Xi, generator=_gen())
    assert p.components_.dtype == torch.float32
    np.testing.assert_allclose(p.mean_.numpy(), Xi.mean(axis=1), rtol=1e-6)
    pf = PCA(k=4, q=1, device="cpu").fit(Xi.astype(np.float32),
                                         generator=_gen())
    np.testing.assert_allclose(p.singular_values_.numpy(),
                               pf.singular_values_.numpy(), rtol=1e-5)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, _ = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factorize(X, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCA(k=2).fit(X, generator=_gen())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svd_result_from_numpy(np.eye(2), np.ones(2), np.eye(2))
