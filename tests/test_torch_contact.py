"""The port's contact layer and kernel module against the JAX package.

The same numpy inputs (from a seed) go through the JAX Pallas kernel in
interpret mode, the JAX plain reference, and the port's plain version
``repro_torch.kernels.ref.matmul_rank1_ref`` — which is what the port's
kernel wrapper runs for CPU tensors, and what the CUDA kernel is held
against on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import contact as jcontact
from repro.core.linop import DenseOp as JDenseOp
from repro.kernels import ref as jref
from repro.kernels.shifted_matmul import matmul_rank1 as jax_matmul_rank1
from repro_torch.core import contact
from repro_torch.core.linop import DenseOp, as_linop
from repro_torch.kernels import ops, shifted_matmul
from repro_torch.kernels.ref import matmul_rank1_ref

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _x64():
    """The reference's 64-bit mode as a context manager (the spelling
    moved between jax versions)."""
    legacy = getattr(jax.experimental, "enable_x64", None)
    return legacy() if legacy is not None else jax.enable_x64(True)


def _operands(rng, m, n, K, transpose_a, dtype=np.float32):
    A = rng.standard_normal((n, m) if transpose_a else (m, n)).astype(dtype)
    B = rng.standard_normal((n, K)).astype(dtype)
    u = rng.standard_normal(m).astype(dtype)
    w = rng.standard_normal(K).astype(dtype)
    return A, B, u, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,n,K", [(64, 100, 24), (33, 70, 5), (8, 130, 1)])
@pytest.mark.parametrize("transpose_a", [False, True])
def test_matmul_rank1_ref_matches_jax_kernel(m, n, K, transpose_a, rng):
    A, B, u, w = _operands(rng, m, n, K, transpose_a)
    ours = matmul_rank1_ref(*_t(A, B, u, w), transpose_a=transpose_a)
    kern = jax_matmul_rank1(*map(jnp.asarray, (A, B, u, w)),
                            transpose_a=transpose_a, bm=16, bn=128, bk=128,
                            interpret=True)
    plain = jref.matmul_rank1_ref(*map(jnp.asarray, (A, B, u, w)),
                                  transpose_a=transpose_a)
    for other in (kern, plain):
        np.testing.assert_allclose(ours.numpy(), np.asarray(other),
                                   atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_rank1_ref_dtypes_match_jax(dtype, rng):
    m, n, K = 64, 128, 32
    A, B, u, w = _operands(rng, m, n, K, False)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    ours = matmul_rank1_ref(*[x.to(td) for x in _t(A, B, u, w)])
    theirs = jref.matmul_rank1_ref(*[jnp.asarray(x, jd) for x in
                                     (A, B, u, w)])
    assert ours.dtype == td and theirs.dtype == jd
    tol = 2e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_matmul_rank1_ref_float64(transpose_a, rng):
    """f64 sums in f64 in the port (exact to 1e-12); the reference's dot
    accumulates f64 operands in an f32 accumulator
    (``preferred_element_type``), so the two agree to f32 precision."""
    A, B, u, w = _operands(rng, 33, 65, 7, transpose_a, np.float64)
    ours = matmul_rank1_ref(*_t(A, B, u, w), transpose_a=transpose_a)
    assert ours.dtype == torch.float64
    exact = (A.T if transpose_a else A) @ B - np.outer(u, w)
    np.testing.assert_allclose(ours.numpy(), exact, atol=1e-12, rtol=1e-12)
    with _x64():
        theirs = jref.matmul_rank1_ref(*map(jnp.asarray, (A, B, u, w)),
                                       transpose_a=transpose_a)
        assert theirs.dtype == jnp.float64
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=2e-5, rtol=2e-5)


def test_matmul_rank1_zero_shift_is_plain_matmul(rng):
    A, B, _, _ = _operands(rng, 32, 64, 16, False)
    out = shifted_matmul.matmul_rank1(*_t(A, B), torch.zeros(32),
                                      torch.zeros(16))
    np.testing.assert_allclose(out.numpy(), A @ B, atol=2e-4, rtol=2e-4)


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    """A CPU tensor runs the plain version; the kernel's launch counter
    counts kernel launches only."""
    A, B, u, w = _t(*_operands(rng, 20, 30, 4, True))
    before = shifted_matmul.matmul_rank1.launches
    out = shifted_matmul.matmul_rank1(A, B, u, w, transpose_a=True)
    assert torch.equal(out, matmul_rank1_ref(A, B, u, w, transpose_a=True))
    assert shifted_matmul.matmul_rank1.launches == before


def test_kernel_launch_without_toolchain_raises(rng):
    """A request for the CUDA kernel never falls back to the plain
    version: without nvcc or a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the kernel would launch")
    A, B, u, w = _t(*_operands(rng, 8, 8, 2, False))
    with pytest.raises(RuntimeError):
        shifted_matmul._launch(A, B, u, w, False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        shifted_matmul.matmul_rank1(*[x.to("meta") for x in (A, B, u, w)])


def test_shift_algebra_matches_jax(rng):
    m, n, K = 12, 20, 5
    B = rng.standard_normal((n, K)).astype(np.float32)
    Bm = rng.standard_normal((m, K)).astype(np.float32)
    mu = rng.standard_normal(m).astype(np.float32)
    ours = contact.shift_vectors_matmat(*_t(B, mu))
    theirs = jcontact.shift_vectors_matmat(jnp.asarray(B), jnp.asarray(mu))
    ours_r = contact.shift_vectors_rmatmat(*_t(Bm, mu), n, torch.float32)
    theirs_r = jcontact.shift_vectors_rmatmat(jnp.asarray(Bm),
                                              jnp.asarray(mu), n,
                                              jnp.float32)
    for a, b in zip((*ours, *ours_r), (*theirs, *theirs_r), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    P = rng.standard_normal((m, K)).astype(np.float32)
    u, w = mu, rng.standard_normal(K).astype(np.float32)
    for ours_fn, theirs_fn in ((contact.rank1_correct,
                                jcontact.rank1_correct),
                               (contact.rank1_restore,
                                jcontact.rank1_restore)):
        np.testing.assert_allclose(
            ours_fn(*_t(P, u, w)).numpy(),
            np.asarray(theirs_fn(*map(jnp.asarray, (P, u, w)))),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pair", [("int32", "float32"),
                                  ("bfloat16", "float32"),
                                  ("float32", "float64"),
                                  ("int8", "uint8"), ("bool", "int32")])
def test_result_dtype_matches_jax(pair):
    ours = contact.result_dtype(*(getattr(torch, d) for d in pair))
    with _x64():
        theirs = jcontact.result_dtype(*(jnp.dtype(d) for d in pair))
    assert str(ours).removeprefix("torch.") == str(theirs)


@pytest.mark.parametrize("backend", ["torch", None])
def test_engine_dense_contacts_match_jax(backend, rng):
    m, n, K = 40, 72, 6
    X = rng.standard_normal((m, n)).astype(np.float32) + 2.0
    B = rng.standard_normal((n, K)).astype(np.float32)
    Bm = rng.standard_normal((m, K)).astype(np.float32)
    mu = X.mean(axis=1)
    eng = contact.get_engine(backend)
    jeng = jcontact.get_engine("interpret")
    op, jop = DenseOp(torch.from_numpy(X)), JDenseOp(jnp.asarray(X))
    cases = [
        (eng.shifted_matmat(op, *_t(B, mu)),
         jeng.shifted_matmat(jop, jnp.asarray(B), jnp.asarray(mu)),
         (X - mu[:, None]) @ B),
        (eng.shifted_rmatmat(op, *_t(Bm, mu)),
         jeng.shifted_rmatmat(jop, jnp.asarray(Bm), jnp.asarray(mu)),
         (X - mu[:, None]).T @ Bm),
        (eng.shifted_gram_matmat(op, *_t(Bm, mu)),
         jeng.shifted_gram_matmat(jop, jnp.asarray(Bm), jnp.asarray(mu)),
         (X - mu[:, None]) @ ((X - mu[:, None]).T @ Bm)),
        (eng.shifted_matmat(op, torch.from_numpy(B), None),
         jeng.shifted_matmat(jop, jnp.asarray(B), None), X @ B),
    ]
    for ours, theirs, explicit in cases:
        scale = np.abs(explicit).max()
        np.testing.assert_allclose(ours.numpy() / scale,
                                   np.asarray(theirs) / scale, atol=2e-5)
        np.testing.assert_allclose(ours.numpy() / scale, explicit / scale,
                                   atol=2e-5)
    assert ops.shifted_matmat(*_t(X, B, mu)).shape == (m, K)
    assert ops.shifted_rmatmat(*_t(X, Bm, mu)).shape == (n, K)


def test_engine_probes_match_jax(rng):
    X = (rng.standard_normal((30, 50)) + 3.0).astype(np.float32)
    mu = (X.mean(axis=1) + 0.1).astype(np.float32)
    eng, jeng = contact.get_engine("torch"), jcontact.get_engine("xla")
    op, jop = DenseOp(torch.from_numpy(X)), JDenseOp(jnp.asarray(X))
    np.testing.assert_allclose(eng.col_mean(op).numpy(),
                               np.asarray(jeng.col_mean(jop)), rtol=1e-6)
    np.testing.assert_allclose(float(eng.fro_norm2(op)),
                               float(jeng.fro_norm2(jop)), rtol=1e-5)
    ours = float(eng.xbar_fro_norm2(op, torch.from_numpy(mu)))
    theirs = float(jeng.xbar_fro_norm2(jop, jnp.asarray(mu)))
    explicit = float(((X.astype(np.float64) - mu[:, None]) ** 2).sum())
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    np.testing.assert_allclose(ours, explicit, rtol=1e-4)
    assert float(ops.xbar_fro_norm2(torch.from_numpy(X),
                                    torch.from_numpy(mu))) == ours


def test_integer_operator_contacts_promote_like_jax(rng):
    Xi = rng.integers(0, 9, size=(10, 14)).astype(np.int32)
    B = rng.standard_normal((14, 3)).astype(np.float32)
    mu = Xi.mean(axis=1).astype(np.float32)
    op, jop = as_linop(Xi), JDenseOp(jnp.asarray(Xi))
    eng, jeng = contact.get_engine("torch"), jcontact.get_engine("xla")
    ours = eng.shifted_matmat(op, *_t(B, mu))
    theirs = jeng.shifted_matmat(jop, jnp.asarray(B), jnp.asarray(mu))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(eng.col_mean(op).numpy(), mu, rtol=1e-6)


def test_backend_registry():
    assert set(contact.available_backends()) == {"cuda", "torch"}
    expected = "cuda" if torch.cuda.is_available() else "torch"
    assert contact.default_backend() == expected
    assert contact.get_engine() is contact.get_engine(expected)
    with pytest.raises(KeyError, match="unknown contact backend"):
        contact.get_engine("pallas_tpu")
    with pytest.raises(ValueError, match="already registered"):
        contact.register_backend("torch", matmul_rank1_ref)


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch.api, repro_torch.convert, "
            "repro_torch.core, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
