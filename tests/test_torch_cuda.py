"""The hand-written CUDA kernel against its plain version, on the card.

Every test here needs a CUDA device and skips without one (the decision
is taken in a fixture, never at import).  The file imports neither JAX
nor the ``repro`` package, so on a machine with a card and no JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import PCA
from repro_torch.kernels import shifted_matmul
from repro_torch.kernels.ref import matmul_rank1_ref

torch.set_num_threads(1)

#: relative to max |plain|: f32 sums of thousands of terms in another
#: order, bf16's 8-bit mantissa on the rounded output, f64 roundoff
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(gen, m, n, K, dtype, transpose_a):
    shape = (n, m) if transpose_a else (m, n)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in (shape, (n, K), (m,), (K,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("m,n,K", [(1000, 3001, 17), (65, 129, 1),
                                   (64, 64, 64), (300, 8, 130)])
def test_kernel_matches_plain_version(m, n, K, dtype, transpose_a, cuda):
    A, B, u, w = _operands(cuda, m, n, K, dtype, transpose_a)
    before = shifted_matmul.matmul_rank1.launches
    out = shifted_matmul.matmul_rank1(A, B, u, w, transpose_a=transpose_a)
    ref = matmul_rank1_ref(A, B, u, w, transpose_a=transpose_a)
    torch.cuda.synchronize()
    assert shifted_matmul.matmul_rank1.launches == before + 1
    assert out.dtype == ref.dtype and out.shape == (m, K)
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= TOL[dtype] * max(ref.double().abs().max().item(), 1.0)


def test_kernel_reads_transposed_views_and_promotes(cuda):
    A, B, u, w = _operands(cuda, 200, 333, 9, torch.float32, True)
    out = shifted_matmul.matmul_rank1(A.T, B, u, w)      # column-major A
    ref = matmul_rank1_ref(A.T, B, u, w)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-4)
    Ai = torch.randint(0, 5, (40, 50), device="cuda", dtype=torch.int32)
    Bf = torch.randn((50, 3), generator=cuda, device="cuda")
    out = shifted_matmul.matmul_rank1(Ai, Bf, torch.zeros(40, device="cuda"),
                                      torch.zeros(3, device="cuda"))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, Ai.float() @ Bf, atol=1e-4, rtol=1e-5)


def test_fit_on_card_launches_kernel_2q_plus_1_times(cuda):
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((120, 6)) @ rng.standard_normal((6, 500))
         + 2.0).astype(np.float32)
    fn = shifted_matmul.matmul_rank1
    before = fn.launches
    p = PCA(k=6, K=12, q=3).fit(X, generator=cuda)
    assert fn.launches - before == 2 * 3 + 1
    cpu = PCA(k=6, K=12, q=3, device="cpu").fit(
        X, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(p.singular_values_.cpu(),
                               cpu.singular_values_, rtol=1e-4, atol=1e-4)
