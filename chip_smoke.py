#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device  — the card's name and power limit (``nvidia-smi``); exits
             non-zero without a CUDA device.
2. build   — compiles every hand-written kernel of the path from
             ``src/repro_torch/csrc`` into ``build/kernels/`` (one
             ``nvcc`` per source, all started together).
3. kernels — each kernel against its plain PyTorch version on the card:
             both orientations, ragged shapes, f32/bf16/f64, zero shift,
             a transposed view, and the main path's full-size shapes.
4. main    — ``PCA(k=64, K=128, q=2).fit`` and ``factorize(..., q=2,
             center=True)`` on a planted-spectrum X of 8192 x 65536 f32
             (65,536 samples of 8,192 features, 2 GiB on the card):
             the top-64 singular values must match the planted ones, the
             certificate must be finite, and each fit must launch the
             kernel exactly 2q + 1 = 5 times.  A small input is also
             held against the numpy oracle.
5. times   — kernel, plain-version and library times at the full-size
             shapes beside the bound, the rank-1 QR update, the pieces of
             a fit, and whole-fit times.
6. result  — the kernel table as one JSON line, then
             ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM data-sheet peaks (dense): FP32 outside the tensor cores, bf16
# tensor cores, FP64 outside the tensor cores; HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float64": 34e12}
PEAK_BYTES = 3.35e12

M, N, K, RANK, Q_ITERS = 8192, 65536, 128, 64, 2
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float64": 1e-10}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


# -- phase 1 -----------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — "
                         "this script needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


# -- phase 2 -----------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build(["shifted_matmul"])
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.1f} s -> {rec['path'].name}")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {time.perf_counter() - t0:.1f} s")


# -- phase 3 -----------------------------------------------------------------

def _operands(torch, gen, m, n, k, dtype, transpose_a, zero_shift=False):
    dev = "cuda"
    A = torch.randn((n, m) if transpose_a else (m, n), generator=gen,
                    device=dev).to(dtype)
    B = torch.randn((n, k), generator=gen, device=dev).to(dtype)
    u = torch.randn((m,), generator=gen, device=dev).to(dtype)
    w = torch.randn((k,), generator=gen, device=dev).to(dtype)
    if zero_shift:
        u.zero_()
        w.zero_()
    return A, B, u, w


def _compare(torch, kernel, plain, args, transpose_a, dtype_name, what):
    out = kernel(*args, transpose_a=transpose_a)
    ref = plain(*args, transpose_a=transpose_a)
    torch.cuda.synchronize()
    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{what}: kernel {out.dtype}{tuple(out.shape)} vs plain "
          f"{ref.dtype}{tuple(ref.shape)}")
    err = (out.double() - ref.double()).abs().max().item()
    scale = max(ref.double().abs().max().item(), 1.0)
    tol = TOL[dtype_name] * scale
    log(f"[kernels] {what}: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(math.isfinite(err) and err <= tol, f"{what}: {err} > {tol}")
    return err


def phase_kernels(torch, X):
    from repro_torch.kernels import ref, shifted_matmul
    kernel, plain = shifted_matmul.matmul_rank1, ref.matmul_rank1_ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float64": torch.float64}
    for (m, n, k) in [(1000, 3001, 17), (65, 129, 1), (256, 4096, 128)]:
        for dname, dt in dtypes.items():
            for ta in (False, True):
                args = _operands(torch, gen, m, n, k, dt, ta)
                _compare(torch, kernel, plain, args, ta, dname,
                         f"{dname} ({m},{n},{k}) transpose_a={ta}")
    for ta in (False, True):          # zero shift == the plain product
        A, B, u, w = _operands(torch, gen, 1000, 3001, 17, torch.float32,
                               ta, zero_shift=True)
        out = kernel(A, B, u, w, transpose_a=ta)
        prod = (A.T if ta else A) @ B
        torch.cuda.synchronize()
        err = (out - prod).abs().max().item()
        tol = TOL["float32"] * max(prod.abs().max().item(), 1.0)
        log(f"[kernels] zero shift transpose_a={ta}: |kernel - A@B| "
            f"{err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"zero shift transpose_a={ta}: {err} > {tol}")
    # a column-major view is read through its strides, not copied
    A, B, u, w = _operands(torch, gen, 1000, 3001, 17, torch.float32, True)
    _compare(torch, kernel, plain, (A.T, B, u, w), False, "float32",
             "float32 transposed view (1000,3001,17)")
    # the main path's full-size shapes, on the main path's own X
    full = {}
    for ta in (False, True):
        B = torch.randn((M if ta else N, K), generator=gen, device="cuda")
        u = (torch.ones(N, device="cuda") if ta
             else torch.randn(M, generator=gen, device="cuda"))
        w = torch.randn(K, generator=gen, device="cuda")
        full[ta] = (X, B, u, w)
        err = _compare(torch, kernel, plain, full[ta], ta, "float32",
                       f"float32 full size X {tuple(X.shape)} "
                       f"transpose_a={ta}")
        full[ta] = full[ta] + (err,)
    return full


# -- phase 4 -----------------------------------------------------------------

def planted_matrix(torch, gen):
    """X = mu 1^T + U0 diag(s) V0^T + 0.01 * noise, with V0's columns
    orthogonal to 1, so the centered matrix's top-64 singular values are
    the planted s (up to the noise's O(1e-4) relative lift)."""
    dev = "cuda"
    s = 2000.0 * (0.05 ** (torch.arange(RANK, dtype=torch.float64) /
                           (RANK - 1)))
    U0, _ = torch.linalg.qr(torch.randn((M, RANK), generator=gen,
                                        device=dev))
    G = torch.randn((N, RANK), generator=gen, device=dev)
    V0, _ = torch.linalg.qr(G - G.mean(dim=0, keepdim=True))
    mu = 1.0 + 0.1 * torch.randn((M,), generator=gen, device=dev)
    X = torch.randn((M, N), generator=gen, device=dev)
    X.mul_(0.01)
    X.addmm_(U0 * s.to(dev, torch.float32), V0.T)
    X.add_(mu[:, None])
    del U0, G, V0
    return X, s


def check_small_against_oracle(torch):
    """A small rank-12 input on the card against the numpy oracle: the
    rank-12 factors reproduce the centered matrix."""
    import numpy as np

    from repro_torch.core import srsvd
    from repro_torch.core.ref import srsvd_ref
    rng = np.random.default_rng(0)
    Xs = (rng.standard_normal((300, 12)) @ rng.standard_normal((12, 2000))
          + 3.0).astype(np.float32)
    mu = Xs.mean(axis=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = srsvd(Xs, torch.from_numpy(mu), 12, 24, 2, generator=gen)
    _, S_ref, _ = srsvd_ref(Xs.astype(np.float64), mu, 12, 24, 2)
    S = res.S.double().cpu().numpy()
    rel = float(np.max(np.abs(S - S_ref) / S_ref))
    recon = res.reconstruct().cpu().numpy()
    target = Xs - mu[:, None]
    rerr = float(np.linalg.norm(recon - target) / np.linalg.norm(target))
    log(f"[main] small (300, 2000) on the card vs the numpy oracle: "
        f"max rel sigma err {rel:.3e}, rel recon err {rerr:.3e}")
    check(res.U.shape == (300, 12) and res.Vt.shape == (12, 2000),
          "small srsvd shapes")
    check(rel <= 1e-4, f"small srsvd singular values off by {rel}")
    check(rerr <= 1e-3, f"small srsvd reconstruction off by {rerr}")


def phase_main(torch, X, s_planted):
    from repro_torch.api import factorize
    from repro_torch.core import PCA
    from repro_torch.kernels.shifted_matmul import matmul_rank1
    check_small_against_oracle(torch)
    expected = 2 * Q_ITERS + 1
    launches = {"n": 0, "t": 0}
    s_planted = s_planted.cpu()

    def check_sigmas(S, what):
        check(S.shape == (RANK,) and bool(torch.isfinite(S).all()),
              f"{what}: singular values shape/finiteness")
        rel = ((S.double().cpu() - s_planted).abs() / s_planted).max().item()
        log(f"[main] {what}: top-{RANK} sigma max rel err vs planted "
            f"{rel:.3e}")
        check(rel <= 1e-3, f"{what}: sigma rel err {rel} > 1e-3")

    for what in ("PCA.fit", "factorize"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        matmul_rank1.launches = 0
        matmul_rank1.launches_transposed = 0
        t0 = time.perf_counter()
        if what == "PCA.fit":
            p = PCA(k=RANK, K=K, q=Q_ITERS).fit(X, generator=gen)
            S = p.singular_values_
            torch.cuda.synchronize()
            check(p.components_.shape == (RANK, M), "PCA components_ shape")
        else:
            res, rep = factorize(X, RANK, K=K, q=Q_ITERS, center=True,
                                 generator=gen)
            S = res.S
            torch.cuda.synchronize()
            post = rep.posterior_rel_err.item()
            log(f"[main] factorize certificate: posterior_rel_err {post:.4e}"
                f" iters_run {rep.iters_run} k_eff {rep.k_eff.item()}")
            check(math.isfinite(post), "factorize certificate not finite")
        dt = time.perf_counter() - t0
        n_all = matmul_rank1.launches
        n_t = matmul_rank1.launches_transposed
        log(f"[main] {what}: {n_all} kernel launches ({n_t} transposed) "
            f"in {dt * 1e3:.1f} ms (first call)")
        check(n_all == expected, f"{what}: {n_all} kernel launches, "
              f"expected 2q+1 = {expected}")
        launches["n"] += n_all - n_t
        launches["t"] += n_t
        check_sigmas(S, what)
    return launches


# -- phase 5 -----------------------------------------------------------------

def time_ms(torch, fn, reps=10, warmup=2):
    """Median of per-call CUDA-event times, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(torch, fn, reps=3):
    """Median host-clock time of ``fn`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(m, n, k, elem_bytes, dtype_name):
    """(ms, bound_by): the larger of each input read once and the output
    written once over HBM bandwidth, and 2mnk operations over the peak
    rate for the dtype."""
    nbytes = elem_bytes * (m * n + n * k + m + k + m * k)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(torch, smi, X, full, launches):
    from repro_torch.core import PCA
    from repro_torch.core.qr_update import qr_rank1_update
    from repro_torch.kernels import ref, shifted_matmul
    kernel, plain = shifted_matmul.matmul_rank1, ref.matmul_rank1_ref
    rows = []
    for ta in (False, True):
        A, B, u, w, err = full[ta]
        ms = time_ms(torch, lambda A=A, B=B, u=u, w=w, ta=ta:
                     kernel(A, B, u, w, transpose_a=ta))
        plain_ms = time_ms(torch, lambda A=A, B=B, u=u, w=w, ta=ta:
                           plain(A, B, u, w, transpose_a=ta))
        opA = A.T if ta else A
        lib_ms = time_ms(torch, lambda opA=opA, B=B, u=u, w=w:
                         torch.addmm(torch.outer(u, w), opA, B, beta=-1))
        m, n = opA.shape
        b_ms, b_by = bound(m, n, K, 4, "float32")
        name = "matmul_rank1" + (" (transpose_a)" if ta else "")
        log(f"[times] {smi}: {name} f32 op(A) ({m},{n}) @ ({n},{K}): "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"(addmm with the outer product) {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms by {b_by} ({b_ms / ms:.1%} of bound)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/shifted_matmul.cu",
            "replaces": "src/repro/kernels/shifted_matmul.py:109",
            "launches": launches["t" if ta else "n"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})

    gen = torch.Generator(device="cuda").manual_seed(5)
    Omega = torch.randn((N, K), generator=gen, device="cuda")
    X1 = X @ Omega
    Q1, R1 = torch.linalg.qr(X1)
    mu = X.mean(dim=1)
    v = Omega.sum(dim=0)
    Zt = torch.randn((N, K), generator=gen, device="cuda")
    Y = torch.randn((K, N), generator=gen, device="cuda")
    pieces = {
        "col_mean X.mean(1)": lambda: X.mean(dim=1),
        "sample X @ Omega (torch.matmul)": lambda: X @ Omega,
        f"qr ({M},{K})": lambda: torch.linalg.qr(X1),
        f"qr_rank1_update ({M},{K}), 2K Givens rotations":
            lambda: qr_rank1_update(Q1, R1, -mu, v),
        f"qr ({N},{K})": lambda: torch.linalg.qr(Zt),
        f"svd ({K},{N})": lambda: torch.linalg.svd(Y, full_matrices=False),
    }
    for what, fn in pieces.items():
        log(f"[times] {smi}: {what}: {host_ms(torch, fn):.3f} ms")

    def fit():
        g = torch.Generator(device="cuda").manual_seed(0)
        PCA(k=RANK, K=K, q=Q_ITERS).fit(X, generator=g)
    log(f"[times] {smi}: whole PCA(k={RANK}, K={K}, q={Q_ITERS}).fit on "
        f"({M},{N}) f32: {host_ms(torch, fit):.3f} ms (median of 3)")
    profile_fit(torch, smi, fit)
    return rows


def profile_fit(torch, smi, fit):
    """Device busy share of one fit and its heaviest device kernels, from
    ``torch.profiler`` (the profiler's own host cost inflates the wall
    time, so the busy share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels)
    log(f"[profile] {smi}: one fit under the profiler: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({busy / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} device kernels")
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    smi = phase_device(torch)
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    X, s_planted = planted_matrix(torch, gen)
    full = phase_kernels(torch, X)
    launches = phase_main(torch, X, s_planted)
    rows = phase_times(torch, smi, X, full, launches)
    check(not any(m.startswith(("jax", "repro.")) or m == "repro"
                  for m in sys.modules), "JAX or repro was imported")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
