// Rank-1-corrected matmul  C = op(A) @ B - u w^T  for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/shifted_matmul.py
// (matmul_rank1 -> _kernel): every shifted contact S-RSVD makes with a
// dense X is (X - mu 1^T) @ B = X @ B - mu (1^T B) or
// (X - mu 1^T)^T @ B = X^T @ B - 1 (mu^T B).  As on the TPU, the
// accumulator tile stays on chip across the whole contraction and the
// rank-1 term is subtracted in the epilogue before the single write of
// C: no (m, K) intermediate reaches device memory.
//
// Design.  A tiled SIMT GEMM: each block owns a BM x BN output tile and
// loops over the contraction inside the block (the TPU grid's
// sequential k axis), staging BK-deep tiles of op(A) and B in shared
// memory as accumulator-type values; each of the 256 threads holds a
// TM x TN register tile of accumulators (f32 for f32 and bf16 inputs,
// f64 for f64).  The next k-tile is loaded into registers while the
// current one is consumed.  Ragged edges are masked, never padded.
// With TRANS, A is stored (Kc, M) and op(A) = A^T is read through A's
// row stride: each thread loads along A's contiguous axis, so loads
// stay coalesced and no transposed copy exists.
//
// Bound on an H100 SXM.  At the main path's f32 shapes (X 8192 x 65536,
// K = 128) one contact does 2*8192*65536*128 = 1.37e11 FLOP over 2.15 GB
// of X: 2.05 ms at the 67 TFLOP/s FP32 (non-tensor) peak against 0.64 ms
// of memory at 3.35 TB/s, so f32 is bound by the FP32 pipes.  The
// kernel uses no TF32 tensor-core math (it would break f32 parity with
// the reference), so what the design does about the bound is keep the
// FMA pipes fed: 16 FMAs per 8 shared-memory loads per k step, and two
// resident blocks per SM to hide global-load latency.  bf16 at the same
// shapes is bound by memory (1.07 GB, 0.32 ms); this kernel still runs
// it on the FP32 pipes.  wgmma, TMA and split-K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TM = 4;    // rows per thread (strided by BM / TM)
constexpr int TN = 4;    // columns per thread (strided by BN / TN)
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_LOADS = BM * BK / THREADS;       // 4
constexpr int B_LOADS = BK * BN / THREADS;       // 4
constexpr int PAD = 1;   // breaks the 16-way bank conflict of the
                         // non-transposed A tile's transposing store

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T> __device__ __forceinline__ T from_acc(
    typename Acc<T>::type x);
template <> __device__ __forceinline__ float from_acc<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ double from_acc<double>(double x) {
  return x;
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
matmul_rank1_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    const T* __restrict__ u, const T* __restrict__ w,
                    T* __restrict__ C, int64_t M, int64_t N, int64_t Kc,
                    int64_t lda, int64_t ldb, int64_t ldc) {
  using AccT = typename Acc<T>::type;
  __shared__ AccT As[BK][BM + PAD];   // As[k][i] = op(A)[row0 + i, k0 + k]
  __shared__ AccT Bs[BK][BN];         // Bs[k][j] = B[k0 + k, col0 + j]

  const int t = threadIdx.x;
  const int tx = t % (BN / TN);
  const int ty = t / (BN / TN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  AccT acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = AccT(0);

  AccT a_reg[A_LOADS];
  AccT b_reg[B_LOADS];

  // Tile coordinates of load l: consecutive threads walk the operand's
  // contiguous axis (coalesced global loads).
  auto a_coord = [&](int l, int& r, int& c) {
    const int idx = t + l * THREADS;
    if constexpr (TRANS) { r = idx % BM; c = idx / BM; }   // A is (Kc, M)
    else                 { r = idx / BK; c = idx % BK; }   // A is (M, Kc)
  };
  auto b_coord = [&](int l, int& r, int& c) {
    const int idx = t + l * THREADS;
    r = idx / BN;
    c = idx % BN;
  };

  auto load_regs = [&](int64_t k0) {
#pragma unroll
    for (int l = 0; l < A_LOADS; ++l) {
      int r, c;
      a_coord(l, r, c);
      const int64_t gi = row0 + r, gk = k0 + c;
      AccT v = AccT(0);
      if (gi < M && gk < Kc) {
        if constexpr (TRANS) v = to_acc(A[gk * lda + gi]);
        else                 v = to_acc(A[gi * lda + gk]);
      }
      a_reg[l] = v;
    }
#pragma unroll
    for (int l = 0; l < B_LOADS; ++l) {
      int r, c;
      b_coord(l, r, c);
      const int64_t gk = k0 + r, gj = col0 + c;
      AccT v = AccT(0);
      if (gk < Kc && gj < N) v = to_acc(B[gk * ldb + gj]);
      b_reg[l] = v;
    }
  };

  const int64_t nk = (Kc + BK - 1) / BK;
  if (nk > 0) load_regs(0);
  for (int64_t kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int l = 0; l < A_LOADS; ++l) {
      int r, c;
      a_coord(l, r, c);
      As[c][r] = a_reg[l];
    }
#pragma unroll
    for (int l = 0; l < B_LOADS; ++l) {
      int r, c;
      b_coord(l, r, c);
      Bs[r][c] = b_reg[l];
    }
    __syncthreads();
    if (kt + 1 < nk) load_regs((kt + 1) * BK);   // overlaps the FMAs below
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      AccT a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  // Epilogue: subtract the rank-1 term in registers, then the one store.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gi = row0 + ty + i * (BM / TM);
    if (gi >= M) continue;
    const AccT ui = to_acc(u[gi]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gj = col0 + tx + j * (BN / TN);
      if (gj < N) C[gi * ldc + gj] = from_acc<T>(acc[i][j] - ui * to_acc(w[gj]));
    }
  }
}

template <typename T>
void launch(bool trans, const void* A, const void* B, const void* u,
            const void* w, void* C, int64_t M, int64_t N, int64_t Kc,
            int64_t lda, int64_t ldb, int64_t ldc, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const T* uu = static_cast<const T*>(u);
  const T* ww = static_cast<const T*>(w);
  T* c = static_cast<T*>(C);
  if (trans)
    matmul_rank1_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        a, b, uu, ww, c, M, N, Kc, lda, ldb, ldc);
  else
    matmul_rank1_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        a, b, uu, ww, c, M, N, Kc, lda, ldb, ldc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  trans != 0 means A is
// stored (Kc, M) with row stride lda and op(A) = A^T.  Every operand has
// unit stride along its last axis.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int srsvd_matmul_rank1(int dtype, int trans, const void* A,
                                  const void* B, const void* u,
                                  const void* w, void* C, int64_t M,
                                  int64_t N, int64_t Kc, int64_t lda,
                                  int64_t ldb, int64_t ldc, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((N + BN - 1) / BN > 65535 || (M + BM - 1) / BM > 2147483647)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(trans != 0, A, B, u, w, C, M, N, Kc, lda, ldb, ldc, s);
      break;
    case 1:
      launch<__nv_bfloat16>(trans != 0, A, B, u, w, C, M, N, Kc, lda, ldb,
                            ldc, s);
      break;
    case 2:
      launch<double>(trans != 0, A, B, u, w, C, M, N, Kc, lda, ldb, ldc, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srsvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
