// Streamed matmul [M,K] @ [K,N] with an f32 accumulator, in the paper's two
// partitioning modes — the DMA policy matrix at the device-memory -> on-chip
// boundary.
//
// Replaces: src/repro/kernels/streamed_matmul/kernel.py
//   `_matmul_kernel` / `matmul_blocks`         -> matmul_blocks below
//   `_matmul_unique_kernel` / `matmul_unique`  -> matmul_unique below
// (wrapper ops.py `streamed_matmul`, which picks the mode from the policy).
//
// BLOCKS. The TPU grid walked (M/bm, N/bn, K/bk) with K sequential and an
// f32 scratch accumulator zeroed at k = 0 and flushed at the last k. Blocks
// of a CUDA grid run in parallel and in no order, so the K axis becomes a
// loop inside the block: each block owns one (BM x BN) output tile, streams
// (BM x BK) and (BK x BN) operand tiles through shared memory one K step at
// a time, and keeps the accumulator in registers (each of 256 threads owns a
// (BM/16) x (BN/16) sub-tile) until the single flush at the end. Ragged
// edges are masked, so any shape is accepted. What bounds it on an H100:
// with f32 FMAs on the CUDA cores its ceiling is the 67 TFLOP/s f32 rate,
// far below the tensor cores; at the small shapes the slice drives (the
// RoShamBo classifier head) one launch costs more than the work. Tensor-core
// tiles (wgmma) and a TMA-fed pipeline are later work.
//
// UNIQUE. The TPU version was one grid step with both whole operands
// resident in VMEM. Its counterpart here is one block with both whole
// operands resident in that block's shared memory — the largest on-chip
// residency one SM offers (232,448 bytes after opt-in). The wrapper refuses
// (ValueError) operands that do not fit, as the TPU version refused those
// over its VMEM budget. One SM does all the work, so UNIQUE is bounded by a
// single SM's FMA rate: it is the "send everything at once" policy point,
// kept for the paper's comparison, not a fast path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

constexpr int kThreads = 256;  // a 16 x 16 thread grid

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_blocks_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int M, int N, int K) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? to_f32(x[static_cast<long long>(gm) * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? to_f32(w[static_cast<long long>(gk) * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) from_f32(acc[i][j], &y[static_cast<long long>(gm) * N + gn]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
matmul_unique_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + static_cast<long long>(M) * K;
  const int mk = M * K, kn = K * N;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) xs[i] = x[i];
  for (int i = threadIdx.x; i < kn; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  for (int o = threadIdx.x; o < M * N; o += blockDim.x) {
    const int i = o / N, j = o % N;
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk)
      acc = fmaf(to_f32(xs[i * K + kk]), to_f32(ws[kk * N + j]), acc);
    from_f32(acc, &y[o]);
  }
}

template <typename T, int BM, int BN, int BK>
int launch_blocks(const void* x, const void* w, void* y, int M, int N, int K,
                  cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_blocks_kernel<T, BM, BN, BK><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_blocks(const void* x, const void* w, void* y, int M, int N, int K,
                    int tile, cudaStream_t s) {
  switch (tile) {
    case 32: return launch_blocks<T, 32, 32, 16>(x, w, y, M, N, K, s);
    case 64: return launch_blocks<T, 64, 64, 32>(x, w, y, M, N, K, s);
    case 128: return launch_blocks<T, 128, 128, 32>(x, w, y, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_unique(const void* x, const void* w, void* y, int M, int N, int K,
                  cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(M) * K + static_cast<size_t>(K) * N) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(matmul_unique_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  matmul_unique_kernel<T><<<1, 1024, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile: the square output tile edge, 32, 64 or 128 (K steps of 16, 32, 32).
// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError().
extern "C" int matmul_blocks(const void* x, const void* w, void* y, int M,
                             int N, int K, int tile, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_blocks<float>(x, w, y, M, N, K, tile, s);
  if (dtype == 1) return dispatch_blocks<__nv_bfloat16>(x, w, y, M, N, K, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int matmul_unique(const void* x, const void* w, void* y, int M,
                             int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_unique<float>(x, w, y, M, N, K, s);
  if (dtype == 1) return launch_unique<__nv_bfloat16>(x, w, y, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
