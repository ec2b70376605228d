// Row-streamed direct conv2d + bias + optional ReLU, NHWC / HWIO, SAME
// padding, stride 1 — NullHop's MAC array on Hopper.
//
// Replaces: src/repro/kernels/conv2d/kernel.py `_conv_kernel` / `conv2d_slabs`
// (the Pallas TPU kernel, wrapper ops.py `conv2d_relu`).
//
// What bounds it on an H100: at the RoShamBo shapes (64x64x1->16 down to
// 4x4x128->128) each layer moves at most ~0.6 MB and does at most ~10 MFLOP
// per frame, so the bytes bound and the FLOP bound are both well under a
// microsecond; a launch costs more than either. At batch 32 the layers stay
// below the 67 TFLOP/s f32 rate by orders of magnitude, so the kernel is
// bounded by its own serial inner loop (K*K*Cin FMAs per output per thread)
// and by how few blocks the deep layers give the card (H*B blocks).
//
// Design: one block per (batch, output row, run of TW output columns). The
// block stages the KH input rows that window needs — the overlapping rows
// NullHop streams in, read straight from x with the padding halo masked to
// zero — into shared memory as f32, once. The TPU kernel needed ops.py to
// gather overlapping row slabs because BlockSpecs are disjoint; here the
// block computes its own offsets, so there is no gather pass. Each thread
// then owns (pixel, output channel) pairs, Cout-fastest: weight reads are
// coalesced across the warp, input reads are shared-memory broadcasts, and
// the f32 accumulator stays in a register. Bias and ReLU are fused into the
// store. A later PR can move the K*K shifted dots onto tensor cores (wgmma).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // static-launch limit, no opt-in needed

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y,
                   int H, int W, int Cin, int Cout, int KH, int KW, int TW,
                   int relu) {
  extern __shared__ float xs[];  // [KH][TW + KW - 1][Cin]
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ph = KH / 2, pw = KW / 2;
  const int sw = TW + KW - 1;

  const int n_in = KH * sw * Cin;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int ci = i % Cin;
    const int c = (i / Cin) % sw;
    const int r = i / (Cin * sw);
    const int hy = h + r - ph;
    const int wx = w0 + c - pw;
    float v = 0.f;
    if (hy >= 0 && hy < H && wx >= 0 && wx < W)
      v = to_f32(x[((static_cast<long long>(b) * H + hy) * W + wx) * Cin + ci]);
    xs[i] = v;
  }
  __syncthreads();

  const int n_out = TW * Cout;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int co = o % Cout;
    const int p = o / Cout;
    if (w0 + p >= W) continue;
    float acc = 0.f;
    for (int dy = 0; dy < KH; ++dy) {
      for (int dx = 0; dx < KW; ++dx) {
        const float* xrow = xs + (dy * sw + p + dx) * Cin;
        const T* wrow = w + static_cast<long long>((dy * KW + dx) * Cin) * Cout + co;
        for (int ci = 0; ci < Cin; ++ci)
          acc = fmaf(xrow[ci], to_f32(wrow[static_cast<long long>(ci) * Cout]), acc);
      }
    }
    acc += to_f32(bias[co]);
    if (relu) acc = fmaxf(acc, 0.f);
    from_f32(acc, &y[((static_cast<long long>(b) * H + h) * W + w0 + p) * Cout + co]);
  }
}

// Columns per block: enough (pixel, channel) pairs to keep 256 threads busy,
// no wider than the row, and a staged window under the shared-memory limit.
int tile_cols(int W, int Cin, int Cout, int KH, int KW) {
  int tw = 1024 / Cout;
  if (tw < 1) tw = 1;
  if (tw > W) tw = W;
  while (tw > 1 && KH * (tw + KW - 1) * Cin * static_cast<int>(sizeof(float)) > kSmemBytes)
    --tw;
  return tw;
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int H,
           int W, int Cin, int Cout, int KH, int KW, int relu, cudaStream_t s) {
  const int tw = tile_cols(W, Cin, Cout, KH, KW);
  const size_t smem = static_cast<size_t>(KH) * (tw + KW - 1) * Cin * sizeof(float);
  if (smem > static_cast<size_t>(kSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + tw - 1) / tw, H, B);
  conv2d_rows_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, Cin, Cout, KH, KW, tw, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int conv2d_bias_act(const void* x, const void* w, const void* b,
                               void* y, int B, int H, int W, int Cin, int Cout,
                               int KH, int KW, int relu, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, b, y, B, H, W, Cin, Cout, KH, KW, relu, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, y, B, H, W, Cin, Cout, KH, KW, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
