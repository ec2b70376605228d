// Implicit-GEMM conv2d + bias + optional ReLU, NHWC / HWIO, SAME padding,
// stride 1, with an optional 2x2 / stride-2 max pool and a count of the
// nonzero outputs in the epilogue — NullHop's MAC array and its output
// pipeline (pooling, zero encoding) on Hopper.
//
// Replaces: src/repro/kernels/conv2d/kernel.py `_conv_kernel` / `conv2d_slabs`
// (the Pallas TPU kernel, wrapper ops.py `conv2d_relu`), and the pool and
// zero count that followed it as launches of their own.
//
// What bounds it on an H100: at the RoShamBo shapes (64x64x1->16 down to
// 4x4x128->128) each layer moves at most ~0.6 MB and does at most ~10 MFLOP
// per frame, so the bytes bound and the FLOP bound are both under a
// microsecond. What is left is latency and occupancy: how many SMs the
// launch keeps busy and how long each block's dependent chain is. The first
// port gave a block one output row, so at batch 1 conv4 (8x8x64->128) ran
// on 8 SMs of 132 and conv5 (4x4x128->128) on 4, each thread walking 2,304
// FMAs in a row, each FMA loading its weight from L2. Latency bounds the
// layer's other steps too: a max pool and a zero count of their own cost
// three to four microseconds a launch at batch 1, for a few kilobytes, to
// read again an fmap the conv had in registers.
//
// Design: the conv is a GEMM, M = B*H*W output pixels, N = Cout, K =
// KH*KW*Cin (k = (dy*KW + dx)*Cin + ci, the HWIO order, so row k of the
// weight matrix is contiguous). A block owns a 64-pixel x 32-channel output
// tile and walks its K range in 32-wide chunks through a two-stage ring in
// shared memory: the weight tile [32 k x 32 channels] and the input tile
// [64 pixels x 32 k] gathered from x, each k decoded to (dy, dx, ci) and the
// padding halo filled with zeros. The copies are 16-byte `cp.async` (zero-
// filled where masked) where Cin and Cout are multiples of 16 bytes' worth of
// elements, and plain loads otherwise (conv1's Cin = 1). Each thread keeps a
// 2 x 4 micro-tile of f32 accumulators in registers. f32 stays on the CUDA
// cores (TF32 would miss the f32 limits); bf16 is staged as bf16 and widened
// in registers.
//
// Where the output tiles are fewer than the SMs (conv2-conv5 at batch 1),
// kernel.py's `conv_plan` cuts K into contiguous ranges of whole chunks, one
// block each (grid z): every block writes its f32 partial to a per-stream
// scratch, and the last block to reach the tile's int counter sums the
// partials in slice order, adds the bias, applies the ReLU, and re-arms the
// counter at 0 — BLOCKS's split-K scheme (streamed_matmul/csrc/matmul.cu).
// No float atomics: two calls give bitwise-equal results. A grid that fills
// the card takes one split and writes y directly, bias and ReLU in the
// epilogue. One launch a call either way.
//
// A pooled launch (template kPool) numbers M quad-major: four consecutive
// pixels are one 2x2 window of the output, so a 64-pixel tile holds 16
// whole windows, and the pixels past the last whole window (the odd last
// row or column, which the VALID pool drops) are masked and never summed.
// M, the grid and the plan stay B*H*W's, so each pixel's sum is the one an
// unpooled launch takes. In the direct epilogue the four pixels of a window
// sit in lanes 8 apart of one warp (thread rows tr .. tr + 3), and two
// shuffles take their max; in the split-K epilogue a thread sums the four
// pixels of its windows itself. Only the pooled fmap is written. Bias and
// ReLU come before the max, and the max of the rounded values is the
// rounded max, so the pooled fmap is bitwise the max pool of the unpooled
// launch's output. Where a count pointer is given, the epilogue counts the
// nonzero values it wrote, sums them over the block, and adds them to the
// count with one integer atomicAdd a block: an integer sum in any order is
// the same, so two calls give the same count.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// four consecutive elements of a shared-memory row as f32 (8- or 16-byte
// aligned: a channel group of the weight tile)
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(v[i]);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the tile kernel.py's CONV_TILE names: 64 output pixels x 32 output
// channels, K taken 32 at a time; 256 threads as a 32 x 8 grid, thread
// (tr, tc) holding pixels tr and tr + 32 and channels 4 tc .. 4 tc + 3
constexpr int kThreads = 256;
constexpr int BM = 64, BN = 32, BK = 32;
constexpr int kTM = 2, kTN = 4;
static_assert(BM == 32 * kTM && BN == 8 * kTN, "thread grid");

template <typename T>
struct Stage {
  static constexpr int kPad = 16 / sizeof(T);  // rows stay 16-byte aligned;
                                               // 4 pixel rows a warp reads
                                               // fall in distinct banks
  T a[2][BM][BK + kPad];  // gathered input, pixel-major
  T b[2][BK][BN];         // weights, k-major
};

struct Shape {
  int B, H, W, Cin, Cout, KH, KW;
  int M, K;   // B*H*W, KH*KW*Cin
  int Mv;     // the pixels summed: M, or 4*B*(H/2)*(W/2) when pooled
  int Hp, Wp; // H/2, W/2
};

// output pixel p of M as (b, h, w): row-major, or quad-major when pooled
// (p = 4 * window + 2 * dy + dx, windows row-major over [B, H/2, W/2])
template <bool kPool>
__device__ __forceinline__ void pixel(const Shape& sh, int p, int& b, int& h,
                                      int& w) {
  if (kPool) {
    const int q = p >> 2, j = p & 3, hw = sh.Hp * sh.Wp;
    const int r = q % hw;
    b = q / hw;
    h = (r / sh.Wp) * 2 + (j >> 1);
    w = (r % sh.Wp) * 2 + (j & 1);
  } else {
    const int hw = sh.H * sh.W, r = p % hw;
    b = p / hw;
    h = r / sh.W;
    w = r % sh.W;
  }
}

// stage chunk `c` (k in [c*BK, c*BK + BK)) of the block's tile into ring
// slot `st`: 16-byte cp.async where `vec_a` / `vec_b` (every 16-byte group
// lies inside one (dy, dx) / one weight row, and the base is aligned),
// element loads otherwise; masked elements (past Mv, K or Cout, or in the
// padding halo) are zeros
template <typename T, bool kPool>
__device__ __forceinline__ void load_chunk(Stage<T>& s, int st, int c,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const Shape& sh, int m0, int n0,
                                           bool vec_a, bool vec_b) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, k0 = c * BK;
  const int ph = sh.KH / 2, pw = sh.KW / 2;
  auto src_a = [&](int r, int kk, bool& valid) -> const T* {
    const int p = m0 + r;
    valid = p < sh.Mv && kk < sh.K;
    if (!valid) return x;
    const int ci = kk % sh.Cin, t = kk / sh.Cin;
    const int dx = t % sh.KW, dy = t / sh.KW;
    int b, oh, ow;
    pixel<kPool>(sh, p, b, oh, ow);
    const int hy = oh + dy - ph, wx = ow + dx - pw;
    valid = hy >= 0 && hy < sh.H && wx >= 0 && wx < sh.W;
    if (!valid) return x;
    return x + ((static_cast<long long>(b) * sh.H + hy) * sh.W + wx) * sh.Cin + ci;
  };
  // each loop's trip count is a constant, so the loads of a thread are
  // issued together; a masked element loads x[0] / w[0] and stores a zero
  if (vec_a) {
    constexpr int n = BM * (BK / V);
#pragma unroll
    for (int j = 0; j < (n + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      if (n % kThreads != 0 && i >= n) break;
      const int r = i / (BK / V), cc = (i % (BK / V)) * V;
      bool valid;
      const T* src = src_a(r, k0 + cc, valid);
      cp_async16(&s.a[st][r][cc], src, valid);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BM * BK / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / BK, cc = i % BK;
      bool valid;
      const T v = *src_a(r, k0 + cc, valid);
      s.a[st][r][cc] = valid ? v : zero<T>();
    }
  }
  if (vec_b) {
    constexpr int n = BK * (BN / V);
#pragma unroll
    for (int j = 0; j < (n + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      if (n % kThreads != 0 && i >= n) break;
      const int r = i / (BN / V), cc = (i % (BN / V)) * V;
      const int kk = k0 + r, co = n0 + cc;
      const bool valid = kk < sh.K && co < sh.Cout;
      cp_async16(&s.b[st][r][cc],
                 valid ? w + static_cast<long long>(kk) * sh.Cout + co : w, valid);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK * BN / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / BN, cc = i % BN;
      const int kk = k0 + r, co = n0 + cc;
      const bool valid = kk < sh.K && co < sh.Cout;
      const T v = w[valid ? static_cast<long long>(kk) * sh.Cout + co : 0];
      s.b[st][r][cc] = valid ? v : zero<T>();
    }
  }
}

// y[o] = v as T; nz counts the stored value where it is not zero
template <typename T>
__device__ __forceinline__ void put(float v, T* y, int& nz) {
  T o;
  from_f32(v, &o);
  *y = o;
  nz += to_f32(o) != 0.f;
}

// the block's nonzero outputs (`nz`, a thread's) added to *count: a warp
// sum, then one atomicAdd a block. Every thread of the block calls it.
__device__ __forceinline__ void add_count(int nz, int* count) {
  __shared__ int warp_nz[kThreads / 32];
  nz = __reduce_add_sync(0xffffffffu, nz);
  if ((threadIdx.x & 31) == 0) warp_nz[threadIdx.x >> 5] = nz;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_nz[i];
    if (s) atomicAdd(count, s);
  }
}

// grid (M tiles, N tiles, splits); block z takes chunks [z*per, z*per + per).
// One split: y = act(acc + bias). More: the f32 partial to part[z], and the
// last block of the tile sums part[0..splits) in slice order, then bias and
// ReLU (counters: one per output tile, 0 between launches). kPool: M is
// quad-major and y is the 2x2 max pool of the output. count (or null): the
// launch adds the number of nonzero values it wrote to *count.
template <typename T, bool kPool>
__global__ void __launch_bounds__(kThreads)
conv2d_igemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ part, int* counters, int* count,
                    Shape sh, int per, int relu, int vec_a, int vec_b) {
  __shared__ __align__(16) unsigned char raw[sizeof(Stage<T>)];
  Stage<T>& s = *reinterpret_cast<Stage<T>*>(raw);
  const int tid = threadIdx.x, tr = tid / 8, tc = tid % 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (sh.K + BK - 1) / BK;
  const int c_begin = blockIdx.z * per, c_end = min(chunks, c_begin + per);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  if (c_begin < c_end) {
    load_chunk<T, kPool>(s, 0, c_begin, x, w, sh, m0, n0, vec_a, vec_b);
    cp_async_commit();
  }
  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      load_chunk<T, kPool>(s, st ^ 1, c + 1, x, w, sh, m0, n0, vec_a, vec_b);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = to_f32(s.a[st][tr + 32 * i][kk]);
      load4(&s.b[st][kk][tc * kTN], bv);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the next chunk's prefetch overwrites this slot
  }

  const int N = sh.Cout;
  if (gridDim.z == 1) {
    int nz = 0;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int p = m0 + tr + 32 * i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int co = n0 + tc * kTN + j;
        float v = acc[i][j] + (co < N ? to_f32(bias[co]) : 0.f);
        if (relu) v = fmaxf(v, 0.f);
        if (kPool) {
          // pixel p & 3 of window p >> 2: the window's four pixels are
          // thread rows (tr & ~3) .. (tr | 3), lanes 8 apart, same channels
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if ((tr & 3) == 0 && p < sh.Mv && co < N)
            put(v, &y[static_cast<long long>(p >> 2) * N + co], nz);
        } else if (p < sh.M && co < N) {
          put(v, &y[static_cast<long long>(p) * N + co], nz);
        }
      }
    }
    if (count) add_count(nz, count);
    return;
  }

  const long long mn = static_cast<long long>(sh.M) * N;
  float* pz = part + blockIdx.z * mn;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = m0 + tr + 32 * i;
    if (p >= sh.Mv) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = n0 + tc * kTN + j;
      if (co < N) pz[static_cast<long long>(p) * N + co] = acc[i][j];
    }
  }

  // split-K epilogue: the last block to arrive sums the tile's partials in
  // slice order. A thread holds kOuts / kG outputs of the tile, each kG
  // pixels by one channel (kG = 4 when pooled: a window), and reads the
  // slices kZ at a time, all kOuts x kZ loads issued before the first sum
  // (clamped to valid addresses, the extra ones unused)
  constexpr int kOuts = BM * BN / kThreads, kZ = 4, kG = kPool ? 4 : 1;
  static_assert(kOuts % 4 == 0 && BM % 4 == 0, "whole windows a thread");
  __shared__ int last;
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  const int splits = gridDim.z;
  __threadfence();  // this block's partial is visible to every block
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int mt = max(0, min(BM, sh.Mv - m0)), nt = min(BN, N - n0);
  const int outs = mt / kG * nt;  // the tile's outputs
  int nz = 0;
  if (outs > 0) {
    long long off[kOuts];
    int co[kOuts];
    float v[kOuts];
#pragma unroll
    for (int q = 0; q < kOuts; ++q) {
      const int oi = min(tid + kThreads * (q / kG), outs - 1);
      co[q] = n0 + oi % nt;
      off[q] = static_cast<long long>(m0 + (oi / nt) * kG + q % kG) * N + co[q];
      v[q] = 0.f;
    }
    for (int z0 = 0; z0 < splits; z0 += kZ) {
      float pv[kZ][kOuts];
#pragma unroll
      for (int j = 0; j < kZ; ++j) {
        const float* pj = part + min(z0 + j, splits - 1) * mn;
#pragma unroll
        for (int q = 0; q < kOuts; ++q) pv[j][q] = __ldcg(pj + off[q]);
      }
#pragma unroll
      for (int j = 0; j < kZ; ++j)
#pragma unroll
        for (int q = 0; q < kOuts; ++q)
          if (z0 + j < splits) v[q] = z0 + j == 0 ? pv[j][q] : v[q] + pv[j][q];
    }
#pragma unroll
    for (int r = 0; r < kOuts / kG; ++r) {
      const int oi = tid + kThreads * r;
      if (oi >= outs) continue;
      float o = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float u = v[r * kG + g] + to_f32(bias[co[r * kG]]);
        if (relu) u = fmaxf(u, 0.f);
        o = g == 0 ? u : fmaxf(o, u);
      }
      put(o, &y[static_cast<long long>(m0 / kG + oi / nt) * N + co[r * kG]],
            nz);
    }
  }
  if (count) add_count(nz, count);
  if (tid == 0) *counter = 0;
}

template <typename T, bool kPool>
int launch(const void* x, const void* w, const void* b, void* y, float* part,
           int* counters, int* count, const Shape& sh, int splits, int per,
           int relu, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_a = sh.Cin % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_b = sh.Cout % V == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  dim3 grid((sh.M + BM - 1) / BM, (sh.Cout + BN - 1) / BN, splits);
  conv2d_igemm_kernel<T, kPool><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), part, counters, count, sh, per, relu, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, float* part,
           int* counters, int* count, const Shape& sh, int splits, int per,
           int relu, int pool, cudaStream_t s) {
  return pool ? launch<T, true>(x, w, b, y, part, counters, count, sh, splits,
                                per, relu, s)
              : launch<T, false>(x, w, b, y, part, counters, count, sh, splits,
                                 per, relu, s);
}

}  // namespace

// tile_m, tile_n, chunk: the plan's tile (kernel.py `conv_plan`), which must
// be the one compiled here (64, 32, 32); splits and per: grid z and the K
// chunks each split takes. When splits > 1, part: an f32 scratch of at least
// splits * B*H*W * Cout, and counters: one int per output tile, all 0 (the
// kernel leaves them 0 again). pool: y is the 2x2 / stride-2 VALID max pool
// of the output, [B, H/2, W/2, Cout]; else [B, H, W, Cout]. count: null, or
// one int the launch adds the number of nonzero values of y to. dtype: 0 =
// float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int conv2d_bias_act(const void* x, const void* w, const void* b,
                               void* y, void* part, void* counters,
                               void* count, int B, int H, int W, int Cin,
                               int Cout, int KH, int KW, int tile_m,
                               int tile_n, int chunk, int splits, int per,
                               int relu, int pool, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* cf = static_cast<int*>(counters);
  int* nz = static_cast<int*>(count);
  if (tile_m != BM || tile_n != BN || chunk != BK || splits < 1 ||
      splits > 65535 || per < 1 ||
      (splits > 1 && (pf == nullptr || cf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * H * W;
  const Shape sh{B, H, W, Cin, Cout, KH, KW, M, KH * KW * Cin,
                 pool ? 4 * B * (H / 2) * (W / 2) : M, H / 2, W / 2};
  if (dtype == 0)
    return launch<float>(x, w, b, y, pf, cf, nz, sh, splits, per, relu, pool, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, pf, cf, nz, sh, splits, per, relu,
                                 pool, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
