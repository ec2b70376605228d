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
// f32 scratch accumulator zeroed at k = 0 and flushed at the last k. Here
// each output tile (bm x bn) still streams its operands through shared
// memory bk at a time into an f32 accumulator in registers, and (bm, bn, bk)
// still come from the policy's block_bytes (ops.py `block_dims_for`). Blocks
// of a CUDA grid run in parallel and in no order, so the K axis is a loop
// inside the block. Ragged edges are masked, so any shape is accepted.
//
// What bounds BLOCKS on an H100: with f32 FMAs on the CUDA cores its
// ceiling is the 67 TFLOP/s f32 rate (the f32 path is held to plain f32, so
// no TF32 tensor cores; bf16 takes the same code). At the shape the slice
// drives, the RoShamBo classifier head [1, 2048] @ [2048, 4] under a 64 KiB
// policy, the tile shrinks to (32, 32, 16) and the output-tile grid is ONE
// block: the first port's kernel walked 128 K steps, two barriers each, on one SM
// while 131 waited, and 4 of its 256 threads owned an output, so latency
// alone set its 0.12 ms. The design answers both:
// - split-K: when the output-tile grid is smaller than the card's SMs (132
//   on an H100 SXM; the wrapper reads the count), kernel.py's
//   `split_k_plan` cuts K into contiguous ranges of whole bk steps, one
//   block each (grid z). Each block writes an f32 partial into a
//   [splits, M, N] scratch; the block that arrives last at its output
//   tile's counter (an int atomic) sums the tile's partials in slice order
//   and casts: no float atomics, so two calls give bitwise-equal results,
//   and one launch (at the head's size the host's cost of a launch and an
//   allocation is most of the call). One split (a grid that fills the
//   card) writes y directly.
// - skinny outputs (bm > M or bn > N, and few outputs: kernel.py `skinny`):
//   the threads of a block split each K step among themselves, bk lanes an
//   output unit (a row and 4 columns), and reduce with warp shuffles at the
//   end, instead of owning output positions outside the matrix. Operand
//   tiles are staged with 16-byte loads where the rows are aligned.
// At the head this takes one launch of a few microseconds on the card, more
// than cuBLAS's two kernels for the same product, and the call is bound by
// the host: the Python wrapper, ctypes and the launch cost ~20 us, as
// torch.matmul's own dispatch does (PERF.md gives both, device time and
// call time, on an H100 80GB HBM3 at 700 W).
//
// UNIQUE. The TPU version was one grid step with both whole operands
// resident in VMEM, and its wrapper accepted any operands within a 96 MiB
// budget, (M*K + K*N + M*N) * itemsize. The port takes the same budget and
// the same ValueError above it (kernel.py), so both accept the same shapes.
// "One residency, no K-streamed partition" maps to two launches here,
// chosen by the operands' size:
// - operands that fit one block's shared memory (232,448 bytes after
//   opt-in, less the barrier and alignment) go to ONE block holding both
//   whole operands (matmul_unique_kernel);
// - larger operands go to a grid of 64 x 64 output tiles in which each block
//   runs the whole K extent straight from device memory (through L1/L2),
//   with no staged K ring in shared memory (matmul_unique_grid_kernel).
//
// What bounds the single block on an H100: at the classifier head,
// [1, 2048] @ [2048, 4] in f32, the operands are 40 KB and the product 8,192
// FMAs, so the bytes bound is 12 ns; the launch, one copy's latency into one
// SM and the reduction set its time. The first port's block staged the
// operands element by element and then let 4 of its 1,024 threads walk
// K = 2,048 alone: 10.9 us on the card against cuBLAS's 2.6 (PERF.md). The
// design answers both:
// - each operand lands in shared memory with ONE 1-D bulk copy (the TMA
//   unit's cp.async.bulk, completing on an mbarrier) where its address and
//   byte count are 16-byte multiples (both are at the head), else with
//   16-byte vector loads and a scalar tail; bf16 stays bf16 there and is
//   widened in registers;
// - every thread works: a thread holds a micro-tile of rows x 4 outputs in
//   registers (kernel.py `unique_plan`: rows 4, or 1 when M < 4), and
//   `splits` threads share each micro-tile's K, interleaved (thread s takes
//   k = s, s + splits, ...). At the head: one micro-tile, 256 splits, eight
//   k each. The block has 256 threads: at the head a block of 1,024 took
//   longer on the card (PERF.md), and a wider block would only help
//   outputs large enough that the grid kernel takes them anyway. The partials are summed in a fixed order, xor shuffles inside a
//   warp and then the warps' sums in warp order through shared memory, so
//   two calls are bitwise equal, with one launch and no scratch in device
//   memory. The dynamic shared-memory limit is raised once for each kernel
//   and device, not on every launch.
// The grid alone would do for every shape, but at the head only four of its
// threads would work, each waiting on 2,048 loads in turn. UNIQUE is the
// "send everything at once" policy point, kept for the paper's comparison.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

constexpr int kThreads = 256;  // a 16 x 16 thread grid

// Split-K epilogue of one output tile, [m0, m0 + mt) x [n0, n0 + nt), once
// this block has written its f32 partial to part[blockIdx.z]: the block
// that arrives last at the tile's counter sums the tile's partials in slice
// order (z = 0, 1, ...) into y and re-arms the counter at 0 for the next
// call on the stream. No float atomics: the sum's order is fixed, so two
// calls give bitwise-equal results whichever block comes last. A thread an
// output loads kBatch slices at a time, so their loads are in flight
// together.
template <typename T>
__device__ void split_k_finish(const float* __restrict__ part,
                               T* __restrict__ y, int* counter, int M, int N,
                               int m0, int n0, int mt, int nt) {
  constexpr int kBatch = 32;
  __shared__ int last;
  const int splits = gridDim.z, outs = mt * nt;
  __threadfence();  // this block's partial is visible to every block
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long mn = static_cast<long long>(M) * N;
  for (int oi = threadIdx.x; oi < outs; oi += kThreads) {
    const long long o = static_cast<long long>(m0 + oi / nt) * N + n0 + oi % nt;
    float acc = 0.f;
    for (int z0 = 0; z0 < splits; z0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = z0 + j < splits ? __ldcg(part + (z0 + j) * mn + o) : 0.f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) acc = z0 + j == 0 ? v[j] : acc + v[j];
    }
    from_f32(acc, &y[o]);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// Each of 256 threads (a 16 x 16 grid) owns a (BM/16) x (BN/16) sub-tile of
// the block's output tile and accumulates it over the block's K range,
// split z = blockIdx.z: bk steps [z * per, (z + 1) * per). With one split the
// result goes to y in T, else the f32 partial to part[z] and split_k_finish
// (counters: one per output tile).
template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_blocks_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ part,
                     int* counters, int M, int N, int K, int per) {
  constexpr int TM = BM / 16, TN = BN / 16;
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * per * BK;
  const int k_end = min(K, k_begin + per * BK);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
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

  float* pz = part ? part + static_cast<long long>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const long long o = static_cast<long long>(gm) * N + gn;
      if (pz) pz[o] = acc[i][j];
      else from_f32(acc[i][j], &y[o]);
    }
  }
  if (pz)
    split_k_finish(part, y, counters + blockIdx.y * gridDim.x + blockIdx.x,
                   M, N, m0, n0, min(BM, M - m0), min(BN, N - n0));
}

// 16 bytes of T as f32, or fewer: elements [0, n) of src (n <= V), each
// zero past n; one vector load when all V are in and src is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load16(float* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  if (n == V && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = to_f32(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = i < n ? to_f32(src[i]) : 0.f;
  }
}

constexpr int kSkinnyUnits = 4;  // output units (a row, 4 columns) a lane holds
constexpr int kSkinnyMaxM = 128, kSkinnyMaxN = 128, kSkinnyMaxK = 32;

// The skinny BLOCKS kernel (kernel.py `skinny`): the same output tile, K
// range and staging as matmul_blocks_kernel, but the block's valid part
// (mt x nt) is cut into units of one row and 4 columns, and BK lanes (a
// warp or half of one) share each unit: lane kk takes column kk of every
// K step, so the threads split each K step among themselves. Group g of
// the 256 / BK groups holds units g + (256 / BK) i, i < kSkinnyUnits; the
// lanes' sums are reduced with warp shuffles after the last step.
template <typename T, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_blocks_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ y, float* __restrict__ part,
                            int* counters, int M, int N, int K, int BM,
                            int BN, int per) {
  constexpr int V = 16 / sizeof(T);
  constexpr int G = kThreads / BK;
  __shared__ float xs[kSkinnyMaxM][BK];
  __shared__ float ws[BK][kSkinnyMaxN + 1];  // padded: lanes read one column
  const int tid = threadIdx.x, g = tid / BK, kk = tid % BK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int mt = min(BM, M - m0), nt = min(BN, N - n0);
  const int nu = (nt + 3) / 4, units = mt * nu;
  const int k_begin = blockIdx.z * per * BK;
  const int k_end = min(K, k_begin + per * BK);

  float acc[kSkinnyUnits][4];
#pragma unroll
  for (int i = 0; i < kSkinnyUnits; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int kt = min(BK, k_end - k0);
    for (int i = tid; i < mt * (BK / V); i += kThreads) {
      const int r = i / (BK / V), c = (i % (BK / V)) * V;
      load16(&xs[r][c], x + static_cast<long long>(m0 + r) * K + k0 + c,
             max(0, min(V, kt - c)));
    }
    const int nv = (nt + V - 1) / V;
    for (int i = tid; i < BK * nv; i += kThreads) {
      const int r = i / nv, c = (i % nv) * V;
      float buf[V];
      load16(buf, w + static_cast<long long>(k0 + r) * N + n0 + c,
             r < kt ? min(V, nt - c) : 0);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e < nt) ws[r][c + e] = buf[e];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSkinnyUnits; ++i) {
      const int u = g + G * i;
      if (u < units) {
        const int r = u / nu, c = (u % nu) * 4;
        const float a = xs[r][kk];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < nt) acc[i][e] = fmaf(a, ws[kk][c + e], acc[i][e]);
      }
    }
    __syncthreads();
  }

  float* pz = part ? part + static_cast<long long>(blockIdx.z) * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < kSkinnyUnits; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = BK / 2; off > 0; off >>= 1)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    const int u = g + G * i;
    if (kk != 0 || u >= units) continue;
    const int r = u / nu, c = (u % nu) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= nt) continue;
      const long long o = static_cast<long long>(m0 + r) * N + n0 + c + e;
      if (pz) pz[o] = acc[i][e];
      else from_f32(acc[i][e], &y[o]);
    }
  }
  if (pz)
    split_k_finish(part, y, counters + blockIdx.y * gridDim.x + blockIdx.x,
                   M, N, m0, n0, mt, nt);
}

constexpr int kUniqueThreads = 256;  // kernel.py UNIQUE_THREADS
constexpr int kUniqueTN = 4;           // columns of a thread's micro-tile
constexpr size_t kSmemPerBlock = 232448;  // an H100 block's opt-in maximum

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// one arrival that also expects `bytes` of bulk-copy traffic on the barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
// a 1-D bulk copy (the TMA unit, no tensor map) of `bytes` from global to
// shared memory, completing on the barrier; addresses and size 16-byte
// multiples
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ bool bulk_ok(const void* src, size_t bytes) {
  return bytes > 0 && (bytes & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}
// src[0, n) -> dst by the block's threads where bulk_ok is false: 16-byte
// vector loads when src is 16-byte aligned, then a scalar tail (all scalar
// when it is not); dst is 16-byte aligned
template <typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* __restrict__ src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += kUniqueThreads) d4[i] = __ldg(s4 + i);
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < n; i += kUniqueThreads) dst[i] = src[i];
}

__host__ __device__ __forceinline__ size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

// Dynamic shared memory of the single block: the barrier (16 bytes), x
// (rounded up to 16 bytes, so w starts aligned), w; at least the cross-warp
// reduction's [32 warps][TM x 4] floats, which reuse x's place.
__host__ __device__ __forceinline__ size_t unique_smem_bytes(int M, int N, int K, size_t item) {
  const size_t ops = 16 + round16(static_cast<size_t>(M) * K * item) +
                     static_cast<size_t>(K) * N * item;
  const size_t red = 16 + (kUniqueThreads / 32) * 4 * kUniqueTN * sizeof(float);
  return ops > red ? ops : red;
}

// UNIQUE's single block: both whole operands in shared memory, every
// thread at work. Micro-tiles of TM x 4 outputs (row-major over the
// output); S = `splits` consecutive threads share a micro-tile, thread s of
// them taking k = s, s + S, ... into TM x 4 f32 accumulators (fmaf in k
// order). The S partials are summed in a fixed order — xor shuffles inside
// a warp (offsets min(S, 32)/2 .. 1), then, when S > 32, the warps' sums in
// warp order through shared memory — so two calls are bitwise equal
// (ref.py matmul_unique_order_ref is the same order). S > 1 only when the
// micro-tiles fit the block at once; with more micro-tiles than threads
// (S = 1) a thread walks several.
template <typename T, int TM>
__global__ void __launch_bounds__(kUniqueThreads)
matmul_unique_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int M, int N, int K, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const size_t xbytes = static_cast<size_t>(M) * K * sizeof(T);
  const size_t wbytes = static_cast<size_t>(K) * N * sizeof(T);
  T* xs = reinterpret_cast<T*>(smem + 16);
  T* ws = reinterpret_cast<T*>(smem + 16 + round16(xbytes));
  const uint32_t bar = smem_u32(smem);
  const bool xb = bulk_ok(x, xbytes), wb = bulk_ok(w, wbytes);
  if (xb || wb) {
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(bar, static_cast<uint32_t>((xb ? xbytes : 0) + (wb ? wbytes : 0)));
      if (xb) bulk_load(smem_u32(xs), x, static_cast<uint32_t>(xbytes), bar);
      if (wb) bulk_load(smem_u32(ws), w, static_cast<uint32_t>(wbytes), bar);
    }
  }
  if (!xb) copy_vec(xs, x, M * K);
  if (!wb) copy_vec(ws, w, K * N);
  __syncthreads();  // the vector copies, and the barrier's init
  if (xb || wb) mbar_wait(bar, 0);

  const int S = splits, s = tid % S;
  const int tiles_n = (N + kUniqueTN - 1) / kUniqueTN;
  const int tiles = (M + TM - 1) / TM * tiles_n;
  for (int t0 = 0; t0 < tiles; t0 += kUniqueThreads / S) {
    const int t = t0 + tid / S;
    const int r0 = t / tiles_n * TM, c0 = t % tiles_n * kUniqueTN;
    float acc[TM][kUniqueTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kUniqueTN; ++j) acc[i][j] = 0.f;
    if (t < tiles) {
      // ragged edges read a clamped row / column and are not stored
      const T* xr[TM];
      int wc[kUniqueTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs + static_cast<long long>(min(r0 + i, M - 1)) * K;
#pragma unroll
      for (int j = 0; j < kUniqueTN; ++j) wc[j] = min(c0 + j, N - 1);
#pragma unroll 4
      for (int k = s; k < K; k += S) {
        float a[TM], b[kUniqueTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f32(xr[i][k]);
        const T* wr = ws + static_cast<long long>(k) * N;
#pragma unroll
        for (int j = 0; j < kUniqueTN; ++j) b[j] = to_f32(wr[wc[j]]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kUniqueTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (S > 1) {
#pragma unroll
      for (int off = (S < 32 ? S : 32) / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kUniqueTN; ++j)
            acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
    }
    if (S <= 32) {  // lane s = 0 of the group holds the sum
      if (s == 0 && t < tiles) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (r0 + i >= M) continue;
#pragma unroll
          for (int j = 0; j < kUniqueTN; ++j)
            if (c0 + j < N) from_f32(acc[i][j], &y[static_cast<long long>(r0 + i) * N + c0 + j]);
        }
      }
      continue;
    }
    // S > 32, one pass (the micro-tiles fit the block at once): lane 0 of
    // each warp puts the warp's sums in shared memory, then a thread an
    // output adds its tile's S / 32 warps in warp order
    constexpr int E = TM * kUniqueTN;
    float* red = reinterpret_cast<float*>(smem + 16);  // [warp][E]
    __syncthreads();  // every warp is done reading the operands
    if (tid % 32 == 0)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kUniqueTN; ++j) red[tid / 32 * E + i * kUniqueTN + j] = acc[i][j];
    __syncthreads();
    const int nw = S / 32;
    for (int o = tid; o < tiles * E; o += kUniqueThreads) {
      const int tt = o / E, e = o % E;
      const int row = tt / tiles_n * TM + e / kUniqueTN;
      const int col = tt % tiles_n * kUniqueTN + e % kUniqueTN;
      const float* rw = red + tt * nw * E + e;
      float v = rw[0];
#pragma unroll 8
      for (int q = 1; q < nw; ++q) v += rw[q * E];
      if (row < M && col < N) from_f32(v, &y[static_cast<long long>(row) * N + col]);
    }
  }
}

// Each of 256 threads owns a 4 x 4 block of a 64 x 64 output tile (rows
// ty + 16 i, columns tx + 16 j) and walks the whole K extent reading x and w
// from device memory; neighbouring threads read neighbouring columns of w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_unique_grid_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ y, int M, int N, int K) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < K; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      a[i] = gm < M ? to_f32(x[static_cast<long long>(gm) * K + kk]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      b[j] = gn < N ? to_f32(w[static_cast<long long>(kk) * N + gn]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) from_f32(acc[i][j], &y[static_cast<long long>(gm) * N + gn]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch_blocks(const void* x, const void* w, void* y, float* part,
                  int* counters, int M, int N, int K, int splits, int per,
                  int skinny, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  float* pz = splits > 1 ? part : nullptr;
  if (skinny) {
    // the lanes of the block hold at most this many units (kernel.py
    // `skinny` chooses the kernel only below it)
    const int units = min(M, BM) * ((min(N, BN) + 3) / 4);
    if (units > (kThreads / BK) * kSkinnyUnits)
      return static_cast<int>(cudaErrorInvalidValue);
    static_assert(BM <= kSkinnyMaxM && BN <= kSkinnyMaxN && BK <= kSkinnyMaxK &&
                  (BK == 16 || BK == 32), "skinny tile");
    matmul_blocks_skinny_kernel<T, BK><<<grid, kThreads, 0, s>>>(
        xt, wt, yt, pz, counters, M, N, K, BM, BN, per);
  } else {
    matmul_blocks_kernel<T, BM, BN, BK><<<grid, kThreads, 0, s>>>(
        xt, wt, yt, pz, counters, M, N, K, per);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_blocks(const void* x, const void* w, void* y, float* part,
                    int* counters, int M, int N, int K, int tile, int splits,
                    int per, int skinny, cudaStream_t s) {
  switch (tile) {
    case 32: return launch_blocks<T, 32, 32, 16>(x, w, y, part, counters, M, N, K, splits, per, skinny, s);
    case 64: return launch_blocks<T, 64, 64, 32>(x, w, y, part, counters, M, N, K, splits, per, skinny, s);
    case 128: return launch_blocks<T, 128, 128, 32>(x, w, y, part, counters, M, N, K, splits, per, skinny, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the single block's dynamic shared memory may reach an H100 block's opt-in
// maximum: raised once for each kernel and device, not on every launch
template <typename T, int TM>
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(matmul_unique_kernel<T, TM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemPerBlock));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <typename T, int TM>
int launch_unique_block(const void* x, const void* w, void* y, int M, int N,
                        int K, int splits, size_t smem, cudaStream_t s) {
  const cudaError_t e = allow_max_smem<T, TM>();
  if (e != cudaSuccess) return static_cast<int>(e);
  matmul_unique_kernel<T, TM><<<1, kUniqueThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      M, N, K, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_unique(const void* x, const void* w, void* y, int M, int N, int K,
                  int rows, int splits, cudaStream_t s) {
  const size_t smem = unique_smem_bytes(M, N, K, sizeof(T));
  if (smem > kSmemPerBlock) {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    matmul_unique_grid_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  // splits: a power of two (kernel.py unique_plan); more than one only
  // when the micro-tiles x splits fit the block
  const int tiles = (M + rows - 1) / rows * ((N + kUniqueTN - 1) / kUniqueTN);
  if (splits < 1 || (splits & (splits - 1)) != 0 || splits > kUniqueThreads ||
      (splits > 1 && static_cast<long long>(tiles) * splits > kUniqueThreads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 4) return launch_unique_block<T, 4>(x, w, y, M, N, K, splits, smem, s);
  if (rows == 1) return launch_unique_block<T, 1>(x, w, y, M, N, K, splits, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tile: the square output tile edge, 32, 64 or 128 (K steps of 16, 32,
// 32); splits and per: grid z and the bk steps each split takes (kernel.py
// `split_k_plan`); skinny: 1 for the skinny kernel (kernel.py `skinny`);
// dtype: 0 = float32, 1 = bfloat16. When splits > 1, part: an f32 scratch
// of at least splits * M * N, and counters: one int per output tile, all 0
// (the kernel leaves them 0 again). Each entry returns cudaGetLastError().
extern "C" int matmul_blocks(const void* x, const void* w, void* y,
                             void* part, void* counters, int M, int N, int K,
                             int tile, int splits, int per, int skinny,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* cf = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (pf == nullptr || cf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_blocks<float>(x, w, y, pf, cf, M, N, K, tile, splits, per, skinny, s);
  if (dtype == 1) return dispatch_blocks<__nv_bfloat16>(x, w, y, pf, cf, M, N, K, tile, splits, per, skinny, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows and splits: the single block's plan (kernel.py `unique_plan`: a
// thread's micro-tile is rows x 4 outputs, rows 1 or 4, and `splits`
// threads share its K); the grid kernel ignores both.
extern "C" int matmul_unique(const void* x, const void* w, void* y, int M,
                             int N, int K, int rows, int splits, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_unique<float>(x, w, y, M, N, K, rows, splits, s);
  if (dtype == 1) return launch_unique<__nv_bfloat16>(x, w, y, M, N, K, rows, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
