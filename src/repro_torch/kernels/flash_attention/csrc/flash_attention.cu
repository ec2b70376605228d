// Flash attention forward: causal / sliding-window / full attention with an
// online softmax in exp2, GQA, f32 accumulation. Two kernels, one per dtype:
// bf16 runs on the tensor cores (flash_attention_fwd_tc), f32 on the CUDA
// cores (flash_attention_fwd).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   `_flash_kernel` / `flash_attention_bhsd` (the pallas_call at :115), with
//   the wrapper ops.py `flash_attention` ([B,S,H,Dh] <-> [BH,S,Dh]).
//
// What both compute, as the TPU kernel does: scores q.k in f32 times
// 1/sqrt(D); the causal mask kpos <= qpos and the window mask qpos - kpos <
// window, a masked score set to the finite NEG_INF = -2^30 (so a row with
// nothing visible yet averages instead of giving NaN); the running max m,
// sum l and accumulator acc updated with exp2 and 1/ln 2, l summed from the
// f32 p; p cast to v's type before the PV product; output acc / max(l,
// 1e-30) in q's type. KV tiles that no query of the tile can see are
// skipped, not masked (visible_kv_tiles below; kernel.py mirrors it). The
// KV head of query head h is h / (H / Hkv). The tensors are read by stride
// where they lie ([B,S,H,D], no transposes); ragged Sq and Skv are masked: a
// key past Skv takes no part at all (score -inf, p exactly 0, its K/V rows
// zero-filled), a query row past Sq is not stored. Q tiles are issued
// heaviest first (the causal diagonal's far end), so the last wave of blocks
// is short. One launch a layer.
//
// The TPU grid was (batch*heads, q tiles, kv tiles) with the kv axis
// sequential and the f32 acc/m/l carried in VMEM scratch from one grid step
// to the next. CUDA blocks run in no order, so the kv axis becomes a loop
// inside the block, with acc/m/l in registers.
//
// What bounds it on an H100. At the LM path's shape (qwen2.5-3b, B 2,
// S 2048, 16/2 heads, D 128, causal, bf16) the work is 3.4e10 FLOPs against
// 37.7 MB of q, k, v and o: 0.035 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 0.011 ms at 3.35 TB/s, so operations bound it, and only the tensor
// cores can come near it: the CUDA cores peak at 67 TFLOP/s.
//
// bf16: flash_attention_fwd_tc, on the tensor cores with wgmma (sm_90a; the
// design of record, not the lesser mma.sync one). One block per
// (batch*head, 128-row q tile): two consumer warpgroups, 64 query rows
// each, and two blocks an SM up to D 128. Thread 0 brings the q tile in
// once and each 64-key K/V tile by TMA (a 4-d tensor map a tensor, encoded
// on the host through cudaGetDriverEntryPoint so the build links nothing
// new) into a two-stage ring: tile t+1 is issued as tile t's compute
// starts, each stage's copies complete on its mbarrier, and a block
// barrier at the end of a tile frees its stage. Rows past Sq or Skv arrive
// as zeros. Each warpgroup runs S = Q K^T as wgmma m64n64k16 with both
// operands in shared memory and S accumulating in registers; the row max
// and sum are reduced over the four threads that hold a row's fragment
// (quad shuffles); p is rounded to bf16 in registers and fed as the
// register A operand of the PV wgmma (m64nDk16, V as the MN-major B operand
// from shared memory), so p never goes through shared memory. A warpgroup
// skips the MMAs of a tile none of its 64 rows can see; the block loads
// the union of its two warpgroups' tiles.
//
// Shared-memory layout: the 128-byte swizzle, the same for Q, K and V. A
// tile of R rows is ceil(D / 64) chunks of R rows x 128 bytes, one TMA box
// of 64 columns each, which the copy engine swizzles in 1024-byte atoms as
// wgmma's B128 layout reads them. Head dims 80 and 160 do not fill their
// last 128-byte row (16 and 32 of 64 columns): TMA fills the columns past
// D with zeros in shared memory (the tensors in device memory are not
// padded), S's k steps never reach them, and PV's N = D stops before them.
// A 64-key tile keeps S at 32 registers a thread, so D 160 (80 accumulator
// registers) fits beside it, at one block an SM.
//
// What bounds it (PERF.md, H100 80GB HBM3, 700 W): not the tensor cores.
// Removing both products left its time unchanged; the K/V copies set it,
// and their cost follows the number of rows a TMA box has: 128-byte rows
// (256 a 64-key tile at D 128) run ~1.4x faster at the qwen shape than
// the 16-byte rows (2,048) an unswizzled layout needs. Next: a
// warp-specialised producer, one tile's softmax overlapping the next
// tile's S, K/V shared across a GQA group's heads.
//
// f32: flash_attention_fwd, the first port's kernel, kept as it was: a float32
// product on the tensor cores would be TF32, which the f32 route's limits
// (2e-4 against the plain version, the LM's f32 logits at 1e-3) do not
// allow, so it stays on the CUDA cores with f32 FMAs, which bound it
// (~1.4 ms at the shape above). One block per (batch*head, 64-row q tile),
// 128 threads; the q tile and each 32-key K/V tile staged into shared memory;
// thread (ty, tx) = (tid / 8, tid % 8) owns query rows ty + 16 i (i < 4),
// computes the scores of columns tx + 8 j (j < 4) and keeps m, l and the
// accumulator of output columns tx + 8 j (j < D / 8) in registers; the 8
// threads of a row reduce its max and sum with warp shuffles.

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1073741824.f;  // -2^30, the reference's NEG_INF
constexpr float kInvLn2 = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;     // q and o strides (elements): batch, seq, head
  long long kv_sb, kv_ss, kv_sh;  // k and v strides
  int B, H, Hkv, Sq, Skv, causal, window;
};

// [t_lo, t_hi): the bkv-key tiles that some query row in [q0, min(q0 + bq,
// sq)) can see (kernel.py: visible_kv_tiles). The rows' visible keys form
// one interval, so every tile in the range holds a visible (q, k) pair.
__device__ __forceinline__ int2 visible_kv_tiles(
    int q0, int bq, int bkv, int sq, int skv, int causal, int window) {
  if (q0 >= sq || skv <= 0) return make_int2(0, 0);
  const int q_last = min(q0 + bq, sq) - 1;
  int k_lo = 0, k_hi = skv;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (k_hi <= k_lo) return make_int2(0, 0);
  return make_int2(k_lo / bkv, (k_hi + bkv - 1) / bkv);
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
namespace cc {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBKV = 32;      // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kPP = kBKV + 1;  // padded row stride of the p tile

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int DP = D + 1;  // padded row stride of the q and k tiles
  constexpr int DJ = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][DP]
  float* ks = qs + kBQ * DP;    // [kBKV][DP]
  float* vs = ks + kBKV * DP;   // [kBKV][D]
  float* ps = vs + kBKV * D;    // [kBQ][kPP]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.kv_sb + hkv * p.kv_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.kv_sb + hkv * p.kv_sh;
  T* og = static_cast<T*>(p.o) + b * p.q_sb + h * p.q_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] = q0 + r < p.Sq ? to_f32(qg[(q0 + r) * p.q_ss + d]) : 0.f;
  }

  float acc[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys some query of this tile can see: [k_lo, k_hi); tiles outside are
  // skipped (no loads, no work)
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kBKV, t_hi = (k_hi + kBKV - 1) / kBKV;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // the previous tile's k, v, p reads are done
    for (int i = tid; i < kBKV * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < p.Skv;
      ks[r * DP + d] = in ? to_f32(kg[(k0 + r) * p.kv_ss + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[(k0 + r) * p.kv_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool ok = true;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        float x = ok ? s[i][j] * scale : kNegInf;
        if (kpos >= p.Skv) x = __int_as_float(0xff800000);  // -inf: past the end, no part at all
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f((m[i] - mx) * kInvLn2);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = exp2f((s[i][j] - mx) * kInvLn2);
        rs += pj;
        // p in v's type before the PV product
        ps[(ty + 16 * i) * kPP + tx + 8 * j] = to_f32(from_f32<T>(pj));
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = mx;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[c * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[r * p.q_ss + tx + 8 * j] = from_f32<T>(acc[i][j] / lm);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t s) {
  const int smem = static_cast<int>(
      (kBQ * (D + 1) + kBKV * (D + 1) + kBKV * D + kBQ * kPP) * sizeof(float));
  // above 48 KB a block's shared memory must be opted in to; the setting is
  // per device, so it is made on every launch (it costs next to nothing)
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch<float, 64>(p, s);
    case 80: return launch<float, 80>(p, s);
    case 128: return launch<float, 128>(p, s);
    case 160: return launch<float, 160>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
namespace tc {

constexpr int kBQ = 128;  // query rows a block: two warpgroups of 64
constexpr int kBKV = 64;  // keys a K/V tile
constexpr int kThreads = 256;
constexpr int kStages = 2;  // the K/V ring: tile t+1 loads while tile t is
                            // computed

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// one arrival that also expects `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
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
// a TMA copy of one box (column, row, head, batch) of a 4-d tensor map
// into shared memory; the bytes complete on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head, int batch,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(head), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading byte offset (LBO) and stride byte offset (SBO), each in
// 16-byte units, layout type 1 (B128). A tile of R rows is kept as
// ceil(D / 64) chunks of R rows x 128 bytes (64 columns; a row's columns
// past D are zeros), each 8-row group of a chunk one 1024-byte swizzle
// atom, as TMA's 128-byte swizzle lays a box down. K-major (Q, K): SBO
// steps to the next 8 rows (1024 bytes), LBO is unused, and the 16-column
// k steps inside a chunk advance the start by 32 bytes. MN-major (V as B
// of P.V): LBO steps to the next 64 columns of D (the next chunk, 128 R
// bytes), SBO to the next 8 keys (1024 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instruction
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The wgmma instructions, one per shape used. Inline PTX takes no arrays,
// so each lists its accumulator registers one by one.
// S (64 x 64) (+)= A (64 x 16, shared) . B (64 x 16, shared)^T; both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 80) += A (64 x 16, registers) . B (16 x 80, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 160) += A (64 x 16, registers) . B (16 x 160, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(o, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n160(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two blocks an SM up to D 128 (at most 128 registers a thread; D 128 takes
// more without the bound, one block an SM, which ran 13% slower at qwen's
// shape)
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_fwd_tc_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  static_assert(D % 16 == 0 && D <= 256, "wgmma: D a multiple of 16, <= 256");
  constexpr int kChunks = (D + 63) / 64;  // 128-byte column chunks a row
  constexpr int kQBytes = kChunks * kBQ * 128;
  constexpr int kTileBytes = kChunks * kBKV * 128;  // one K or V tile
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  // [q tile][stage 0: K, V][stage 1: K, V][barriers: q, stage 0, stage 1],
  // from the first 1024-byte boundary (the swizzle atom)
  const uint32_t q_s = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + kQBytes;
  const uint32_t bar = kv_s + kStages * 2 * kTileBytes;  // 8 bytes each

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int qw0 = q0 + 64 * wg;  // this warpgroup's first row
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.q_sb + h * p.q_sh;

  // the block loads the tiles some row of its 128 sees; a warpgroup
  // computes the tiles some row of its 64 sees
  const int2 blk = visible_kv_tiles(q0, kBQ, kBKV, p.Sq, p.Skv, p.causal, p.window);
  const int2 own = visible_kv_tiles(qw0, 64, kBKV, p.Sq, p.Skv, p.causal, p.window);

  // Thread 0 issues every copy, by TMA: the q tile once, then K and V
  // tile t into stage (t - t_lo) % kStages, each completing on that
  // stage's barrier (its n-th use is the phase of parity n & 1). Rows
  // past Sq or Skv come in as zeros.
  auto load_kv = [&](int t) {
    if (t < blk.y) {
      const int st = (t - blk.x) % kStages;
      const uint32_t dst = kv_s + st * 2 * kTileBytes, fb = bar + 8 + 8 * st;
      mbar_expect(fb, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(dst + c * kBKV * 128, &tk, 64 * c, t * kBKV, hkv, b, fb);
        tma_load(dst + kTileBytes + c * kBKV * 128, &tv, 64 * c, t * kBKV,
                 hkv, b, fb);
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, kQBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load(q_s + c * kBQ * 128, &tq, 64 * c, q0, h, b, bar);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load_kv(blk.x + i);
  }

  // accumulator fragment: this thread holds rows row0 and row0 + 8 of the
  // warpgroup's 64, columns 8 j + col0 and 8 j + col0 + 1 (register
  // 4 j + 2 i + c for row row0 + 8 i, column 8 j + col0 + c)
  const int row0 = 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qa = q_s + wg * 64 * 128;  // the warpgroup's 64 rows
  mbar_wait(bar, 0);

  for (int t = blk.x; t < blk.y; ++t) {
    const int st = (t - blk.x) % kStages;
    // into the stage of tile t - 1, which every warpgroup is done with
    if (tid == 0) load_kv(t + kStages - 1);
    mbar_wait(bar + 8 + 8 * st, ((t - blk.x) / kStages) & 1);  // tile t is in

    if (t >= own.x && t < own.y) {
      const uint32_t ks = kv_s + st * 2 * kTileBytes, vs = ks + kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s,
                     make_desc(qa + (kk >> 2) * kBQ * 128 + (kk & 3) * 32,
                               16, 1024),
                     make_desc(ks + (kk >> 2) * kBKV * 128 + (kk & 3) * 32,
                               16, 1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      // masks only where a tile is not wholly visible to the warpgroup
      const int k0 = t * kBKV;
      const bool edge = k0 + kBKV > p.Skv ||
                        (p.causal && k0 + kBKV - 1 > qw0) ||
                        (p.window > 0 && qw0 + 63 - k0 >= p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (edge) {
            const int qpos = qw0 + row0 + 8 * (e >> 1);
            const int kpos = k0 + 8 * j + col0 + (e & 1);
            bool ok = true;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.window > 0) ok = ok && qpos - kpos < p.window;
            x = ok ? x : kNegInf;
            if (kpos >= p.Skv) x = __int_as_float(0xff800000);  // -inf: past the end, no part at all
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the four threads of a quad hold one row's 64 scores
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f((m[i] - mx[i]) * kInvLn2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pj = exp2f((s[4 * j + e] - mx[e >> 1]) * kInvLn2);
          rs[e >> 1] += pj;
          s[4 * j + e] = pj;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];  // l from the f32 p
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // p in bf16 as the A operand, keys 16 kk .. 16 kk + 15: the S
      // accumulator's layout is the A fragment's, two 8-key chunks at a time
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(o, a[kk], make_desc(vs + kk * 2048, kBKV * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(o);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qw0 + row0 + 8 * i;
    if (q >= p.Sq) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = og + static_cast<long long>(q) * p.q_ss + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / lm, o[4 * j + 2 * i + 1] / lm);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A [B, S, H, D] bf16 tensor (element strides sb, ss, sh; D contiguous)
// as the 4-d map (D, S, H, B), boxes of (64 columns, rows, 1, 1) laid down
// with the 128-byte swizzle; columns past D and rows past S are
// zero-filled.
bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H,
                 int D, long long sb, long long ss, long long sh, int rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, kBQ) ||
      !encode_bshd(&tk, p.k, p.B, p.Skv, p.Hkv, D, p.kv_sb, p.kv_ss, p.kv_sh,
                   kBKV) ||
      !encode_bshd(&tv, p.v, p.B, p.Skv, p.Hkv, D, p.kv_sb, p.kv_ss, p.kv_sh,
                   kBKV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kChunks = (D + 63) / 64;
  const int smem = 1024 + kChunks * 128 * (kBQ + kStages * 2 * kBKV) +
                   8 * (kStages + 1);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<D><<<grid, kThreads, smem, s>>>(p, tq, tk, tv);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(p, s);
    case 80: return launch<80>(p, s);
    case 128: return launch<128>(p, s);
    case 160: return launch<160>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// q, o: [B, Sq, H, D] and k, v: [B, Skv, Hkv, D], each given by its element
// strides (batch, seq, head; the D axis is contiguous). D is 64, 80, 128 or
// 160. Each returns cudaGetLastError().
// float32 q, k, v, o: the CUDA-core kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int Sq,
                                   int Skv, int D, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long kv_sb, long long kv_ss,
                                   long long kv_sh, int causal, int window,
                                   void* stream) {
  const Params p{q, k, v, o, q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh,
                 B, H, Hkv, Sq, Skv, causal, window};
  return cc::dispatch(p, D, static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v, o (16-byte aligned, row strides a multiple of 8
// elements): the tensor-core kernel.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int D,
                                      long long q_sb, long long q_ss,
                                      long long q_sh, long long kv_sb,
                                      long long kv_ss, long long kv_sh,
                                      int causal, int window, void* stream) {
  const Params p{q, k, v, o, q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh,
                 B, H, Hkv, Sq, Skv, causal, window};
  return tc::dispatch(p, D, static_cast<cudaStream_t>(stream));
}
