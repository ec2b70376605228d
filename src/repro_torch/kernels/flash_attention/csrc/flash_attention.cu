// Flash attention forward: causal / sliding-window / full attention with an
// online softmax in exp2, GQA, f32 accumulation.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py
//   `_flash_kernel` / `flash_attention_bhsd` (the pallas_call at :115), with
//   the wrapper ops.py `flash_attention` ([B,S,H,Dh] <-> [BH,S,Dh]).
//
// What it computes, as the TPU kernel does: scores q.k in f32 times 1/sqrt(D);
// the causal mask kpos <= qpos and the window mask qpos - kpos < window, a
// masked score set to the finite NEG_INF = -2^30 (so a row with nothing
// visible yet averages instead of giving NaN); the running max m, sum l and
// accumulator acc updated with exp2 and 1/ln 2; p cast to v's type before
// the PV product; output acc / max(l, 1e-30) in q's type. KV tiles that no
// query of the tile can see are skipped, not masked. The KV head of query
// head h is h / (H / Hkv).
//
// Layout. The TPU grid was (batch*heads, q tiles, kv tiles) with the kv axis
// sequential and the f32 acc/m/l carried in VMEM scratch from one grid step
// to the next. CUDA blocks run in no order, so the kv axis becomes a loop
// inside the block: one block per (batch*head, 64-row q tile), 128 threads.
// The q tile stays in shared memory; each 32-key K/V tile is staged into
// shared memory as f32 (bf16 -> f32 is exact). Thread (ty, tx) = (tid / 8,
// tid % 8) owns query rows ty + 16 i (i < 4): it computes the scores of
// columns tx + 8 j (j < 4) and keeps m, l and the accumulator of output
// columns tx + 8 j (j < D / 8) in registers; the 8 threads of a row reduce
// its max and sum with warp shuffles. The tensors are read by stride, so
// the wrapper passes [B,S,H,D] as they lie, with no transposes. Ragged Sq
// and Skv are masked here: a key past Skv takes no part at all (its score
// is -inf, its p exactly 0), a query row past Sq is not stored. Q tiles
// are issued heaviest first (the causal diagonal's far end), so the last
// wave of blocks is short.
//
// What bounds it on an H100. At the LM path's shape (qwen2.5-3b, B 2,
// S 2048, 16/2 heads, D 128, causal, bf16) the work is 3.4e10 FLOPs against
// 37.7 MB of q, k, v and o: 0.035 ms at the 989 TFLOP/s bf16 tensor-core
// peak, 0.011 ms at 3.35 TB/s, so operations bound it. This first version
// does its products with f32 FMAs on the CUDA cores (67 TFLOP/s at most), so
// it cannot come within 15x of that bound; it is right first. Tensor-core
// tiles (wgmma on bf16 q/k/v with p kept in registers), TMA-fed K/V double
// buffering and warp specialisation are the later work that closes the gap.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1073741824.f;  // -2^30, the reference's NEG_INF
constexpr float kInvLn2 = 1.4426950408889634f;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBKV = 32;      // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kPP = kBKV + 1;  // padded row stride of the p tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;     // q and o strides (elements): batch, seq, head
  long long kv_sb, kv_ss, kv_sh;  // k and v strides
  int B, H, Hkv, Sq, Skv, causal, window;
};

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

template <typename T>
int dispatch(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(p, s);
    case 80: return launch<T, 80>(p, s);
    case 128: return launch<T, 128>(p, s);
    case 160: return launch<T, 160>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o: [B, Sq, H, D] and k, v: [B, Skv, Hkv, D], each given by its element
// strides (batch, seq, head; the D axis is contiguous). D is 64, 80, 128 or
// 160; dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int Sq,
                                   int Skv, int D, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long kv_sb, long long kv_ss,
                                   long long kv_sh, int causal, int window,
                                   int dtype, void* stream) {
  const Params p{q, k, v, o, q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh,
                 B, H, Hkv, Sq, Skv, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
