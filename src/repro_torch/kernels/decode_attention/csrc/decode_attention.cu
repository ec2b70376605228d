// Decode attention on the card: one new token a slot, every query head of a
// GQA group at once, against the bf16 KV cache read where it lies.
//
// For slot b, query head h = g n_rep + r (KV head g, as repeat_kv groups
// them) and the slot's live rows j < n_b = min(length_b + 1, S_max):
//
//   s[j]  = scale q[b, h] . k[b, j, g]                          (f32)
//   o[b,h] = sum_j T(exp(s[j] - m)) v[b, j, g] / sum_j exp(s[j] - m)
//
// with m a running maximum and T the rounding to bf16 that the model's
// blocks route takes before its PV product; the PV sum, the softmax's sum
// and maximum are f32, the output bf16.
//
// Replaces no TPU kernel: the reference's decode attention is XLA's (jnp in
// src/repro/models/layers/attention.py). It was added because the port's
// plain decode repeated K and V over each head group, cast K to f32 and
// handed both to einsum as permuted copies, over all S_max rows of every
// slot, every layer, every step: on granite.chat those copies were most of
// the card's time a step.
//
// What bounds it on an H100. Each live row's K and V are read once (chat:
// 64 slots x 8 KV heads x ~755 live rows x 2 x 128 bytes, ~99 MB a layer,
// 30 us at 3.35 TB/s); the products are 4 n_rep Dh FLOPs a row and head
// group, three orders of magnitude below the tensor cores' rate, so bytes
// bound it and the CUDA cores do the arithmetic. The design keeps many
// 16-byte loads in flight and reads nothing twice:
//
// - Split over rows. A block owns one (slot, KV head, chunk of kChunk rows)
//   and all n_rep query heads of the group, so each K/V row is read once for
//   the whole group. The grid is set by S_max, not by the lengths (a CUDA
//   graph can replay it with other lengths); a block whose chunk starts past
//   n_b returns at once.
// - Dh / 8 lanes hold a row, 16 bytes each; the block's 128 threads are
//   128 / (Dh / 8) row groups that take the chunk's rows in turn, U rows
//   at a time (4; 2 for 8 heads of 128), the next U rows' K and V loaded
//   before the current ones are used (double-buffered in registers). A
//   row's dot product is reduced across its lanes by xor shuffles.
// - Each row group keeps its own online softmax (m, l, acc in f32); the
//   block merges its groups through shared memory and writes the chunk's
//   partial (m, l, acc) to scratch; a second, small launch merges the chunks
//   of each (slot, head) and writes o in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;  // cache rows a block
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;  // [B, 1, H, Dh], heads and dims contiguous
  const __nv_bfloat16* k;  // [B, S, Hkv, Dh], heads and dims contiguous
  const __nv_bfloat16* v;
  const long long* length;  // [B] (stride length_stride) or null
  long long length_int;     // every slot's length where length is null
  long long length_stride;
  float* part_acc;  // [B, n_chunks, H, Dh]
  float* part_ml;   // [B, n_chunks, H, 2]: (max, sum), log2 units
  __nv_bfloat16* out;  // [B, 1, H, Dh] contiguous
  long long q_sb, k_sb, k_ss, v_sb, v_ss;  // strides, in elements
  int H, S, n_chunks;
  float scale_log2;  // scale * log2(e): scores kept in log2 units
};

__device__ __forceinline__ int live_rows(const Params& p, int b) {
  const long long len = p.length ? p.length[b * p.length_stride] : p.length_int;
  long long n = len + 1;
  n = n < 0 ? 0 : (n > p.S ? p.S : n);
  return static_cast<int>(n);
}

__device__ __forceinline__ void to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* ptr) {
  return __ldg(reinterpret_cast<const uint4*>(ptr));
}

// rows first + u G (u < U) of a step; a row past the live ones reads as zeros
template <int U, int G>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb,
                                          long long k_ss, long long v_ss,
                                          int first, int row_end,
                                          uint4 (&kx)[U], uint4 (&vx)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = first + u * G;
    if (row < row_end) {
      kx[u] = load16(kb + row * k_ss);
      vx[u] = load16(vb + row * v_ss);
    } else {
      kx[u] = make_uint4(0, 0, 0, 0);
      vx[u] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int DH, int NREP>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split_kernel(const Params p) {
  constexpr int L = DH / 8;        // lanes a row
  constexpr int G = kThreads / L;  // row groups a block
  // rows a row group has in flight: fewer where q and acc take more
  // registers (8 heads of 128)
  constexpr int U = NREP * DH >= 1024 ? 2 : 4;
  constexpr int kStep = G * U;  // rows the block takes a step
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n = live_rows(p, b);
  const int row0 = c * kChunk;
  if (row0 >= n) return;
  const int row_end = min(row0 + kChunk, n);
  const int lane = threadIdx.x % L, grp = threadIdx.x / L;

  // this lane's 8 elements of each head's q, in log2 units
  float qf[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    to_f32(load16(p.q + b * p.q_sb + (g * NREP + r) * DH + lane * 8), qf[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[r][i] *= p.scale_log2;
  }
  float m[NREP], l[NREP], acc[NREP][8];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

  const __nv_bfloat16* kb = p.k + b * p.k_sb + g * DH + lane * 8;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + g * DH + lane * 8;
  uint4 kc[U], vc[U], kn[U], vn[U];
  // every thread takes the same number of steps, so each shuffle below has
  // all 32 lanes of its warp
  const int steps = (row_end - row0 + kStep - 1) / kStep;
  load_rows<U, G>(kb, vb, p.k_ss, p.v_ss, row0 + grp, row_end, kc, vc);
  for (int it = 0; it < steps; ++it) {
    const int first = row0 + grp + it * kStep;
    if (it + 1 < steps)
      load_rows<U, G>(kb, vb, p.k_ss, p.v_ss, first + kStep, row_end, kn, vn);
    float s[U][NREP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      to_f32(kc[u], kf);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qf[r][i], kf[i], d);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][r] = d;
      }
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (first + u * G < row_end) mx = fmaxf(mx, s[u][r]);
      // mx == m[r] also where both are -inf (no live row yet)
      const float alpha = mx == m[r] ? 1.f : exp2f(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= alpha;
      m[r] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (first + u * G >= row_end) continue;
      float vf[8];
      to_f32(vc[u], vf);
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float pr = exp2f(s[u][r] - m[r]);
        l[r] += pr;
        const float pb = __bfloat162float(__float2bfloat16(pr));
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pb, vf[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  // the block's row groups merged, then the chunk's partial to scratch
  __shared__ float sm_m[G][NREP], sm_l[G][NREP];
  __shared__ __align__(16) float sm_acc[G][NREP][DH];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float4* dst = reinterpret_cast<float4*>(&sm_acc[grp][r][lane * 8]);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    if (lane == 0) {
      sm_m[grp][r] = m[r];
      sm_l[grp][r] = l[r];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < NREP * DH; o += kThreads) {
    const int r = o / DH, d = o % DH;
    float mx = -INFINITY;  // finite: row row0 is live, in group 0
#pragma unroll
    for (int j = 0; j < G; ++j) mx = fmaxf(mx, sm_m[j][r]);
    float sl = 0.f, sa = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float mj = sm_m[j][r];
      const float w = mj == -INFINITY ? 0.f : exp2f(mj - mx);
      sl = fmaf(w, sm_l[j][r], sl);
      sa = fmaf(w, sm_acc[j][r][d], sa);
    }
    const long long cell =
        (static_cast<long long>(b) * p.n_chunks + c) * p.H + g * NREP + r;
    p.part_acc[cell * DH + d] = sa;
    if (d == 0) {
      p.part_ml[cell * 2] = mx;
      p.part_ml[cell * 2 + 1] = sl;
    }
  }
}

// one block a (head, slot), one thread a dim: the chunks' partials merged
template <int DH>
__global__ void __launch_bounds__(DH) decode_attention_merge_kernel(
    const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int nc = (live_rows(p, b) + kChunk - 1) / kChunk;
  const long long first = static_cast<long long>(b) * p.n_chunks * p.H + h;
  float mx = -INFINITY;
  for (int c = 0; c < nc; ++c)
    mx = fmaxf(mx, p.part_ml[(first + c * p.H) * 2]);
  float sl = 0.f, sa = 0.f;
  for (int c = 0; c < nc; ++c) {
    const long long cell = first + c * p.H;
    const float w = exp2f(p.part_ml[cell * 2] - mx);
    sl = fmaf(w, p.part_ml[cell * 2 + 1], sl);
    sa = fmaf(w, p.part_acc[cell * DH + d], sa);
  }
  p.out[(static_cast<long long>(b) * p.H + h) * DH + d] =
      __float2bfloat16(nc ? sa / sl : 0.f);
}

template <int DH, int NREP>
int launch(const Params& p, int B, int Hkv, cudaStream_t s) {
  decode_attention_split_kernel<DH, NREP>
      <<<dim3(p.n_chunks, Hkv, B), kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_merge_kernel<DH><<<dim3(p.H, B), DH, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int dispatch(const Params& p, int B, int Hkv, int n_rep, cudaStream_t s) {
  switch (n_rep) {
    case 1: return launch<DH, 1>(p, B, Hkv, s);
    case 2: return launch<DH, 2>(p, B, Hkv, s);
    case 4: return launch<DH, 4>(p, B, Hkv, s);
    case 8: return launch<DH, 8>(p, B, Hkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, 1, H, Dh] bf16 (batch stride q_sb); k, v: [B, S, Hkv, Dh] bf16
// (batch and row strides k_sb / k_ss, v_sb / v_ss), each row's heads and
// dims contiguous; every pointer and stride 16-byte aligned. length: [B]
// int64 lengths (stride length_stride, 0 for one shared 0-d tensor) or
// null, then length_int for every slot; slot b attends its rows j <
// min(length_b + 1, S). part_acc: [B, ceil(S / 256), H, Dh] f32 and
// part_ml: [B, ceil(S / 256), H, 2] f32 scratch; out: [B, 1, H, Dh] bf16
// contiguous. Dh 64 or 128, H / Hkv 1, 2, 4 or 8. Two launches on stream;
// returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const long long* length, long long length_int,
                                long long length_stride, float* part_acc,
                                float* part_ml, void* out, long long q_sb,
                                long long k_sb, long long k_ss, long long v_sb,
                                long long v_ss, int B, int H, int Hkv, int S,
                                int Dh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 length, length_int, length_stride, part_acc, part_ml,
                 static_cast<__nv_bfloat16*>(out), q_sb, k_sb, k_ss, v_sb,
                 v_ss, H, S, (S + kChunk - 1) / kChunk, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return dispatch<64>(p, B, Hkv, H / Hkv, s);
  if (Dh == 128) return dispatch<128>(p, B, Hkv, H / Hkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
