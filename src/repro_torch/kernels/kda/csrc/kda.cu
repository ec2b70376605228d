// Kimi Delta Attention (KDA, arXiv:2510.26692) on the card: the chunked
// prefill (two launches a call, whatever the length) and the fused decode
// step (one launch a call for every slot and head).
//
// Per head, with the state S [128 keys x 128 values] in f32, a decay
// a_t = exp(g_t) per key channel (g_t <= 0) and a scalar beta_t:
//
//   S_t = (I - beta_t k_t k_t^T) Diag(a_t) S_{t-1} + beta_t k_t v_t^T
//   o_t = S_t^T q_t
//
// q, k and v come in bf16 (q already L2-normalised and scaled, k
// normalised), g and beta in f32; every product and the state are f32;
// o goes out in bf16.
//
// Replaces no TPU kernel: the reference package has no linear attention.
//
// The chunked prefill (ref.kda_chunk_ref has the algebra). Chunks of
// kC = 64 tokens; G is g's cumulative sum from the chunk's start.
//
// - kda_intra_kernel, a block a (chunk, head, sequence), all chunks at
//   once: G; A[t, s] = beta_t sum_i k_t,i k_s,i exp(G_t,i - G_s,i) (s < t)
//   and M[t, s] = sum_i q_t,i k_s,i exp(G_t,i - G_s,i) (s <= t), an
//   exponential a pair and channel, every exponent <= 0 (so nothing
//   overflows whatever the decay); then (I + A) X = [beta Gamma K | beta V]
//   solved by forward substitution, a column a thread, giving W and U0.
//   It writes W, U0, Gamma Q, K exp(G_C - G), M and Gamma_C to scratch.
// - kda_state_kernel, a block a (32 value columns, head, sequence), walks
//   the chunks in order with its slice of the state in shared memory:
//   U = U0 - W S, O = (Gamma Q) S + M U, S <- Gamma_C S + (K exp(G_C -
//   G))^T U. It reads the given state first and writes the final state
//   in its place at the end.
//
// What bounds the prefill on an H100: at 4,096 tokens and 32 heads the
// intra-chunk work is ~0.5 G exponentials and ~4 GFLOP of small
// triangular products, the state pass ~15 GFLOP in chains of 64 chunks;
// both stay on the CUDA cores in f32 (a bf16 state would drift), so the
// exponentials, shared memory's bandwidth and the serial chain bound
// them, not HBM. The design feeds the FMAs from registers:
//
// - the intra kernel keeps the chunk's G, k and q transposed (a channel a
//   row of 64 tokens, 16-byte pieces XOR-swizzled by the row so that a
//   quarter warp's rows fall on distinct banks); a thread forms a 4 x 4
//   tile of (t, s) pairs from five 16-byte loads a channel, and the solve
//   keeps its column of X in 64 registers, the loops unrolled;
// - the state pass gives each thread a 4 x 2 tile of U and O and an 8 x 2
//   tile of S, fed by 16- and 8-byte loads (rows padded to 16 bytes).
//
// The decode step, kda_step_kernel, a block a (head, slot), a value
// column a thread: the column of S (128 floats) is read once into
// registers, u = (a * k) . S, then S' = a S + k beta (v - u) and o = q .
// S' in the same registers, written once in place. What bounds it: the
// state, 64 KiB a (slot, head) read and written (256 MiB a layer at 64
// slots), against ~1 MFLOP: HBM. Rows of 128 floats across the block's
// threads are coalesced. The grid is set by the shapes alone, so a CUDA
// graph replays it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;         // key and value width of a head
constexpr int kC = 64;          // tokens a chunk
constexpr int kThreads = 256;
constexpr int kVT = 32;         // value columns a state-pass block
constexpr int kRS = kD + 4;     // a state-pass shared row of kD floats
constexpr int kMS = kC + 4;     // a state-pass shared row of M
static_assert(2 * kD == kThreads, "a solve column a thread");
static_assert((kC / 4) * (kC / 4) == kThreads, "a 4 x 4 pair tile a thread");

struct ChunkParams {
  const __nv_bfloat16* q;  // [B, S, H, D], D contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* g;     // [B, S, H, D] contiguous
  const float* beta;  // [B, S, H] contiguous
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float* w;      // [B, nc, H, C, D] scratch: W
  float* u0;     // U0
  float* qg;     // Gamma Q
  float* kend;   // K exp(G_C - G)
  float* m;      // [B, nc, H, C, C]
  float* gamma;  // [B, nc, H, D]: Gamma_C
  float* state;  // [B, H, D, D] contiguous, in place
  __nv_bfloat16* o;  // [B, S, H, D] contiguous
  int S, H, nc;
};

// the intra kernel: G, k and q transposed, [kD][kC] each, then A [kC][kC]
// and beta [kC]
constexpr int kSmemIntra = (3 * kD * kC + kC * kC + kC) * 4;
// the state pass: its state slice, one [kC][kRS] row buffer, M, U, Gamma_C
constexpr int kSmemState =
    (kD * kVT + kC * kRS + kC * kMS + kC * kVT + kD) * 4;

__device__ __forceinline__ long long cell_of(const ChunkParams& p, int b,
                                             int n, int h) {
  return (static_cast<long long>(b) * p.nc + n) * p.H + h;
}

// element (channel i, token t) of a transposed [kD][kC] chunk: 16-byte
// pieces of a row XOR-swizzled by the row
__device__ __forceinline__ int swz(int i, int t) {
  return i * kC + ((((t >> 2) ^ (i & 15))) << 2) + (t & 3);
}

__device__ __forceinline__ float4 ld4(const float* base, int i, int t0) {
  return *reinterpret_cast<const float4*>(base + swz(i, t0));
}

__device__ __forceinline__ float at(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 2)
    kda_intra_kernel(const ChunkParams p) {
  extern __shared__ __align__(16) float smem[];
  float* sG = smem;               // G, transposed
  float* sK = sG + kD * kC;       // k, transposed
  float* sQ = sK + kD * kC;       // q, transposed
  float* sA = sQ + kD * kC;       // [kC][kC]: A
  float* sB = sA + kC * kC;       // [kC]: beta

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = n * kC;
  const int rows = min(kC, p.S - t0);
  const int tid = threadIdx.x;
  const long long cell = cell_of(p, b, n, h);

  for (int idx = tid; idx < kC * kD; idx += kThreads) {
    const int r = idx / kD, c = idx % kD;
    float kk = 0.f, qq = 0.f, gg = 0.f;
    if (r < rows) {
      const long long t = t0 + r;
      kk = __bfloat162float(p.k[b * p.k_sb + t * p.k_ss + h * p.k_sh + c]);
      qq = __bfloat162float(p.q[b * p.q_sb + t * p.q_ss + h * p.q_sh + c]);
      gg = p.g[((b * static_cast<long long>(p.S) + t) * p.H + h) * kD + c];
    }
    sK[swz(c, r)] = kk;
    sQ[swz(c, r)] = qq;
    sG[swz(c, r)] = gg;
  }
  if (tid < kC) {
    const long long row = b * static_cast<long long>(p.S) + t0 + tid;
    sB[tid] = tid < rows ? p.beta[row * p.H + h] : 0.f;
  }
  __syncthreads();

  if (tid < kD) {  // G: the cumulative sum over the chunk, a channel each
    float acc = 0.f;
    for (int r = 0; r < kC; ++r) {
      acc += sG[swz(tid, r)];
      sG[swz(tid, r)] = acc;
    }
  }
  __syncthreads();

  {  // A and M, a 4 x 4 tile of (t, s) pairs a thread
    const int tt = (tid / (kC / 4)) * 4, ts = (tid % (kC / 4)) * 4;
    float a[4][4], mm[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = mm[r][c] = 0.f;
    if (ts <= tt) {
#pragma unroll 2
      for (int i = 0; i < kD; ++i) {
        const float4 gt = ld4(sG, i, tt), kt = ld4(sK, i, tt);
        const float4 qt = ld4(sQ, i, tt), gs = ld4(sG, i, ts);
        const float4 ks = ld4(sK, i, ts);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // pairs above the diagonal are clamped, then masked below
            const float e =
                __expf(fminf(at(gt, r) - at(gs, c), 0.f)) * at(ks, c);
            a[r][c] = fmaf(at(kt, r), e, a[r][c]);
            mm[r][c] = fmaf(at(qt, r), e, mm[r][c]);
          }
        }
      }
    }
    float* mout = p.m + cell * kC * kC;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = tt + r;
      float4 av, mv;
      av.x = ts + 0 < t ? sB[t] * a[r][0] : 0.f;
      av.y = ts + 1 < t ? sB[t] * a[r][1] : 0.f;
      av.z = ts + 2 < t ? sB[t] * a[r][2] : 0.f;
      av.w = ts + 3 < t ? sB[t] * a[r][3] : 0.f;
      mv.x = ts + 0 <= t ? mm[r][0] : 0.f;
      mv.y = ts + 1 <= t ? mm[r][1] : 0.f;
      mv.z = ts + 2 <= t ? mm[r][2] : 0.f;
      mv.w = ts + 3 <= t ? mm[r][3] : 0.f;
      *reinterpret_cast<float4*>(sA + t * kC + ts) = av;
      *reinterpret_cast<float4*>(mout + t * kC + ts) = mv;
    }
  }

  {  // Gamma Q, K exp(G_C - G) and Gamma_C to scratch
    float* qg = p.qg + cell * kC * kD;
    float* kend = p.kend + cell * kC * kD;
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int r = idx / kD, c = idx % kD;
      const float gr = sG[swz(c, r)];
      qg[idx] = sQ[swz(c, r)] * __expf(gr);
      kend[idx] = sK[swz(c, r)] * __expf(sG[swz(c, kC - 1)] - gr);
    }
    if (tid < kD) p.gamma[cell * kD + tid] = __expf(sG[swz(tid, kC - 1)]);
  }
  __syncthreads();

  {  // (I + A) X = R by forward substitution, a column of X a thread, in
     // registers: columns 0..127 are W's (R = beta Gamma k), 128..255 U0's
     // (R = beta v)
    const int col = tid % kD;
    const bool is_w = tid < kD;
    float x[kC];
#pragma unroll
    for (int t4 = 0; t4 < kC; t4 += 4) {
      const float4 gq = ld4(sG, col, t4), kq = ld4(sK, col, t4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t4 + r;
        float rhs;
        if (is_w) {
          rhs = __expf(at(gq, r)) * at(kq, r);
        } else {
          rhs = t < rows ? __bfloat162float(
                               p.v[b * p.v_sb + (t0 + t) * p.v_ss +
                                   h * p.v_sh + col])
                         : 0.f;
        }
        x[t] = sB[t] * rhs;
      }
    }
#pragma unroll
    for (int t = 1; t < kC; ++t) {
      float acc = x[t];
      const float* arow = sA + t * kC;
#pragma unroll
      for (int s4 = 0; s4 < t; s4 += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(arow + s4);
        acc = fmaf(-a4.x, x[s4], acc);
        if (s4 + 1 < t) acc = fmaf(-a4.y, x[s4 + 1], acc);
        if (s4 + 2 < t) acc = fmaf(-a4.z, x[s4 + 2], acc);
        if (s4 + 3 < t) acc = fmaf(-a4.w, x[s4 + 3], acc);
      }
      x[t] = acc;
    }
    float* dst = (is_w ? p.w : p.u0) + cell * kC * kD + col;
#pragma unroll
    for (int t = 0; t < kC; ++t) dst[t * kD] = x[t];
  }
}

__global__ void __launch_bounds__(kThreads)
    kda_state_kernel(const ChunkParams p) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                // [kD][kVT]: the state's slice
  float* sR = sS + kD * kVT;       // [kC][kRS]: W, Gamma Q or K exp(..)
  float* sM = sR + kC * kRS;       // [kC][kMS]: M
  float* sU = sM + kC * kMS;       // [kC][kVT]: U0, then U
  float* sGam = sU + kC * kVT;     // [kD]: Gamma_C

  const int v0 = blockIdx.x * kVT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int j0 = (tid % (kVT / 2)) * 2;    // a thread's two value columns
  const int t0 = (tid / (kVT / 2)) * 4;    // its 4 rows of U and O
  const int i0 = (tid / (kVT / 2)) * 8;    // its 8 key rows of S
  float* state = p.state + (static_cast<long long>(b) * p.H + h) * kD * kD;

  for (int i = tid; i < kD * kVT; i += kThreads)
    sS[i] = state[(i / kVT) * kD + v0 + i % kVT];

  // rows [kC][kD] of src into sR, 16 bytes a load
  auto load_rows = [&](const float* src) {
    for (int i = tid; i < kC * kD / 4; i += kThreads) {
      const int r = i / (kD / 4), c4 = (i % (kD / 4)) * 4;
      *reinterpret_cast<float4*>(sR + r * kRS + c4) =
          *reinterpret_cast<const float4*>(src + r * kD + c4);
    }
  };
  // acc[r][c] += sum_i rows[t0 + r][i] S[i][j0 + c] over the kD channels
  auto times_state = [&](float (&acc)[4][2]) {
#pragma unroll 4
    for (int i = 0; i < kD; i += 4) {
      float4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const float4*>(sR + (t0 + r) * kRS + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 s =
            *reinterpret_cast<const float2*>(sS + (i + k) * kVT + j0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(at(w[r], k), s.x, acc[r][0]);
          acc[r][1] = fmaf(at(w[r], k), s.y, acc[r][1]);
        }
      }
    }
  };

  for (int n = 0; n < p.nc; ++n) {
    const long long cell = cell_of(p, b, n, h);
    load_rows(p.w + cell * kC * kD);
    const float* mrow = p.m + cell * kC * kC;
    for (int i = tid; i < kC * kC / 4; i += kThreads) {
      const int r = i / (kC / 4), c4 = (i % (kC / 4)) * 4;
      *reinterpret_cast<float4*>(sM + r * kMS + c4) =
          *reinterpret_cast<const float4*>(mrow + r * kC + c4);
    }
    const float* u0 = p.u0 + cell * kC * kD;
    for (int i = tid; i < kC * kVT / 4; i += kThreads) {
      const int r = i / (kVT / 4), c4 = (i % (kVT / 4)) * 4;
      *reinterpret_cast<float4*>(sU + r * kVT + c4) =
          *reinterpret_cast<const float4*>(u0 + r * kD + v0 + c4);
    }
    if (tid < kD) sGam[tid] = p.gamma[cell * kD + tid];
    __syncthreads();

    float acc[4][2] = {};  // U = U0 - W S
    times_state(acc);
    float u[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        u[r][c] = sU[(t0 + r) * kVT + j0 + c] - acc[r][c];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float2*>(sU + (t0 + r) * kVT + j0) =
          make_float2(u[r][0], u[r][1]);
    load_rows(p.qg + cell * kC * kD);
    __syncthreads();

    float o[4][2] = {};  // O = (Gamma Q) S + M U
    times_state(o);
#pragma unroll 4
    for (int s = 0; s < kC; s += 4) {
      float4 mr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mr[r] = *reinterpret_cast<const float4*>(sM + (t0 + r) * kMS + s);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 uu =
            *reinterpret_cast<const float2*>(sU + (s + k) * kVT + j0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][0] = fmaf(at(mr[r], k), uu.x, o[r][0]);
          o[r][1] = fmaf(at(mr[r], k), uu.y, o[r][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tok = n * kC + t0 + r;
      if (tok < p.S)
        *reinterpret_cast<__nv_bfloat162*>(
            p.o + ((static_cast<long long>(b) * p.S + tok) * p.H + h) * kD +
            v0 + j0) = __floats2bfloat162_rn(o[r][0], o[r][1]);
    }
    __syncthreads();
    load_rows(p.kend + cell * kC * kD);
    __syncthreads();

    // S <- Gamma_C S + (K exp(G_C - G))^T U, an 8 x 2 tile a thread
    float sv[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float2 s =
          *reinterpret_cast<const float2*>(sS + (i0 + r) * kVT + j0);
      sv[r][0] = sGam[i0 + r] * s.x;
      sv[r][1] = sGam[i0 + r] * s.y;
    }
#pragma unroll 4
    for (int s = 0; s < kC; ++s) {
      const float4 k0 = *reinterpret_cast<const float4*>(sR + s * kRS + i0);
      const float4 k1 = *reinterpret_cast<const float4*>(sR + s * kRS + i0 + 4);
      const float2 uu = *reinterpret_cast<const float2*>(sU + s * kVT + j0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sv[r][0] = fmaf(at(k0, r), uu.x, sv[r][0]);
        sv[r][1] = fmaf(at(k0, r), uu.y, sv[r][1]);
        sv[r + 4][0] = fmaf(at(k1, r), uu.x, sv[r + 4][0]);
        sv[r + 4][1] = fmaf(at(k1, r), uu.y, sv[r + 4][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<float2*>(sS + (i0 + r) * kVT + j0) =
          make_float2(sv[r][0], sv[r][1]);
    __syncthreads();
  }

  for (int i = tid; i < kD * kVT; i += kThreads)
    state[(i / kVT) * kD + v0 + i % kVT] = sS[i];
}

struct StepParams {
  const __nv_bfloat16* q;  // [B, H, D], D contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* g;     // [B, H, D] contiguous
  const float* beta;  // [B, H] contiguous
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  float* state;       // [B, H, D, D] contiguous, in place
  __nv_bfloat16* o;   // [B, H, D] contiguous
  int H;
};

__global__ void __launch_bounds__(kD) kda_step_kernel(const StepParams p) {
  __shared__ float sq[kD], sk[kD], sa[kD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long bh = static_cast<long long>(b) * p.H + h;
  sq[j] = __bfloat162float(p.q[b * p.q_sb + h * p.q_sh + j]);
  sk[j] = __bfloat162float(p.k[b * p.k_sb + h * p.k_sh + j]);
  sa[j] = __expf(p.g[bh * kD + j]);
  const float vj = __bfloat162float(p.v[b * p.v_sb + h * p.v_sh + j]);
  const float bt = p.beta[bh];
  __syncthreads();

  float* s = p.state + bh * kD * kD + j;
  float col[kD];
  float u = 0.f;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    col[i] = s[i * kD] * sa[i];
    u = fmaf(sk[i], col[i], u);
  }
  const float d = bt * (vj - u);
  float o = 0.f;
#pragma unroll
  for (int i = 0; i < kD; ++i) {
    col[i] = fmaf(sk[i], d, col[i]);
    o = fmaf(sq[i], col[i], o);
    s[i * kD] = col[i];
  }
  p.o[bh * kD + j] = __float2bfloat16(o);
}

struct PrepParams {
  const __nv_bfloat16* qkv;     // [B, S, 3 H D] contiguous
  const __nv_bfloat16* conv_w;  // [kW, 3 H D] contiguous
  const __nv_bfloat16* tail;    // [B, kW - 1, 3 H D] contiguous, or null
  const __nv_bfloat16* f;       // [B, S, H D] contiguous
  const __nv_bfloat16* b_raw;   // [B, S, H] contiguous
  const float* dt_bias;         // [H D]
  const float* a_log;           // [H]
  __nv_bfloat16* q;  // [B, S, H, D] contiguous
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  float* g;     // [B, S, H, D]
  float* beta;  // [B, S, H]
  int S, H;
};

constexpr int kW = 4;  // the short convs' width
constexpr float kL2Eps = 1e-6f;

// the sum of v over the block's kD threads
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const float total = red[0] + red[1] + red[2] + red[3];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + __expf(-y)); }

// a block a (head, token, sequence), a channel of the head a thread: q, k
// and v's convs over kW taps (the tail's rows before the sequence), SiLU,
// q and k L2-normalised (q times kD^-1/2), the decay g and beta
__global__ void __launch_bounds__(kD) kda_prep_kernel(const PrepParams p) {
  __shared__ float red[kD / 32];
  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z, c = threadIdx.x;
  const int width = 3 * p.H * kD;
  const long long bt = static_cast<long long>(b) * p.S + t;
  float y[3];
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const int ch = part * p.H * kD + h * kD + c;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int src = t - (kW - 1) + i;
      float z = 0.f;
      if (src >= 0)
        z = __bfloat162float(p.qkv[(bt - (kW - 1) + i) * width + ch]);
      else if (p.tail)
        z = __bfloat162float(
            p.tail[(static_cast<long long>(b) * (kW - 1) + kW - 1 + src) *
                       width + ch]);
      acc = fmaf(__bfloat162float(p.conv_w[i * width + ch]), z, acc);
    }
    y[part] = silu(acc);
  }
  const float qs = rsqrtf(block_sum(y[0] * y[0], red) + kL2Eps) *
                   rsqrtf(static_cast<float>(kD));
  const float ks = rsqrtf(block_sum(y[1] * y[1], red) + kL2Eps);
  const long long o = (bt * p.H + h) * kD + c;
  p.q[o] = __float2bfloat16(y[0] * qs);
  p.k[o] = __float2bfloat16(y[1] * ks);
  p.v[o] = __float2bfloat16(y[2]);
  const float fz = __bfloat162float(p.f[bt * p.H * kD + h * kD + c]) +
                   p.dt_bias[h * kD + c];
  const float sp = fz > 20.f ? fz : log1pf(__expf(fz));  // softplus
  p.g[o] = -__expf(p.a_log[h]) * sp;
  if (c == 0)
    p.beta[bt * p.H + h] =
        1.f / (1.f + __expf(-__bfloat162float(p.b_raw[bt * p.H + h])));
}

struct OutParams {
  const __nv_bfloat16* o;      // [B, S, H, D] contiguous
  const __nv_bfloat16* g_raw;  // [B, S, H D] contiguous
  const float* g_bias;         // [H D]
  const float* o_norm;         // [D]
  __nv_bfloat16* out;          // [B, S, H D] contiguous
  int H;
  float eps;
};

// a block a (head, token), a value a thread: o RMS-normalised over the
// head, times o_norm, times sigmoid(g_raw + g_bias)
__global__ void __launch_bounds__(kD) kda_out_kernel(const OutParams p) {
  __shared__ float red[kD / 32];
  const int h = blockIdx.x, c = threadIdx.x;
  const long long i =
      (static_cast<long long>(blockIdx.y) * p.H + h) * kD + c;
  const float o = __bfloat162float(p.o[i]);
  const float r = rsqrtf(block_sum(o * o, red) / kD + p.eps);
  const float gate =
      1.f / (1.f + __expf(-(__bfloat162float(p.g_raw[i]) +
                             p.g_bias[h * kD + c])));
  p.out[i] = __float2bfloat16(o * r * p.o_norm[c] * gate);
}

bool configured[64];  // the chunk kernels' shared memory limits, a device

}  // namespace

// q, k, v: [B, S, H, 128] bf16 by strides (batch, token, head; the last
// dim contiguous); g: [B, S, H, 128] f32 and beta: [B, S, H] f32
// contiguous; scratch w, u0, qg, kend: [B, nc, H, 64, 128] f32, m: [B, nc,
// H, 64, 64] f32, gamma: [B, nc, H, 128] f32 with nc = ceil(S / 64);
// state: [B, H, 128, 128] f32 contiguous, read as the state entering the
// sequence and overwritten with the one leaving it; o: [B, S, H, 128] bf16
// contiguous. Two launches on stream; returns cudaGetLastError() (or the
// error of setting the shared memory limits, once a device).
extern "C" int kda_chunk(const void* q, const void* k, const void* v,
                         const float* g, const float* beta, float* w,
                         float* u0, float* qg, float* kend, float* m,
                         float* gamma, float* state, void* o, long long q_sb,
                         long long q_ss, long long q_sh, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, int B, int S, int H,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kda_intra_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemIntra);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kda_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemState);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int nc = (S + kC - 1) / kC;
  const ChunkParams p{static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v),
                      g, beta, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                      v_ss, v_sh, w, u0, qg, kend, m, gamma, state,
                      static_cast<__nv_bfloat16*>(o), S, H, nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kda_intra_kernel<<<dim3(nc, H, B), kThreads, kSmemIntra, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_state_kernel<<<dim3(kD / kVT, H, B), kThreads, kSmemState, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v: [B, H, 128] bf16 by strides (batch, head; the last dim
// contiguous); g: [B, H, 128] f32 and beta: [B, H] f32 contiguous; state:
// [B, H, 128, 128] f32 contiguous, stepped in place; o: [B, H, 128] bf16
// contiguous. One launch on stream; returns cudaGetLastError().
extern "C" int kda_step(const void* q, const void* k, const void* v,
                        const float* g, const float* beta, float* state,
                        void* o, long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long v_sb,
                        long long v_sh, int B, int H, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const StepParams p{static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v),
                     g, beta, q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, state,
                     static_cast<__nv_bfloat16*>(o), H};
  kda_step_kernel<<<dim3(H, B), kD, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

// The work around the delta rule, one launch each. kda_prep: qkv [B, S,
// 3 H 128] bf16, conv_w [4, 3 H 128] bf16, tail [B, 3, 3 H 128] bf16 or
// null (zeros), f [B, S, H 128] bf16, b_raw [B, S, H] bf16, dt_bias [H 128]
// and a_log [H] f32, all contiguous; writes q, k, v [B, S, H, 128] bf16, g
// [B, S, H, 128] f32 and beta [B, S, H] f32. kda_out: o [B, S, H, 128] bf16,
// g_raw [B, S, H 128] bf16, g_bias [H 128] and o_norm [128] f32; writes out
// [B, S, H 128] bf16. Each returns cudaGetLastError().
extern "C" int kda_prep(const void* qkv, const void* conv_w,
                        const void* tail, const void* f, const void* b_raw,
                        const float* dt_bias, const float* a_log, void* q,
                        void* k, void* v, float* g, float* beta, int B,
                        int S, int H, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PrepParams p{static_cast<const __nv_bfloat16*>(qkv),
                     static_cast<const __nv_bfloat16*>(conv_w),
                     static_cast<const __nv_bfloat16*>(tail),
                     static_cast<const __nv_bfloat16*>(f),
                     static_cast<const __nv_bfloat16*>(b_raw),
                     dt_bias, a_log,
                     static_cast<__nv_bfloat16*>(q),
                     static_cast<__nv_bfloat16*>(k),
                     static_cast<__nv_bfloat16*>(v), g, beta, S, H};
  kda_prep_kernel<<<dim3(H, S, B), kD, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kda_out(const void* o, const void* g_raw,
                       const float* g_bias, const float* o_norm, void* out,
                       int rows, int H, float eps, void* stream) {
  if (rows <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const OutParams p{static_cast<const __nv_bfloat16*>(o),
                    static_cast<const __nv_bfloat16*>(g_raw), g_bias, o_norm,
                    static_cast<__nv_bfloat16*>(out), H, eps};
  kda_out_kernel<<<dim3(H, rows), kD, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
