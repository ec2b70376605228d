// SSD intra-chunk kernel (Mamba2 state-space duality): for each
// (batch, chunk z, head h) of a [B, S, H, P] sequence cut into chunks of Q
//
//   da_cs[q]    = sum_{j <= q} dt[j] a[h]                          (f32)
//   y_diag[q,p] = sum_{k <= q} (C_q . B_k) exp(da_cs[q] - da_cs[k]) xdt[k,p]
//   states[p,n] = sum_k exp(da_cs[Q-1] - da_cs[k]) B_k[n] xdt[k,p]
//   decay       = exp(da_cs[Q-1])
//
// with xdt = x dt. All three outputs are f32.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py `_ssd_chunk_kernel` /
//   `ssd_intra_chunk_call` (the pallas_call at :92). The inter-chunk
//   recurrence stays in torch ops (ops.py), as it stays in jnp there.
//
// Rounding points, as the TPU kernel has them (T = x's type, f32 or bf16):
// xdt = T(x * T(dt)); cb = C.B accumulated in f32 (bf16 products are exact
// in f32); att = T(cb * L) before the PV product, accumulated in f32;
// decay_states = T(exp(da_cs[Q-1] - da_cs[k])) and T(B_k * decay_states)
// before the state product, accumulated in f32. Head h reads group
// h / (H / G), as jnp.repeat does. exp is formed only where k <= q: the
// masked differences are positive and large (A spans -1 ... -16), and are
// never exponentiated.
//
// Layout. The TPU block held every head of a (batch, chunk) cell: H Q^2 f32
// = 12.6 MiB at mamba2-780m's shape, far above the 227 KB of shared memory
// a Hopper block may use. Here heads and 64-row q tiles are on the grid:
// blockIdx = (x: 1 + ceil(Q/64), y: head, z: batch * chunk). Block x = 0
// computes the chunk's states and decay for its head; block x = 1 + t
// computes y_diag's rows of q tile t (heaviest tile first), looping over
// the 64-key tiles k <= q and skipping every tile above the diagonal, where
// L is 0. Each block forms its head's da_cs over the chunk in shared memory
// (a warp scan). 256 threads in a 16 x 16 layout; each owns a 4 x 4 tile of
// C.B scores, a 4 x P/16 tile of y_diag, or a 4 x N/16 tile of states, with
// operands staged in shared memory as f32 (row stride N + 1 for B and C, so
// 16 threads reading 16 rows at one n hit 16 banks). Q is a run-time value
// (8, 16, 32, 256; rows past Q are zero-filled); P (16, 64) and N (8, 16,
// 64, 128) are compiled in.
//
// What bounds it on an H100. At mamba2-780m's scoring shape (B 2, S 2048,
// H 48, P 64, N 128, G 1, Q 256, bf16 x/B/C, f32 dt and outputs) the
// function moves ~103 MB (x, dt, B, C read once; y_diag, states written
// once: 0.031 ms at 3.35 TB/s) and needs ~6.6 GFLOP (C.B once per group,
// the triangle's PV product and the state product per head: 0.007 ms at the
// 989 TFLOP/s bf16 tensor-core peak), so bytes bound it. This first version
// does its products with f32 FMAs on the CUDA cores, recomputes C.B for
// every head (with G = 1 it is the same for all 48) and is limited by
// shared-memory loads (8 loads per 16 FMAs in the C.B loop): it is right
// first. Sharing C.B across the heads of a group, tensor-core tiles (wgmma
// on bf16 B/C/x) and TMA-fed staging are the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // q rows and keys per tile
constexpr int kMaxQ = 256;    // largest chunk the da_cs buffers hold
constexpr int kAP = kTile + 1;  // padded row stride of the att tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// round an f32 value to T and back (identity for f32)
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Params {
  const void* x;   // [B, S, H, P], T
  const float* dt;  // [B, S, H]
  const float* a;   // [H]
  const void* b;   // [B, S, G, N], T
  const void* c;   // [B, S, G, N], T
  float* y;        // [B, S, H, P] contiguous
  float* st;       // [B, nc, H, P, N] contiguous
  float* dec;      // [B, nc, H] contiguous
  long long x_sb, x_ss, x_sh;     // element strides of x (P contiguous)
  long long dt_sb, dt_ss;         // of dt (H contiguous)
  long long bc_sb, bc_ss, bc_sg;  // of b and c (N contiguous)
  int B, S, H, G, Q, nc;
};

// Stage rows [k0, k0 + kTile) of the chunk's xdt = T(x T(dt)) into
// xs[kTile][P]; rows past Q are zero.
template <typename T, int P>
__device__ void stage_xdt(const Params& p, const T* xg, const float* dts,
                          int k0, float* xs) {
  for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
    const int r = i / P, pp = i % P, k = k0 + r;
    float v = 0.f;
    if (k < p.Q) {
      v = round_t<T>(to_f32(xg[k * p.x_ss + pp]) * round_t<T>(dts[k]));
    }
    xs[i] = v;
  }
}

template <typename T, int P, int N>
__device__ void chunk_states(const Params& p, const T* xg, const T* bg,
                             const float* dts, const float* cs, float* smem,
                             int b, int z, int h) {
  constexpr int CM = N >= 16 ? N / 16 : 1;  // n columns a thread owns
  constexpr int NT = N / CM;                // threads along n
  constexpr int PT = P / 4;                 // threads along p (4 rows each)
  float* bds = smem;               // [kTile][N]
  float* xs = bds + kTile * N;     // [kTile][P]
  const int tid = threadIdx.x, tr = tid / NT, tc = tid % NT;
  const bool active = tr < PT;
  const float last = cs[p.Q - 1];

  float acc[4][CM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Q; k0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i % N, k = k0 + r;
      float v = 0.f;
      if (k < p.Q) {
        const float ds = round_t<T>(expf(last - cs[k]));
        v = round_t<T>(to_f32(bg[k * p.bc_ss + n]) * ds);
      }
      bds[i] = v;
    }
    stage_xdt<T, P>(p, xg, dts, k0, xs);
    __syncthreads();
    if (active) {
      const int kn = min(kTile, p.Q - k0);
      for (int k = 0; k < kn; ++k) {
        float xv[4], bv[CM];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[k * P + tr + PT * i];
#pragma unroll
        for (int j = 0; j < CM; ++j) bv[j] = bds[k * N + tc + NT * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
    }
  }
  const long long cell = (static_cast<long long>(b) * p.nc + z) * p.H + h;
  if (active) {
    float* out = p.st + cell * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) out[(tr + PT * i) * N + tc + NT * j] = acc[i][j];
  }
  if (tid == 0) p.dec[cell] = expf(last);
}

template <typename T, int P, int N>
__device__ void chunk_diag(const Params& p, const T* xg, const T* bg,
                           const T* cg, const float* dts, const float* cs,
                           float* smem, int b, int z, int h, int qt) {
  constexpr int NP = N + 1;
  constexpr int PJ = P / 16;  // y columns a thread owns
  float* cq = smem;              // [kTile][NP], C rows of this q tile
  float* bk = cq + kTile * NP;   // [kTile][NP], B rows of a key tile
  float* xs = bk + kTile * NP;   // [kTile][P], xdt rows of a key tile
  float* att = xs + kTile * P;   // [kTile][kAP]
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int q0 = qt * kTile;

  for (int i = tid; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i % N, q = q0 + r;
    cq[r * NP + n] = q < p.Q ? to_f32(cg[q * p.bc_ss + n]) : 0.f;
  }

  float acc[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  // key tiles 0 .. qt: every tile above the diagonal is skipped
  for (int k0 = 0; k0 <= q0; k0 += kTile) {
    __syncthreads();  // the previous tile's reads of bk, xs, att are done
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i % N, k = k0 + r;
      bk[r * NP + n] = k < p.Q ? to_f32(bg[k * p.bc_ss + n]) : 0.f;
    }
    stage_xdt<T, P>(p, xg, dts, k0, xs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cq[(tr + 16 * i) * NP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bk[(tc + 16 * j) * NP + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tc + 16 * j;
        float v = 0.f;
        if (k <= q && q < p.Q) v = round_t<T>(s[i][j] * expf(cs[q] - cs[k]));
        att[(tr + 16 * i) * kAP + tc + 16 * j] = v;
      }
    }
    __syncthreads();

    const int kn = min(kTile, p.Q - k0);
    for (int k = 0; k < kn; ++k) {
      float av[4], xv[PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = att[(tr + 16 * i) * kAP + k];
#pragma unroll
      for (int j = 0; j < PJ; ++j) xv[j] = xs[k * P + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
  }

  const long long s0 = static_cast<long long>(z) * p.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + tr + 16 * i;
    if (q >= p.Q) continue;
    float* out = p.y + ((static_cast<long long>(b) * p.S + s0 + q) * p.H + h) * P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) out[tc + 16 * j] = acc[i][j];
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Params p) {
  extern __shared__ float smem[];
  float* dts = smem;          // [kMaxQ] dt of the chunk, this head
  float* cs = dts + kMaxQ;    // [kMaxQ] da_cs
  float* work = cs + kMaxQ;

  const int h = blockIdx.y;
  const int b = blockIdx.z / p.nc, z = blockIdx.z % p.nc;
  const int g = h / (p.H / p.G);
  const long long s0 = static_cast<long long>(z) * p.Q;
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + s0 * p.x_ss + h * p.x_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.bc_sb + s0 * p.bc_ss + g * p.bc_sg;
  const T* cg = static_cast<const T*>(p.c) + b * p.bc_sb + s0 * p.bc_ss + g * p.bc_sg;
  const float* dtg = p.dt + b * p.dt_sb + s0 * p.dt_ss + h;
  const float a = p.a[h];

  for (int i = threadIdx.x; i < p.Q; i += kThreads) {
    const float d = dtg[i * p.dt_ss];
    dts[i] = d;
    cs[i] = d * a;
  }
  __syncthreads();
  // inclusive scan of cs over the chunk by warp 0: each lane scans its
  // run of ceil(Q / 32) values, the lanes' totals are scanned by shuffles
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (p.Q + 31) / 32, base = lane * per;
    float run = 0.f;
    for (int e = 0; e < per; ++e) {
      const int i = base + e;
      if (i < p.Q) {
        run += cs[i];
        cs[i] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int e = 0; e < per; ++e) {
      const int i = base + e;
      if (i < p.Q) cs[i] += excl;
    }
  }
  __syncthreads();

  if (blockIdx.x == 0) {
    chunk_states<T, P, N>(p, xg, bg, dts, cs, work, b, z, h);
  } else {
    const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tile first
    chunk_diag<T, P, N>(p, xg, bg, cg, dts, cs, work, b, z, h, qt);
  }
}

template <int P, int N>
constexpr int smem_floats() {
  constexpr int diag = 2 * kTile * (N + 1) + kTile * P + kTile * kAP;
  constexpr int states = kTile * N + kTile * P;
  return 2 * kMaxQ + (diag > states ? diag : states);
}

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t s) {
  const int smem = smem_floats<P, N>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(1 + (p.Q + kTile - 1) / kTile, p.H, p.B * p.nc);
  ssd_chunk_kernel<T, P, N><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, P, 8>(p, s);
    case 16: return launch<T, P, 16>(p, s);
    case 64: return launch<T, P, 64>(p, s);
    case 128: return launch<T, P, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const Params& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(p, N, s);
    case 64: return dispatch_n<T, 64>(p, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [B, S, H, P] and b, c: [B, S, G, N] of one type (dtype 0 = float32,
// 1 = bfloat16), dt: [B, S, H] f32 and a: [H] f32, each given by its element
// strides (the last axis contiguous); y: [B, S, H, P], st: [B, S/Q, H, P, N]
// and dec: [B, S/Q, H], f32, contiguous. Q in {8, 16, 32, 256} divides S;
// P in {16, 64}; N in {8, 16, 64, 128}. Returns cudaGetLastError().
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, float* y,
                               float* st, float* dec, int B, int S, int H,
                               int P, int G, int N, int Q, long long x_sb,
                               long long x_ss, long long x_sh,
                               long long dt_sb, long long dt_ss,
                               long long bc_sb, long long bc_ss,
                               long long bc_sg, int dtype, void* stream) {
  if (Q <= 0 || Q > kMaxQ || S % Q != 0 || G <= 0 || H % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{x, dt, a, b, c, y, st, dec, x_sb, x_ss, x_sh, dt_sb, dt_ss,
                 bc_sb, bc_ss, bc_sg, B, S, H, G, Q, S / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, P, N, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
