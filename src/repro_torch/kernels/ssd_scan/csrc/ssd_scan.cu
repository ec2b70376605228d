// SSD (Mamba2 state-space duality) on the card: the intra-chunk kernel and
// the inter-chunk state pass.
//
// ssd_intra_chunk: for each (batch, chunk z, head h) of a [B, S, H, P]
// sequence cut into chunks of Q
//
//   da_cs[q]    = sum_{j <= q} dt[j] a[h]                          (f32)
//   y_diag[q,p] = sum_{k <= q} (C_q . B_k) exp(da_cs[q] - da_cs[k]) xdt[k,p]
//   states[p,n] = sum_k exp(da_cs[Q-1] - da_cs[k]) B_k[n] xdt[k,p]
//   decay       = exp(da_cs[Q-1])
//
// with xdt = x dt. All three outputs are f32.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py `_ssd_chunk_kernel` /
//   `ssd_intra_chunk_call` (the pallas_call at :92).
//
// ssd_state_pass: the recurrence across chunks that the reference runs as a
// lax.scan in jnp (src/repro/kernels/ssd_scan/ops.py `ssd_full`):
// prev[z] = state; state = state * decay[z] + states[z], in one launch.
//
// Rounding points, as the TPU kernel has them (T = x's type, f32 or bf16):
// xdt = T(x * T(dt)); cb = C.B accumulated in f32 (bf16 products are exact
// in f32); att = T(cb * L) before the PV product, accumulated in f32;
// decay_states = T(exp(da_cs[Q-1] - da_cs[k])) and T(B_k * decay_states)
// before the state product, accumulated in f32. Head h reads group
// h / (H / G), as jnp.repeat does. A masked entry (k > q, or a row past Q)
// is 0 whatever its exponential: the masked differences are positive and
// large (A spans -1 ... -16), so the f32 kernel never forms them, and the
// bf16 kernel sets them to 0 after forming a whole 16-key step. Only the
// order of the f32 sums differs between the two kernels below and the
// reference (and the bf16 kernel takes exp(d) as exp2(d log2 e), within a
// few f32 ulps, far below the bf16 step of att).
//
// What bounds it on an H100. At mamba2-780m's scoring shape (B 2, S 2048,
// H 48, P 64, N 128, G 1, Q 256, bf16 x/B/C, f32 dt and outputs) the
// function moves ~103 MB (x, dt, B, C read once; y_diag, states written
// once: 0.031 ms at 3.35 TB/s) and needs ~6.6 GFLOP (C.B once per group,
// the triangle's PV product and the state product per head: 0.007 ms at the
// 989 TFLOP/s bf16 tensor-core peak), so bytes bound it.
//
// bf16: the tensor-core kernel (namespace tc). The first port (the f32
// kernel below, which ran bf16 too: 0.954 ms at that shape) did f32 FMAs
// on the CUDA cores, formed C.B once for every head (with G = 1 the same
// for all 48), and its C.B loop was bound by shared-memory loads. Here:
//
// - C.B once a group of heads, not once a head. A block owns one 64-row q
//   tile of one (batch, chunk) and a slice of the heads of one group. It
//   forms that tile's C.B scores against every key tile at or below the
//   diagonal once, in f32, keeps them in shared memory (in the MMA
//   accumulator's own register order, 128-bit loads, no bank conflicts;
//   64 KB at Q 256), then loops over the slice's heads, each reading those
//   scores. At mamba2's shape
//   only B nc (1 + Q/64) = 80 (batch, chunk, tile) cells exist for 132
//   SMs, so the heads of a group are cut into slices (kernel.py
//   `ssd_slice`: the fewest slices, a divisor of the group's heads and at
//   most 8 heads each, that give four blocks an SM): 8 slices of 6 heads,
//   640 blocks, C.B formed 8 times, not 48.
// - Every product on the tensor cores, bf16 in, f32 accumulation: mma.sync
//   m16n8k16 with ldmatrix. att = T(scores * exp(cs_h[q] - cs_h[k])) is
//   formed in registers from the stored scores (an m16n8 accumulator pair
//   is an m16k16 A fragment) and is the A operand of the PV product, with
//   xdt as B (ldmatrix.trans from its [key][p] tile). The state product
//   states[h] = xdt^T . T(B * T(decay_h)) takes both operands from
//   [key][.] tiles by ldmatrix.trans (xdt^T is A read MN-major). Why
//   mma.sync, not wgmma: a warp owns 16 q rows, and its scores, att and PV
//   fragments never leave it (no warpgroup-wide 64-row fragment to hand
//   round); the state product's transposed operands are one ldmatrix.trans
//   each, with no hand-written 128-byte swizzle for tiles that threads
//   compute (xdt, B * decay are formed in the staging pass, so TMA could not
//   lay them down); and bytes bound the function, so the half of wgmma's
//   peak that mma.sync reaches leaves the products far below the bound.
// - Tiles above the diagonal are skipped, and inside the diagonal tile a
//   warp skips the 16-key steps past its last row; only the diagonal tile
//   (and rows past Q) is masked. Blocks are issued heaviest first (the
//   state blocks, then the q tiles from the last).
// - 256 threads, two blocks an SM (16 warps): warp w owns q rows 16 (w %
//   4) of the tile, and in the PV product the block's two halves (w / 4)
//   take alternate heads of the slice, each with its own two-stage ring
//   of 64-key x tiles (tile i + 1 copied by cp.async while tile i is
//   computed) and its own named barrier. With 128 threads on one head at
//   a time (8 warps an SM) the att loop's latencies were not hidden: it
//   ran 1.7x slower at mamba2's shape (PERF.md).
// - x, B and C come by 16-byte cp.async (the wrapper refuses tensors that
//   are not 16-byte aligned with strides of 8 elements), zero-filled past
//   Q and N (N 8 is padded to the MMA's k of 16, Q 8/16/32 fill a 64-row
//   tile with zero rows); each thread then turns the x vectors it copied
//   into xdt = T(x T(dt)) in place, so x cannot go from the copy straight
//   into the MMA. A state job copies its chunk's B once (into the score
//   area, which it does not use) and forms T(B T(decay_h)) from it per
//   head. Row strides are padded by 16 bytes, so the 8 rows an ldmatrix
//   reads fall in 8 distinct bank groups. ~109 KB of shared memory a block
//   at mamba2's shape.
//
// f32: the CUDA-core kernel (namespace cc), the first port's kernel, kept as
// it was for f32's limits: a float32 product on the tensor cores would be
// TF32, and mamba2's f32 prefill check sits 4.66e-3 from the recurrence
// against a 5e-3 limit, so its C.B sum keeps its n order. Heads and 64-row
// q tiles are on the grid: blockIdx = (x: 1 + ceil(Q/64), y: head, z: batch
// * chunk). Block x = 0 computes the chunk's states and decay for its head;
// block x = 1 + t computes y_diag's rows of q tile t (heaviest tile first),
// looping over the 64-key tiles k <= q and skipping every tile above the
// diagonal, where L is 0. 256 threads in a 16 x 16 layout; each owns a
// 4 x 4 tile of C.B scores, a 4 x P/16 tile of y_diag, or a 4 x N/16 tile
// of states, with operands staged in shared memory as f32 (row stride N + 1
// for B and C, so 16 threads reading 16 rows at one n hit 16 banks).
//
// Both kernels form each head's da_cs over the chunk in shared memory with
// the same warp scan, so their cs are bitwise equal. Q is a run-time value
// (8, 16, 32, 256); P (16, 64) and N (8, 16, 64, 128) are compiled in.
//
// The state pass: one thread per (b, h, p, n) element walks the nc chunks,
// writes the state entering each chunk and returns the final one, with
// __fmul_rn / __fadd_rn so no FMA is contracted: it is bitwise the torch
// loop it replaces (ref.py `ssd_state_pass_ref`), one launch a layer
// instead of three a chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;     // q rows and keys per tile
constexpr int kMaxQ = 256;    // largest chunk the da_cs buffers hold

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
  int hs;  // tc: heads a block (a divisor of H / G)
};

// cs[0 .. Q) <- its inclusive prefix sum, by one warp: each lane scans its
// run of ceil(Q / 32) values, the lanes' totals are scanned by shuffles
__device__ __forceinline__ void warp_scan(float* cs, int Q, int lane) {
  const int per = (Q + 31) / 32, base = lane * per;
  float run = 0.f;
  for (int e = 0; e < per; ++e) {
    const int i = base + e;
    if (i < Q) {
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
    if (i < Q) cs[i] += excl;
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
namespace cc {

constexpr int kThreads = 256;
constexpr int kAP = kTile + 1;  // padded row stride of the att tile

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
  if (threadIdx.x < 32) warp_scan(cs, p.Q, threadIdx.x);
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

template <int P, int N>
int launch(const Params& p, cudaStream_t s) {
  const int smem = smem_floats<P, N>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<float, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(1 + (p.Q + kTile - 1) / kTile, p.H, p.B * p.nc);
  ssd_chunk_kernel<float, P, N><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
namespace tc {

using bf16 = __nv_bfloat16;
// 8 warps: warp w owns q rows 16 (w % 4) .. + 15 of a tile; in the PV
// product the two halves of the block (w / 4) take alternate heads
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;
constexpr int kMaxSlice = 8;   // heads a block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes (8 bf16) of global memory into shared memory by cp.async
// (complete at the next cp_wait), zeros where not valid. `base` is any
// valid global address (read by none).
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src,
                                     const bf16* base, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(valid ? src : base),
                  "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `n` of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}
// a barrier of the 128 threads of one half of the block (ids 1 and 2)
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + half), "r"(kHalf) : "memory");
}

// 8 bf16 of shared memory times an f32 scale, rounded to bf16 in place
__device__ __forceinline__ void scale8(bf16* v, float s) {
  uint4 raw = *reinterpret_cast<const uint4*>(v);
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    h2[e] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  *reinterpret_cast<uint4*>(v) = raw;
}

template <int P, int N>
struct Shape {
  static constexpr int NP = N < 16 ? 16 : N;  // N padded to the MMA's k
  static constexpr int CS = NP + 8;   // row stride (elements) of C, B tiles
  static constexpr int XS = P + 8;    // of xdt tiles
  static constexpr int BS = N + 8;    // of the B * decay tile
};

// Copy rows [k0, k0 + kTile) of a chunk's [Q][N] C or B (row stride ss)
// into dst[kTile][CS] as they are; rows past Q, columns past N are zeros.
template <int P, int N>
__device__ void copy_bc(const bf16* src, long long ss, int k0, int Q,
                        bf16* dst) {
  using S = Shape<P, N>;
  constexpr int V = S::NP / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kTile * V; i += kThreads) {
    const int r = i / V, v = i % V, k = k0 + r;
    cp16(dst + r * S::CS + 8 * v, src + k * ss + 8 * v, src,
         k < Q && 8 * v < N);
  }
}

// Copy rows [k0, k0 + kTile) of one head's x into dst[kTile][XS] (rows
// past Q zeros), by the `nt` threads of a team (this one its tt-th);
// xdt_rows then turns each thread's own copies into xdt.
template <int P, int N>
__device__ void copy_x(const Params& p, const bf16* xg, int k0, bf16* dst,
                       int tt, int nt) {
  using S = Shape<P, N>;
  constexpr int V = P / 8;
  for (int i = tt; i < kTile * V; i += nt) {
    const int r = i / V, v = i % V, k = k0 + r;
    cp16(dst + r * S::XS + 8 * v, xg + k * p.x_ss + 8 * v, xg, k < p.Q);
  }
}
// xdt = T(x T(dt)) in place over the vectors this thread copied; dth: the
// head's T(dt) over the chunk
template <int P, int N>
__device__ void xdt_rows(const Params& p, const bf16* dth, int k0,
                         bf16* dst, int tt, int nt) {
  using S = Shape<P, N>;
  constexpr int V = P / 8;
  for (int i = tt; i < kTile * V; i += nt) {
    const int r = i / V, v = i % V, k = k0 + r;
    if (k < p.Q) scale8(dst + r * S::XS + 8 * v, __bfloat162float(dth[k]));
  }
}

// One (batch, chunk, head slice): the state and decay of each head.
// Warps split the [P, N] output: P 64 gives each warp one 16-row m tile and
// every 8-column n tile; P 16 gives them one m tile and a share of the n
// tiles. K runs over the chunk's keys in 64-key tiles of xdt and of
// T(B T(decay)). The chunk's B is copied once (into the score area, which
// this job does not use); the x tiles go through a two-stage ring, tile
// i + 1 copied while tile i is computed, over every (head, key tile).
template <int P, int N>
__device__ void chunk_states(const Params& p, const bf16* xg0, const bf16* bg,
                             const float* cs, const bf16* dts, bf16* braw,
                             unsigned char* work, int b, int z, int h0) {
  using S = Shape<P, N>;
  constexpr int MT = P / 16;               // m tiles (1 or 4)
  constexpr int WM = MT < 4 ? MT : 4;      // warps along m
  constexpr int WN = kThreads / 32 / WM;   // warps along n
  constexpr int NT = N / 8;                // n tiles
  constexpr int NW = (NT + WN - 1) / WN;   // n tiles a warp
  constexpr int MW = MT / WM;              // m tiles a warp
  constexpr int V = N / 8;
  bf16* xs[2] = {reinterpret_cast<bf16*>(work),
                 reinterpret_cast<bf16*>(work) + kTile * S::XS};
  bf16* bd = xs[1] + kTile * S::XS;  // [kTile][BS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int nt0 = wn * NW;
  const int l8 = lane & 7, l16 = (lane >> 3) & 1, l32 = lane >> 4;
  const int nkt = (p.Q + kTile - 1) / kTile;
  const int steps = p.hs * nkt;

  for (int i = tid; i < p.Q * V; i += kThreads) {
    const int k = i / V, v = i % V;
    cp16(braw + k * N + 8 * v, bg + k * p.bc_ss + 8 * v, bg, true);
  }
  cp_commit();
  copy_x<P, N>(p, xg0, 0, xs[0], tid, kThreads);
  cp_commit();

  float acc[MW][NW][4];
  for (int st = 0; st < steps; ++st) {
    const int j = st / nkt, kt = st % nkt, k0 = kt * kTile;
    if (st + 1 < steps) {
      const int j1 = (st + 1) / nkt, kt1 = (st + 1) % nkt;
      copy_x<P, N>(p, xg0 + j1 * p.x_sh, kt1 * kTile, xs[(st + 1) & 1],
                   tid, kThreads);
    }
    cp_commit();
    cp_wait<1>();  // B and this step's x tile are in
    bf16* xt = xs[st & 1];
    xdt_rows<P, N>(p, dts + j * p.Q, k0, xt, tid, kThreads);
    __syncthreads();  // every thread's copies of B are in
    const float* csh = cs + j * p.Q;
    const float last = csh[p.Q - 1];
    for (int i = tid; i < kTile * V; i += kThreads) {
      const int r = i / V, v = i % V, k = k0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (k < p.Q) {
        raw = *reinterpret_cast<const uint4*>(braw + k * N + 8 * v);
        scale8(reinterpret_cast<bf16*>(&raw),
               round_t<bf16>(expf(last - csh[k])));
      }
      *reinterpret_cast<uint4*>(bd + r * S::BS + 8 * v) = raw;
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int ni = 0; ni < NW; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const int kn = min(kTile, p.Q - k0);
    for (int kk = 0; 16 * kk < kn; ++kk) {  // keys past Q are zeros
      uint32_t af[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        // A = xdt^T (p rows, keys k) from the [key][p] tile, transposed
        const int pc = 16 * (wm + WM * mi) + 8 * l16;
        ldsm_x4_t(smem_addr(xt + (16 * kk + l8 + 8 * l32) * S::XS + pc),
                  af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
      }
      if constexpr (NW % 2 == 0) {
#pragma unroll
        for (int ni = 0; ni < NW; ni += 2) {
          const int nc0 = 8 * (nt0 + ni) + 8 * l32;
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_addr(bd + (16 * kk + l8 + 8 * l16) * S::BS + nc0),
                    b0, b1, b2, b3);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            mma(acc[mi][ni], af[mi], b0, b1);
            mma(acc[mi][ni + 1], af[mi], b2, b3);
          }
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < NW; ++ni) {
          if (nt0 + ni >= NT) break;
          uint32_t b0, b1;
          ldsm_x2_t(smem_addr(bd + (16 * kk + l8 + 8 * l16) * S::BS +
                              8 * (nt0 + ni)),
                    b0, b1);
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) mma(acc[mi][ni], af[mi], b0, b1);
        }
      }
    }
    if (kt == nkt - 1) {
      const long long cell = (static_cast<long long>(b) * p.nc + z) * p.H + h0 + j;
      float* out = p.st + cell * P * N;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        const int pr = 16 * (wm + WM * mi) + g;
#pragma unroll
        for (int ni = 0; ni < NW; ++ni) {
          if (nt0 + ni >= NT) break;
          const int n = 8 * (nt0 + ni) + 2 * t;
          *reinterpret_cast<float2*>(out + pr * N + n) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(out + (pr + 8) * N + n) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      }
      if (tid == 0) p.dec[cell] = expf(last);
    }
    __syncthreads();  // xt and bd are free for the next steps' copies
  }
}

// One (batch, chunk, q tile qt, head slice): y_diag's rows of the tile for
// each head. Phase 1 forms the C.B scores of the tile's 64 rows against
// the keys of tiles 0 .. qt once (warp w: rows 16 (w % 4), keys 32 (w / 4)
// .. + 31 of each key tile); phase 2 runs each head's PV product, the two
// halves of the block on alternate heads, each half's x tiles through its
// own two-stage ring over its (head, key tile) steps.
template <int P, int N>
__device__ void chunk_diag(const Params& p, const bf16* xg0, const bf16* bg,
                           const bf16* cg, const float* cs, const bf16* dts,
                           float4* scores, unsigned char* work, int b, int z,
                           int h0, int qt) {
  using S = Shape<P, N>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, half = warp >> 2;  // row group, block half
  const int g = lane >> 2, t = lane & 3;
  const int l8 = lane & 7, l16 = (lane >> 3) & 1, l32 = lane >> 4;
  const int q0 = qt * kTile, nkt = qt + 1;
  // scores[((rg * nkt + kt) * 8 + j) * 32 + lane]: the m16n8 accumulator of
  // row group rg and keys kt * 64 + 8 j .. + 7, as lane `lane` holds it
  float4* sc = scores + rg * nkt * 8 * 32 + lane;

  // phase 1: C.B, f32 accumulation
  bf16* cqs = reinterpret_cast<bf16*>(work);  // [kTile][CS]
  bf16* bks = cqs + kTile * S::CS;            // [kTile][CS]
  copy_bc<P, N>(cg, p.bc_ss, q0, p.Q, cqs);
  for (int kt = 0; kt < nkt; ++kt) {
    copy_bc<P, N>(bg, p.bc_ss, kt * kTile, p.Q, bks);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // n-tile pairs 2 half, 2 half + 1; on the diagonal, none past the
    // row group's last row (it is never read)
    const int jp_end = kt == qt ? min(2 * half + 2, rg + 1) : 2 * half + 2;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < S::NP / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(smem_addr(cqs + (16 * rg + (lane & 15)) * S::CS + 16 * kk +
                        8 * l32),
              af[0], af[1], af[2], af[3]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jp = 2 * half + i;
        if (jp >= jp_end) break;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(bks + (16 * jp + l8 + 8 * l32) * S::CS + 16 * kk +
                          8 * l16),
                b0, b1, b2, b3);
        mma(acc[2 * i], af, b0, b1);
        mma(acc[2 * i + 1], af, b2, b3);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jp = 2 * half + i;
      if (jp >= jp_end) break;
      sc[(kt * 8 + 2 * jp) * 32] =
          make_float4(acc[2 * i][0], acc[2 * i][1], acc[2 * i][2], acc[2 * i][3]);
      sc[(kt * 8 + 2 * jp + 1) * 32] =
          make_float4(acc[2 * i + 1][0], acc[2 * i + 1][1], acc[2 * i + 1][2],
                      acc[2 * i + 1][3]);
    }
    __syncthreads();  // bks (and, last, cqs) are free; the scores are in
  }

  // phase 2: each head's PV product from the stored scores; this half
  // takes heads half, half + 2, ...
  const int ht = tid & (kHalf - 1);  // thread in the half
  bf16* xs[2] = {reinterpret_cast<bf16*>(work) + 2 * half * kTile * S::XS,
                 reinterpret_cast<bf16*>(work) + (2 * half + 1) * kTile * S::XS};
  const int r0 = q0 + 16 * rg + g, r1 = r0 + 8;  // this thread's rows
  const long long s0 = static_cast<long long>(z) * p.Q;
  const int heads = (p.hs - half + 1) / 2;
  const int steps = heads * nkt;
  if (steps > 0) copy_x<P, N>(p, xg0 + half * p.x_sh, 0, xs[0], ht, kHalf);
  cp_commit();
  float o[P / 8][4];
  float cq0 = 0.f, cq1 = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int j = half + 2 * (st / nkt), kt = st % nkt;
    if (st + 1 < steps) {
      const int j1 = half + 2 * ((st + 1) / nkt), kt1 = (st + 1) % nkt;
      copy_x<P, N>(p, xg0 + j1 * p.x_sh, kt1 * kTile, xs[(st + 1) & 1], ht,
                   kHalf);
    }
    cp_commit();
    cp_wait<1>();  // this step's x tile is in
    bf16* xt = xs[st & 1];
    xdt_rows<P, N>(p, dts + j * p.Q, kt * kTile, xt, ht, kHalf);
    half_sync(half);
    const float* csh = cs + j * p.Q;
    if (kt == 0) {
      cq0 = r0 < p.Q ? csh[r0] : 0.f;
      cq1 = r1 < p.Q ? csh[r1] : 0.f;
#pragma unroll
      for (int i = 0; i < P / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    }
    // below the diagonal every (q, k) of the tile has k < q0 <= q: no mask
    // but the rows past Q
    const bool diag = kt == qt;
    const bool rows_in = r1 < p.Q;
    const int kk_end = diag ? rg + 1 : 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= kk_end) break;
      const float4 sa = sc[(kt * 8 + 2 * kk) * 32];
      const float4 sb = sc[(kt * 8 + 2 * kk + 1) * 32];
      const int ka = kt * kTile + 16 * kk + 2 * t;  // keys ka, ka+1, ka+8, ka+9
      const float2 ca = *reinterpret_cast<const float2*>(csh + ka);
      const float2 cb = *reinterpret_cast<const float2*>(csh + ka + 8);
      // att = T(scores * exp(cs[q] - cs[k])) where k <= q < Q, else 0
      float v[8] = {sa.x * exp2f((cq0 - ca.x) * kLog2e),
                    sa.y * exp2f((cq0 - ca.y) * kLog2e),
                    sa.z * exp2f((cq1 - ca.x) * kLog2e),
                    sa.w * exp2f((cq1 - ca.y) * kLog2e),
                    sb.x * exp2f((cq0 - cb.x) * kLog2e),
                    sb.y * exp2f((cq0 - cb.y) * kLog2e),
                    sb.z * exp2f((cq1 - cb.x) * kLog2e),
                    sb.w * exp2f((cq1 - cb.y) * kLog2e)};
      if (diag || !rows_in) {
        const int qs[8] = {r0, r0, r1, r1, r0, r0, r1, r1};
        const int ks[8] = {ka, ka + 1, ka, ka + 1, ka + 8, ka + 9, ka + 8,
                           ka + 9};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (!(ks[e] <= qs[e] && qs[e] < p.Q)) v[e] = 0.f;
      }
      uint32_t af[4];
      af[0] = pack_bf16(v[0], v[1]);
      af[1] = pack_bf16(v[2], v[3]);
      af[2] = pack_bf16(v[4], v[5]);
      af[3] = pack_bf16(v[6], v[7]);
      const bf16* xrow = xt + (16 * kk + l8 + 8 * l16) * S::XS;
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_addr(xrow + 16 * pp + 8 * l32), b0, b1, b2, b3);
        mma(o[2 * pp], af, b0, b1);
        mma(o[2 * pp + 1], af, b2, b3);
      }
    }
    if (diag) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = i ? r1 : r0;
        if (q >= p.Q) continue;
        float* out = p.y + ((static_cast<long long>(b) * p.S + s0 + q) * p.H +
                            h0 + j) * P;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt)
          *reinterpret_cast<float2*>(out + 8 * nt + 2 * t) =
              make_float2(o[nt][2 * i], o[nt][2 * i + 1]);
      }
    }
    half_sync(half);  // xt is free for the next steps' copies
  }
}

// blockIdx = (x: head slice, y: batch * chunk, z: job); job 0 forms the
// slice's states and decays, job 1 + i the q tile ceil(Q/64) - 1 - i, so
// the heaviest blocks are issued first
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int kPer = kMaxSlice * kMaxQ / kThreads;  // dt loads a thread
  const int nqt = (p.Q + kTile - 1) / kTile;
  const int n = p.hs * p.Q;
  float* cs = reinterpret_cast<float*>(tc_smem);  // [hs][Q] da_cs
  bf16* dts = reinterpret_cast<bf16*>(tc_smem + n * 4);  // [hs][Q] T(dt)
  const int head_bytes = (n * 6 + 15) & ~15;
  float4* scores = reinterpret_cast<float4*>(tc_smem + head_bytes);
  unsigned char* work = tc_smem + head_bytes + nqt * 4 * 8 * 32 * 16;

  const int h0 = blockIdx.x * p.hs;
  const int b = blockIdx.y / p.nc, z = blockIdx.y % p.nc;
  const int g = h0 / (p.H / p.G);
  const long long s0 = static_cast<long long>(z) * p.Q;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + s0 * p.x_ss + h0 * p.x_sh;
  const bf16* bg = static_cast<const bf16*>(p.b) + b * p.bc_sb + s0 * p.bc_ss + g * p.bc_sg;
  const bf16* cg = static_cast<const bf16*>(p.c) + b * p.bc_sb + s0 * p.bc_ss + g * p.bc_sg;
  const float* dtg = p.dt + b * p.dt_sb + s0 * p.dt_ss + h0;

  // da_cs of each head of the slice, by the f32 kernel's scan; every dt
  // load of a thread issued before any is used
  float dv[kPer], av[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int q = i / p.hs, j = i % p.hs;
    dv[e] = i < n ? __ldg(dtg + q * p.dt_ss + j) : 0.f;
    av[e] = i < n ? __ldg(p.a + h0 + j) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int q = i / p.hs, j = i % p.hs;
    if (i < n) {
      cs[j * p.Q + q] = dv[e] * av[e];
      dts[j * p.Q + q] = __float2bfloat16(dv[e]);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int j = warp; j < p.hs; j += kThreads / 32)
    warp_scan(cs + j * p.Q, p.Q, threadIdx.x & 31);
  __syncthreads();

  if (blockIdx.z == 0) {
    chunk_states<P, N>(p, xg, bg, cs, dts, reinterpret_cast<bf16*>(scores),
                       work, b, z, h0);
  } else {
    chunk_diag<P, N>(p, xg, bg, cg, cs, dts, scores, work, b, z, h0,
                     nqt - blockIdx.z);
  }
}

template <int P, int N>
int smem_bytes(int Q, int hs) {
  using S = Shape<P, N>;
  const int nqt = (Q + kTile - 1) / kTile;
  const int heads = (hs * Q * 6 + 15) & ~15;  // da_cs (f32), T(dt) (bf16)
  // the scores, or the chunk's B for a state job (Q N <= 64 Q . 2 . 2)
  const int scores = nqt * 4 * 8 * 32 * 16;
  const int phase1 = 2 * kTile * S::CS * 2;            // C and B tiles
  const int rings = 4 * kTile * S::XS * 2;             // two halves' rings
  const int states = 2 * kTile * S::XS * 2 + kTile * S::BS * 2;
  int work = phase1 > rings ? phase1 : rings;
  work = work > states ? work : states;
  return heads + scores + work;
}

template <int P, int N>
int launch(const Params& p, cudaStream_t s) {
  if (p.hs <= 0 || p.hs > kMaxSlice || (p.H / p.G) % p.hs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<P, N>(p.Q, p.hs);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(p.H / p.hs, p.B * p.nc, 1 + (p.Q + kTile - 1) / kTile);
  ssd_chunk_tc_kernel<P, N><<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <bool TC, int P>
int dispatch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 8: return TC ? tc::launch<P, 8>(p, s) : cc::launch<P, 8>(p, s);
    case 16: return TC ? tc::launch<P, 16>(p, s) : cc::launch<P, 16>(p, s);
    case 64: return TC ? tc::launch<P, 64>(p, s) : cc::launch<P, 64>(p, s);
    case 128: return TC ? tc::launch<P, 128>(p, s) : cc::launch<P, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool TC>
int dispatch(const Params& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16: return dispatch_n<TC, 16>(p, N, s);
    case 64: return dispatch_n<TC, 64>(p, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the state pass: one thread per (b, h, e) of the [B, H, P*N] state
__global__ void ssd_state_pass_kernel(const float* __restrict__ st,
                                      const float* __restrict__ dec,
                                      const float* __restrict__ init,
                                      float* __restrict__ prev,
                                      float* __restrict__ fin, int B, int nc,
                                      int H, int PN) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * H * PN) return;
  const int e = static_cast<int>(i % PN);
  const long long bh = i / PN;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  float s = init != nullptr ? init[i] : 0.f;
  for (int z = 0; z < nc; ++z) {
    const long long cell = (static_cast<long long>(b) * nc + z) * H + h;
    const long long off = cell * PN + e;
    prev[off] = s;
    s = __fadd_rn(__fmul_rn(s, dec[cell]), st[off]);  // no FMA: the loop's rounding
  }
  fin[i] = s;
}

}  // namespace

// x: [B, S, H, P] and b, c: [B, S, G, N] of one type (dtype 0 = float32,
// 1 = bfloat16), dt: [B, S, H] f32 and a: [H] f32, each given by its element
// strides (the last axis contiguous); y: [B, S, H, P], st: [B, S/Q, H, P, N]
// and dec: [B, S/Q, H], f32, contiguous. Q in {8, 16, 32, 256} divides S;
// P in {16, 64}; N in {8, 16, 64, 128}. bf16 only: hs heads a block (a
// divisor of H / G, at most 8), and x, b and c 16-byte aligned with every
// stride but the last a multiple of 8 elements. Returns
// cudaGetLastError().
extern "C" int ssd_intra_chunk(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, float* y,
                               float* st, float* dec, int B, int S, int H,
                               int P, int G, int N, int Q, long long x_sb,
                               long long x_ss, long long x_sh,
                               long long dt_sb, long long dt_ss,
                               long long bc_sb, long long bc_ss,
                               long long bc_sg, int hs, int dtype,
                               void* stream) {
  if (Q <= 0 || Q > kMaxQ || S % Q != 0 || G <= 0 || H % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{x, dt, a, b, c, y, st, dec, x_sb, x_ss, x_sh, dt_sb, dt_ss,
                 bc_sb, bc_ss, bc_sg, B, S, H, G, Q, S / Q, hs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(p, P, N, s);
  if (dtype == 1) return dispatch<true>(p, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// states: [B, nc, H, P, N] and dec: [B, nc, H] f32 contiguous; init: [B, H,
// P, N] f32 contiguous or null (zeros); prev: [B, nc, H, P, N] (the state
// entering each chunk) and fin: [B, H, P, N] (the final state), f32
// contiguous; nc >= 0 and B H P N > 0. Returns cudaGetLastError().
extern "C" int ssd_state_pass(const float* st, const float* dec,
                              const float* init, float* prev, float* fin,
                              int B, int nc, int H, int PN, void* stream) {
  const long long n = static_cast<long long>(B) * H * PN;
  if (n <= 0 || nc < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBlock = 256;
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  ssd_state_pass_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      st, dec, init, prev, fin, B, nc, H, PN);
  return static_cast<int>(cudaGetLastError());
}
