// Latent decode attention on the card (DeepSeek-V2's multi-head latent
// attention, absorbed): one new token a slot, its 16 or 32 query heads
// (DeepSeek-V2-Lite's, Kimi-Linear's) against the slot's latent cache rows,
// each row c (512) then the roped key k^R (64), read where they lie in
// bf16.
//
// For slot b, head h and the slot's live rows j < n_b = min(length_b + 1, S):
//
//   s[h, j] = scale (q~[b, h] . c[b, j] + q^R[b, h] . k^R[b, j])      (f32)
//   o[b, h] = sum_j T(exp(s[h, j] - m)) c[b, j] / sum_j exp(s[h, j] - m)
//
// q~ ‖ q^R is one 576-wide query row a head and c ‖ k^R one 576-wide cache
// row, so a score is one 576-wide dot product; the value is the row's first
// 512 columns. m is a running maximum and T the rounding to bf16 that the
// model's plain routes take before the PV product; the PV sum, the
// softmax's sum and maximum are f32, the output bf16.
//
// Replaces no TPU kernel: the reference package has no latent attention.
//
// What bounds it on an H100. Each live row is read once for all 16 heads
// (1,152 bytes), and each row costs 16 x (576 + 512) x 2 = 34,816 FLOPs:
// about 30 FLOPs a byte, more than the CUDA cores keep pace with against
// HBM (67 TFLOP/s f32 over 3.35 TB/s is 20). So both products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 out): 16 heads are
// exactly the m16 of a tile, and 32 heads two tiles side by side, each
// taken by its own four warps from the same rows in shared memory (a row
// is still read once from HBM for every head). The design:
//
// - Split over rows. A block owns one (slot, chunk of kChunk rows). The
//   grid is set by S, not by the lengths (a CUDA graph replays it with
//   other lengths); a block whose chunk starts past n_b returns at once.
// - The block's q (16 x 576) sits in shared memory; the chunk's rows come
//   in tiles of kTile rows by cp.async into a two-stage ring, the next
//   tile loading while the current one is used. Rows past the live ones
//   load as zeros. Shared rows are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads fall on distinct banks.
// - Scores: warp w takes 8 rows of the tile, S[16, 8] = Q K^T over 36
//   k-steps (B fragments straight from the row-major rows). The scores go
//   to shared memory; 8 threads a head take the tile's running maximum and
//   sum, write P = T(exp(s - m)) in bf16 and each head's rescale factor.
// - PV: warp w owns 128 of the 512 value columns for all 16 heads (16 n8
//   tiles of f32 accumulators), O = O alpha + P V, with V's B fragments
//   loaded transposed from the same rows in shared memory.
// - The chunk's partial (m, l, O) goes to scratch; a second, small launch
//   merges the chunks of each (slot, head) and writes o in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRow = 576;          // a latent row: c, then k^R
constexpr int kValue = 512;        // the value: a row's first columns
constexpr int kTile = 32;          // rows a step
constexpr int kChunk = 256;        // rows a block
constexpr int kStride = kRow + 8;  // a shared row, elements (1,168 bytes)
constexpr int kPStride = kTile + 8;  // a shared row of P, elements
constexpr int kStages = 2;
constexpr int kPieces = kRow / 8;  // 16-byte pieces a row
constexpr int kMergeThreads = 128;  // 4 of the 512 value columns a thread
constexpr float kLog2e = 1.4426950408889634f;

// the split kernel's layout for kHeads query heads: an m16 tile of heads
// a group of four warps, each warp owning 128 value columns of its tile
template <int kHeads>
struct Shape {
  static_assert(kHeads % 16 == 0, "heads come in m16 tiles");
  static constexpr int kWarps = 4 * (kHeads / 16);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSmemQ = kHeads * kStride * 2;
  static constexpr int kSmemKV = kStages * kTile * kStride * 2;
  static constexpr int kSmemS = kHeads * kTile * 4;
  static constexpr int kSmemP = kHeads * kPStride * 2;
  static constexpr int kSmem = kSmemQ + kSmemKV + kSmemS + kSmemP + kHeads * 4;
  static_assert(kSmemQ % 16 == 0 && kSmemKV % 16 == 0 && kSmemS % 16 == 0 &&
                    kSmemP % 16 == 0,
                "shared regions start on 16 bytes");
  static_assert(kThreads == 8 * kHeads, "8 threads a head's softmax step");
};
static_assert(kValue == 4 * 128, "a warp owns 128 value columns");

struct Params {
  const __nv_bfloat16* q;     // [B, H, 576], heads and dims contiguous
  const __nv_bfloat16* rows;  // [B, S, 576], dims contiguous
  const long long* length;    // [B] (stride length_stride) or null
  long long length_int;       // every slot's length where length is null
  long long length_stride;
  float* part_acc;     // [B, n_chunks, H, 512]
  float* part_ml;      // [B, n_chunks, H, 2]: (max, sum), log2 units
  __nv_bfloat16* out;  // [B, H, 512] contiguous
  long long q_sb, r_sb, r_ss;  // strides, in elements
  int S, n_chunks;
  float scale_log2;  // scale * log2(e): scores kept in log2 units
};

__device__ __forceinline__ int live_rows(const Params& p, int b) {
  const long long len = p.length ? p.length[b * p.length_stride] : p.length_int;
  long long n = len + 1;
  n = n < 0 ? 0 : (n > p.S ? p.S : n);
  return static_cast<int>(n);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; zeros where !valid (src is still a valid
// address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows first .. first + kTile - 1 of the slot into a shared tile; rows from
// row_end on load as zeros (first < row_end)
template <int kThreads>
__device__ __forceinline__ void load_tile(const Params& p,
                                          __nv_bfloat16* dst,
                                          const __nv_bfloat16* slot_rows,
                                          int first, int row_end) {
  for (int i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, piece = i % kPieces;
    const int row = first + r;
    const bool valid = row < row_end;
    cp_async16(dst + r * kStride + piece * 8,
               slot_rows + (valid ? row : first) * p.r_ss + piece * 8, valid);
  }
}

template <int kHeads>
__global__ void __launch_bounds__(Shape<kHeads>::kThreads)
    mla_decode_split_kernel(const Params p) {
  using Sh = Shape<kHeads>;
  constexpr int kThreads = Sh::kThreads;
  constexpr int kSmemQ = Sh::kSmemQ, kSmemKV = Sh::kSmemKV;
  constexpr int kSmemS = Sh::kSmemS, kSmemP = Sh::kSmemP;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem + kSmemQ);
  float* ss = reinterpret_cast<float*>(smem + kSmemQ + kSmemKV);
  __nv_bfloat16* sp =
      reinterpret_cast<__nv_bfloat16*>(smem + kSmemQ + kSmemKV + kSmemS);
  float* salpha =
      reinterpret_cast<float*>(smem + kSmemQ + kSmemKV + kSmemS + kSmemP);

  const int c = blockIdx.x, b = blockIdx.y;
  const int n = live_rows(p, b);
  const int row0 = c * kChunk;
  if (row0 >= n) return;
  const int row_end = min(row0 + kChunk, n);
  const int n_tiles = (row_end - row0 + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's head tile (heads ht .. ht + 15) and its place in the tile's
  // four warps
  const int ht = (warp / 4) * 16, wl = warp % 4;
  const int grp = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* slot_rows = p.rows + b * p.r_sb;

  const __nv_bfloat16* qb = p.q + b * p.q_sb;
  for (int i = threadIdx.x; i < kHeads * kPieces; i += kThreads) {
    const int h = i / kPieces, piece = i % kPieces;
    cp_async16(sq + h * kStride + piece * 8, qb + h * kRow + piece * 8, true);
  }
  load_tile<kThreads>(p, skv, slot_rows, row0, row_end);
  cp_async_commit();

  // the softmax step's share: 8 threads a head, 4 of a tile's rows each;
  // each keeps its head's running (m, l)
  const int sh = threadIdx.x / 8, spart = threadIdx.x % 8;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[16][4];  // the tile's 16 heads x this warp's 128 value columns
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int first = row0 + t * kTile;
    const __nv_bfloat16* tile = skv + (t % kStages) * kTile * kStride;
    if (t + 1 < n_tiles) {
      load_tile<kThreads>(p, skv + ((t + 1) % kStages) * kTile * kStride,
                          slot_rows, first + kTile, row_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {  // scores of this warp's 8 rows: [16 heads, 8 rows] over 576 dims
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr =
          tile + (wl * 8 + (lane & 7)) * kStride + (lane >> 3) * 8;
      const __nv_bfloat16* qr =
          sq + (ht + (lane & 15)) * kStride + (lane >> 4) * 8;
#pragma unroll
      for (int k0 = 0; k0 < kRow; k0 += 32) {
        unsigned kb[4], qa[4];
        ldsm_x4(kb, kr + k0);  // k-steps k0 (kb0, kb1) and k0 + 16
        ldsm_x4(qa, qr + k0);
        mma16816(sc, qa, kb[0], kb[1]);
        ldsm_x4(qa, qr + k0 + 16);
        mma16816(sc, qa, kb[2], kb[3]);
      }
      // sc[0], sc[1]: head ht + grp, rows 2 tig and 2 tig + 1 of the
      // warp's 8; sc[2], sc[3]: head ht + grp + 8
      const int r = wl * 8 + 2 * tig;
      const int h0 = ht + grp;
      const bool v0 = first + r < row_end, v1 = first + r + 1 < row_end;
      ss[h0 * kTile + r] = v0 ? sc[0] * p.scale_log2 : -INFINITY;
      ss[h0 * kTile + r + 1] = v1 ? sc[1] * p.scale_log2 : -INFINITY;
      ss[(h0 + 8) * kTile + r] = v0 ? sc[2] * p.scale_log2 : -INFINITY;
      ss[(h0 + 8) * kTile + r + 1] = v1 ? sc[3] * p.scale_log2 : -INFINITY;
    }
    __syncthreads();

    {  // the tile's softmax step, a head's 8 threads together
      float s4[4];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4[i] = ss[sh * kTile + spart * 4 + i];
        mx = fmaxf(mx, s4[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: the tile's first row is live
      const float m_new = fmaxf(m_run, mx);
      const float alpha = m_new == m_run ? 1.f : exp2f(m_run - m_new);
      float sum = 0.f;
      __nv_bfloat162 pb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(s4[2 * i] - m_new);
        const float p1 = exp2f(s4[2 * i + 1] - m_new);
        sum += p0 + p1;
        pb[i] = __floats2bfloat162_rn(p0, p1);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(sp + sh * kPStride + spart * 4);
      dst[0] = pb[0];
      dst[1] = pb[1];
      if (spart == 0) salpha[sh] = alpha;
    }
    __syncthreads();

    {  // O = O alpha + P V over this warp's 128 value columns
      const float a_lo = salpha[ht + grp], a_hi = salpha[ht + grp + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
      const __nv_bfloat16* pr =
          sp + (ht + (lane & 15)) * kPStride + (lane >> 4) * 8;
      const __nv_bfloat16* vr =
          tile + (lane & 15) * kStride + wl * 128 + (lane >> 4) * 8;
#pragma unroll
      for (int k0 = 0; k0 < kTile; k0 += 16) {
        unsigned pa[4];
        ldsm_x4(pa, pr + k0);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          unsigned vb[4];  // n-tiles j (vb0, vb1) and j + 1
          ldsm_x4_trans(vb, vr + k0 * kStride + j * 8);
          mma16816(acc[j], pa, vb[0], vb[1]);
          mma16816(acc[j + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

  // the chunk's partial to scratch
  const long long cell0 =
      (static_cast<long long>(b) * p.n_chunks + c) * kHeads;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int d = wl * 128 + j * 8 + 2 * tig;
    *reinterpret_cast<float2*>(&p.part_acc[(cell0 + ht + grp) * kValue + d]) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(
        &p.part_acc[(cell0 + ht + grp + 8) * kValue + d]) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (spart == 0) {
    p.part_ml[(cell0 + sh) * 2] = m_run;
    p.part_ml[(cell0 + sh) * 2 + 1] = l_run;
  }
}

// one block a (head, slot), 4 of the 512 columns a thread: the chunks'
// partials merged
template <int kHeads>
__global__ void __launch_bounds__(kMergeThreads)
    mla_decode_merge_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x * 4;
  const int nc = (live_rows(p, b) + kChunk - 1) / kChunk;
  const long long first = static_cast<long long>(b) * p.n_chunks * kHeads + h;
  float mx = -INFINITY;
  for (int c = 0; c < nc; ++c)
    mx = fmaxf(mx, p.part_ml[(first + c * kHeads) * 2]);
  float sl = 0.f, sa[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const long long cell = first + c * kHeads;
    const float w = exp2f(p.part_ml[cell * 2] - mx);
    sl = fmaf(w, p.part_ml[cell * 2 + 1], sl);
    const float4 a =
        *reinterpret_cast<const float4*>(&p.part_acc[cell * kValue + d]);
    sa[0] = fmaf(w, a.x, sa[0]);
    sa[1] = fmaf(w, a.y, sa[1]);
    sa[2] = fmaf(w, a.z, sa[2]);
    sa[3] = fmaf(w, a.w, sa[3]);
  }
  __nv_bfloat16* o = p.out + (static_cast<long long>(b) * kHeads + h) * kValue;
#pragma unroll
  for (int i = 0; i < 4; ++i) o[d + i] = __float2bfloat16(nc ? sa[i] / sl : 0.f);
}

bool configured[2][64];  // the split kernels' shared memory limits, a device

template <int kHeads>
int launch(const Params& p, int B, int n_chunks, cudaStream_t s, int dev) {
  using Sh = Shape<kHeads>;
  cudaError_t err;
  if (!configured[kHeads / 32][dev]) {
    err = cudaFuncSetAttribute(mla_decode_split_kernel<kHeads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[kHeads / 32][dev] = true;
  }
  mla_decode_split_kernel<kHeads>
      <<<dim3(n_chunks, B), Sh::kThreads, Sh::kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_merge_kernel<kHeads><<<dim3(kHeads, B), kMergeThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, H, 576] bf16 (batch stride q_sb), each head's row contiguous,
// H 16 or 32;
// rows: [B, S, 576] bf16 (batch and row strides r_sb / r_ss), each row
// contiguous; every pointer and stride 16-byte aligned. length: [B] int64
// lengths (stride length_stride, 0 for one shared 0-d tensor) or null, then
// length_int for every slot; slot b attends its rows j < min(length_b + 1,
// S). part_acc: [B, ceil(S / 256), H, 512] f32 and part_ml: [B, ceil(S /
// 256), H, 2] f32 scratch; out: [B, H, 512] bf16 contiguous. Two launches
// on stream; returns cudaGetLastError() (or the error of setting the split
// kernel's shared memory limit, once a device).
extern "C" int mla_decode(const void* q, const void* rows,
                          const long long* length, long long length_int,
                          long long length_stride, float* part_acc,
                          float* part_ml, void* out, long long q_sb,
                          long long r_sb, long long r_ss, int B, int S,
                          int H, float scale, void* stream) {
  if (B <= 0 || S <= 0 || (H != 16 && H != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const Params p{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(rows),
                 length, length_int, length_stride, part_acc, part_ml,
                 static_cast<__nv_bfloat16*>(out), q_sb, r_sb, r_ss, S,
                 n_chunks, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 16 ? launch<16>(p, B, n_chunks, s, dev)
                 : launch<32>(p, B, n_chunks, s, dev);
}
