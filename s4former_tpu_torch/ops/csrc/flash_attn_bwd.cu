// Flash-attention backward for Hopper (sm_90a), with an additive logit bias.
//
// Replaces the three TPU backward kernels of s4former_tpu/ops/flash_attention.py:
//   s4_flash_attn_bwd_fused  <- `_bwd_fused_kernel` (l.251, launched by
//                               `_bwd_fused` l.304): dq, dk and dv in one pass
//   s4_flash_attn_bwd_dkv    <- `_bwd_dkv_kernel` (l.197, `_bwd` l.467)
//   s4_flash_attn_bwd_dq     <- `_bwd_dq_kernel` (l.372, `_bwd` l.530)
// Same function, not the same blocks. From the forward's saved lse and
// delta = rowsum(do * o) (f32, computed by the caller, as `_bwd` l.418 does):
//
//   p  = exp(q k^T * scale + bias - lse)         (f32)
//   dv = p^T do                                  (p rounded to the input type)
//   dp = do v^T
//   ds = p * (dp - delta)                        (rounded to the input type)
//   dk = scale * ds^T q,   dq = scale * ds k
//
// Rounding points and f32 accumulation are those of the TPU kernels
// (l.228-243, 287-301), so `flash_attention_backward_reference` in
// flash_attention.py computes the same numbers. q, k, v are read in the
// caller's [B, L, H, D] layout through strides, do and the outputs are
// contiguous [B, L, H, D], lse and delta [B, H, L] f32. Nothing is padded:
// q rows and k columns past L are masked in the kernels (the TPU folds the
// pad into a -1e30 bias instead, l.648-657). A bias is [B, 1|H, L, L] in
// the input type; a head-broadcast bias (PASA) has head stride 0.
//
// Schedule (the TPU's one 1152x1152 f32 tile does not fit a Hopper SM's
// shared memory, so the maths is kept and the tiles are 64x64):
// - fused: one block per (64-row k tile, head, image). K and V stay in
//   shared memory; the block walks the q tiles, recomputes p from lse,
//   keeps dk and dv in registers, and adds each q tile's scale * ds k into
//   a zeroed f32 dq workspace with atomic adds (summation order of dq
//   varies from run to run). One launch, one recompute of p.
// - dkv: the same block without the dq part.
// - dq:  one block per (64-row q tile, head, image); it walks the k tiles
//   and keeps dq in registers. Deterministic.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3): 2 L^2 D
// FLOP per product per (image, head), 5 products fused (10 B H L^2 D in
// all), 4 dkv, 3 dq. At B=1, L=1025, H=12, D=64, bf16 the fused pass is
// 8.07 GFLOP -> 8.2 us, against ~10 MB of operands -> 3 us: bounded by
// operations.
//
// The fused entry point dispatches on dtype: 0 (float32) runs the FMA
// kernel below, 1 (bfloat16) the tensor-core kernel
// flash_attn_bwd_fused_tc_kernel. The dk/dv and dq entry points run the FMA
// kernels in both types.
//
// bf16 fused, flash_attn_bwd_fused_tc_kernel: one block of 4 warps per
// (64-row k tile, head, image); K and V stay in shared memory as bf16. The
// block walks the q tiles; Q, dO, lse and delta of tile i+1 come in by
// cp.async (zero-filled past L) while tile i computes. Each warp owns 16 k
// rows and computes the transposed products S^T = K Q^T and dP^T = V dO^T
// on the tensor cores (mma.sync m16n8k16, f32 accumulate), so that
// P^T = exp(S^T s + bias^T - lse) and dS^T = P^T (dP^T - delta), rounded to
// bf16 (the TPU kernel's rounding points, l.287-301), are already the A
// fragments of dV += P^T dO and dK += dS^T Q, which stay in registers. dS^T
// goes through shared memory once and comes back by ldmatrix.trans as the
// A operand of dQ_tile = dS K s, which is added into the zeroed f32 dq
// workspace with 16-byte vector reductions (red.global.add.v4.f32; the
// summation order varies from run to run). The bias is read with 2-byte
// loads (its rows are 2*L bytes apart). Shared memory 57 KB. What it leaves
// for later: wgmma, TMA, warp specialisation, persistent blocks, and a
// deterministic dq without atomics.
//
// float32, and the dk/dv and dq kernels: 256 threads, each owning a 4x4
// patch of every 64x64 product, on the f32 FMA pipes from f32 tiles in
// shared memory. Left for later: the tensor-core design above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attn_tc.cuh"

namespace {

constexpr int kD = 64;          // head dim (every ViT config of the repo)
constexpr int kTile = 64;       // rows of a q or k tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 elements each
constexpr int kPad = kD + 1;    // f32 row stride: no bank conflicts
constexpr int kTileF = kTile * kPad;
// K, V, Q, dO, P, dS tiles + lse and delta of the q tile
constexpr size_t kSmemBytes = sizeof(float) * (6 * kTileF + 2 * kTile);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the value x takes once stored in T (the TPU kernels' `.astype(q.dtype)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const void* dout;     // [B, L, H, D] contiguous
  const float* lse;     // [B, H, L]
  const float* delta;   // [B, H, L]
  void* dq;             // fused: f32 workspace; dq kernel: T
  void* dk;
  void* dv;
  // element strides of [B, L, H] (the D axis is contiguous)
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  // element strides of the bias [B, 1|H, L(q), L(k)]; bias_sh == 0 when
  // the bias is broadcast over heads
  int64_t bias_sb, bias_sh, bias_sl;
  int L;
  int H;
  float scale;
};

// rows row0 .. row0+63 of a [*, D] operand into a padded f32 tile; rows
// past L read as 0
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int L) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    const int row = row0 + r;
    dst[r * kPad + c] = row < L ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

// The tile body every kernel shares. For the q tile in qs/dos (rows q0..)
// and the k tile in ks/vs (rows k0..), each thread computes its 4x4 patch
// (q rows 4*ty+i, k rows tx+16*j) of p and ds and stores them, rounded to
// T, as [q][k] tiles in ps and dss. Masked entries are 0.
template <typename T, bool kHasBias, bool kStoreP>
__device__ __forceinline__ void p_and_ds(const Params& p, const T* bias,
                                         const float* qs, const float* ks,
                                         const float* vs, const float* dos,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         float* ps, float* dss) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4];
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(4 * ty + i) * kPad + d];
      dov[i] = dos[(4 * ty + i) * kPad + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * kPad + d];
      vv[j] = vs[(tx + 16 * j) * kPad + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int col = k0 + c;
      float pr = 0.f;
      if (row < p.L && col < p.L) {
        float x = s[i][j] * p.scale;
        if (kHasBias) x += to_f32(bias[row * p.bias_sl + col]);
        pr = expf(x - lse_s[r]);
      }
      if (kStoreP) ps[r * kPad + c] = round_to<T>(pr);
      dss[r * kPad + c] = round_to<T>(pr * (dp[i][j] - delta_s[r]));
    }
  }
}

// lse and delta of q rows q0.. into shared memory (0 past L)
__device__ __forceinline__ void load_row_stats(const Params& p, int b, int h,
                                               int q0, float* lse_s,
                                               float* delta_s) {
  const int t = threadIdx.x;
  if (t < kTile) {
    const int row = q0 + t;
    const int64_t off = (static_cast<int64_t>(b) * p.H + h) * p.L + row;
    lse_s[t] = row < p.L ? p.lse[off] : 0.f;
    delta_s[t] = row < p.L ? p.delta[off] : 0.f;
  }
}

// dk, dv (and, when kFusedDq, dq through atomics): one block per
// (64-row k tile, head, image), looping over the q tiles
template <typename T, bool kHasBias, bool kFusedDq>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_kv_kernel(const Params p) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileF;
  float* qs = vs + kTileF;
  float* dos = qs + kTileF;
  float* ps = dos + kTileF;
  float* dss = ps + kTileF;
  float* lse_s = dss + kTileF;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD;   // do, outputs

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) +
                  static_cast<int64_t>(b) * L * row_stride + h * kD;
  const T* bias = nullptr;
  if (kHasBias) {
    bias = static_cast<const T*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
  }

  load_tile(ks, k, p.k_sl, n0, L);
  load_tile(vs, v, p.v_sl, n0, L);

  float dk[4][4];
  float dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  const int n_q_tiles = (L + kTile - 1) / kTile;
  for (int t = 0; t < n_q_tiles; ++t) {
    const int m0 = t * kTile;
    __syncthreads();  // the last q tile is done with qs, dos, ps and dss
    load_tile(qs, q, p.q_sl, m0, L);
    load_tile(dos, dout, row_stride, m0, L);
    load_row_stats(p, b, h, m0, lse_s, delta_s);
    __syncthreads();
    p_and_ds<T, kHasBias, true>(p, bias, qs, ks, vs, dos, lse_s, delta_s, m0,
                                n0, ps, dss);
    __syncthreads();

    // dv[kr, d] += sum_q p[q, kr] do[q, d];  dk[kr, d] += sum_q ds[q, kr] q[q, d]
    // (k rows 4*ty+i, d columns tx+16*j)
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4], dov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kPad + 4 * ty + i];
        dsv[i] = dss[r * kPad + 4 * ty + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dov[j] = dos[r * kPad + tx + 16 * j];
        qv[j] = qs[r * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }

    if (kFusedDq) {
      // this k tile's share of dq[qr, d] = scale * sum_k ds[qr, k] k[k, d]
      // (q rows 4*ty+i, d columns tx+16*j), added into the f32 workspace
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        float dsv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dss[(4 * ty + i) * kPad + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[c * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
      }
      float* dq = static_cast<float*>(p.dq) +
                  static_cast<int64_t>(b) * L * row_stride + h * kD;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + 4 * ty + i;
        if (row >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          atomicAdd(dq + row * row_stride + tx + 16 * j, acc[i][j] * p.scale);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) +
              static_cast<int64_t>(b) * L * row_stride + h * kD;
  T* dv_out = static_cast<T*>(p.dv) +
              static_cast<int64_t>(b) * L * row_stride + h * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t off = row * row_stride + tx + 16 * j;
      dk_out[off] = from_f32<T>(dk[i][j] * p.scale);
      dv_out[off] = from_f32<T>(dv[i][j]);
    }
  }
}

// dq: one block per (64-row q tile, head, image), looping over the k tiles
template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const Params p) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTileF;
  float* qs = vs + kTileF;
  float* dos = qs + kTileF;
  float* dss = dos + kTileF;
  float* lse_s = dss + kTileF;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) +
                  static_cast<int64_t>(b) * L * row_stride + h * kD;
  const T* bias = nullptr;
  if (kHasBias) {
    bias = static_cast<const T*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
  }

  load_tile(qs, q, p.q_sl, m0, L);
  load_tile(dos, dout, row_stride, m0, L);
  load_row_stats(p, b, h, m0, lse_s, delta_s);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k_tiles = (L + kTile - 1) / kTile;
  for (int t = 0; t < n_k_tiles; ++t) {
    const int n0 = t * kTile;
    __syncthreads();  // the last k tile is done with ks, vs and dss
    load_tile(ks, k, p.k_sl, n0, L);
    load_tile(vs, v, p.v_sl, n0, L);
    __syncthreads();
    p_and_ds<T, kHasBias, false>(p, bias, qs, ks, vs, dos, lse_s, delta_s,
                                 m0, n0, nullptr, dss);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(4 * ty + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[c * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(p.dq) + static_cast<int64_t>(b) * L * row_stride +
          h * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dq[row * row_stride + tx + 16 * j] = from_f32<T>(acc[i][j] * p.scale);
    }
  }
}

constexpr int kTcThreads = 128;   // 4 warps, 16 k rows each
// K, V, dS^T, two stages of Q and dO (bf16), two of lse and delta (f32)
constexpr size_t kTcSmemBytes =
    sizeof(__nv_bfloat16) * 7 * s4tc::kTileElems + sizeof(float) * 4 * kTile;

template <bool kHasBias>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attn_bwd_fused_tc_kernel(const Params p) {
  using namespace s4tc;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) bf16 smem_tc[];
  bf16* ks = smem_tc;                   // [64 k][64 d]
  bf16* vs = ks + kTileElems;           // [64 k][64 d]
  bf16* dss = vs + kTileElems;          // dS^T [64 k][64 q]
  bf16* qs = dss + kTileElems;          // [2][64 q][64 d]
  bf16* dos = qs + 2 * kTileElems;      // [2][64 q][64 d]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileElems);   // [2][64]
  float* delta_s = lse_s + 2 * kTile;                              // [2][64]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD;   // do, outputs

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) +
                     static_cast<int64_t>(b) * L * row_stride + h * kD;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * L;
  const float* lse = p.lse + stat0;
  const float* delta = p.delta + stat0;
  const bf16* bias = nullptr;
  if (kHasBias) {
    bias = static_cast<const bf16*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
  }
  // this thread's two k rows (g and g+8 of its warp's 16)
  const int kr = n0 + warp * 16 + g;
  const int kcol[2] = {min(kr, L - 1), min(kr + 8, L - 1)};   // bias columns

  // Q, dO, lse and delta of the q tile at m0 into stage st
  auto load_q_tile = [&](int st, int m0) {
    load_tile_async<kTcThreads>(qs + st * kTileElems, q, p.q_sl, m0, L);
    load_tile_async<kTcThreads>(dos + st * kTileElems, dout, row_stride, m0,
                                L);
    const int i = threadIdx.x & (kTile - 1);
    const int row = m0 + i;
    const bool ok = row < L;
    const float* src = threadIdx.x < kTile ? lse : delta;
    float* dst = (threadIdx.x < kTile ? lse_s : delta_s) + st * kTile + i;
    cp_async_4(smem_u32(dst), src + (ok ? row : 0), ok);
  };

  load_tile_async<kTcThreads>(ks, k, p.k_sl, n0, L);
  load_tile_async<kTcThreads>(vs, v, p.v_sl, n0, L);
  load_q_tile(0, 0);
  cp_async_commit();

  float dk[8][4];
  float dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }
  const float scale_log2 = p.scale * kLog2e;
  float* dq = static_cast<float*>(p.dq) +
              static_cast<int64_t>(b) * L * row_stride + h * kD;

  const int n_q_tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < n_q_tiles; ++it) {
    const int stage = it & 1;
    const int m0 = it * kTile;
    if (it + 1 < n_q_tiles) {
      load_q_tile(stage ^ 1, m0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qst = qs + stage * kTileElems;
    const bf16* dost = dos + stage * kTileElems;
    const float* lse_t = lse_s + stage * kTile;
    const float* delta_t = delta_s + stage * kTile;

    // bias^T of (k row g | g+8, q col m0 + 8j + 2t + 0|1); q rows clamped
    // into the array, p is masked below past L
    float bv[8][4];
    if (kHasBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qrow = min(m0 + 8 * j + 2 * t + (e & 1), L - 1);
          bv[j][e] = bf16_at(bias + static_cast<int64_t>(qrow) * p.bias_sl +
                             kcol[e >> 1]);
        }
    }

    // S^T = K Q^T and dP^T = V dO^T, this warp's 16 k rows x 64 q columns
    float s[8][4];
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ka[4];
      uint32_t va[4];
      ldmatrix_x4(ka, a_addr(ks, warp * 16, kk * 16));
      ldmatrix_x4(va, a_addr(vs, warp * 16, kk * 16));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t qb[4];
        uint32_t db[4];
        ldmatrix_x4(qb, b_addr_nk(qst, jj * 16, kk * 16));
        ldmatrix_x4(db, b_addr_nk(dost, jj * 16, kk * 16));
        mma_16816(s[2 * jj], ka, qb[0], qb[1]);
        mma_16816(s[2 * jj + 1], ka, qb[2], qb[3]);
        mma_16816(dp[2 * jj], va, db[0], db[1]);
        mma_16816(dp[2 * jj + 1], va, db[2], db[3]);
      }
    }

    // P^T and dS^T in f32; 0 for q rows or k columns past L
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float bias_v = kHasBias ? bv[j][e] : 0.f;
        float pr = exp2f(fmaf(s[j][e], scale_log2,
                              (bias_v - lse_t[qc]) * kLog2e));
        if (m0 + qc >= L || kr + 8 * (e >> 1) >= L) pr = 0.f;
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - delta_t[qc]);
      }
    uint32_t pa[4][4];
    uint32_t dsa[4][4];
    c_to_a(s, pa);
    c_to_a(dp, dsa);
    // dS^T to shared memory for the dQ product (the same bf16 values)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e & 1);
        const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
        *reinterpret_cast<uint32_t*>(dss + swz(row, col)) = dsa[kk][e];
      }

    // dV += P^T dO, dK += dS^T Q: the q tile is the deep axis
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t db[4];
        uint32_t qb[4];
        ldmatrix_x4_trans(db, b_addr_kn(dost, jj * 16, kk * 16));
        ldmatrix_x4_trans(qb, b_addr_kn(qst, jj * 16, kk * 16));
        mma_16816(dv[2 * jj], pa[kk], db[0], db[1]);
        mma_16816(dv[2 * jj + 1], pa[kk], db[2], db[3]);
        mma_16816(dk[2 * jj], dsa[kk], qb[0], qb[1]);
        mma_16816(dk[2 * jj + 1], dsa[kk], qb[2], qb[3]);
      }
    }
    __syncthreads();   // dS^T complete

    // dQ_tile = dS K for this warp's 16 q rows, added into the workspace
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      ldmatrix_x4_trans(da, a_addr_t(dss, warp * 16, kk * 16));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, b_addr_kn(ks, jj * 16, kk * 16));
        mma_16816(acc[2 * jj], da, kb[0], kb[1]);
        mma_16816(acc[2 * jj + 1], da, kb[2], kb[3]);
      }
    }
    // lanes 2u and 2u+1 swap halves so each holds 4 neighbouring columns:
    // the even lane row g, the odd lane row g+8, columns 8j + 4(t/2)..+3
    const bool odd = t & 1;
    const int qrow = m0 + warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = __shfl_xor_sync(0xffffffffu,
                                       odd ? acc[j][0] : acc[j][2], 1);
      const float x1 = __shfl_xor_sync(0xffffffffu,
                                       odd ? acc[j][1] : acc[j][3], 1);
      if (qrow < L) {
        float* dst = dq + qrow * row_stride + 8 * j + 2 * (t & 2);
        if (odd) {
          red_add_v4(dst, x0 * p.scale, x1 * p.scale, acc[j][2] * p.scale,
                     acc[j][3] * p.scale);
        } else {
          red_add_v4(dst, acc[j][0] * p.scale, acc[j][1] * p.scale,
                     x0 * p.scale, x1 * p.scale);
        }
      }
    }
    __syncthreads();   // this stage and dS^T are free
  }

  bf16* dk_out = static_cast<bf16*>(p.dk) +
                 static_cast<int64_t>(b) * L * row_stride + h * kD;
  bf16* dv_out = static_cast<bf16*>(p.dv) +
                 static_cast<int64_t>(b) * L * row_stride + h * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t off = row * row_stride + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_out + off) = pack_bf16(
          dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + off) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, cudaStream_t stream,
                   int threads = kThreads, size_t smem = kSmemBytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + kTile - 1) / kTile, p.H, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFused = 0, kDkv = 1, kDq = 2 };

template <typename T, bool kHasBias>
cudaError_t dispatch(Which which, const Params& p, int B,
                     cudaStream_t stream) {
  switch (which) {
    case kFused:
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        return launch(flash_attn_bwd_fused_tc_kernel<kHasBias>, p, B, stream,
                      kTcThreads, kTcSmemBytes);
      } else {
        return launch(flash_attn_bwd_kv_kernel<T, kHasBias, true>, p, B,
                      stream);
      }
    case kDkv:
      return launch(flash_attn_bwd_kv_kernel<T, kHasBias, false>, p, B,
                    stream);
    default:
      return launch(flash_attn_bwd_dq_kernel<T, kHasBias>, p, B, stream);
  }
}

int run(Which which, const void* q, const void* k, const void* v,
        const void* bias, const void* dout, const void* lse,
        const void* delta, void* dq, void* dk, void* dv, int64_t q_sb,
        int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
        int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t bias_sb,
        int64_t bias_sh, int64_t bias_sl, int B, int L, int H, int D,
        int dtype, void* stream) {
  if (D != kD || L < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sl = bias_sl;
  p.L = L;
  p.H = H;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = bias ? dispatch<float, true>(which, p, B, s)
               : dispatch<float, false>(which, p, B, s);
  } else {
    err = bias ? dispatch<__nv_bfloat16, true>(which, p, B, s)
               : dispatch<__nv_bfloat16, false>(which, p, B, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). dtype: 0 =
// float32, 1 = bfloat16. bias may be null. Outputs dq, dk, dv are
// contiguous [B, L, H, D]; the fused entry point takes dq as a zeroed f32
// workspace and leaves the cast to the caller, dkv ignores dq, dq ignores
// dk and dv.
#define S4_BWD_ARGS                                                         \
  const void *q, const void *k, const void *v, const void *bias,           \
      const void *dout, const void *lse, const void *delta, void *dq,      \
      void *dk, void *dv, int64_t q_sb, int64_t q_sl, int64_t q_sh,        \
      int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl, \
      int64_t v_sh, int64_t bias_sb, int64_t bias_sh, int64_t bias_sl,     \
      int B, int L, int H, int D, int dtype, void *stream
#define S4_BWD_PASS                                                      \
  q, k, v, bias, dout, lse, delta, dq, dk, dv, q_sb, q_sl, q_sh, k_sb,   \
      k_sl, k_sh, v_sb, v_sl, v_sh, bias_sb, bias_sh, bias_sl, B, L, H, D, \
      dtype, stream

int s4_flash_attn_bwd_fused(S4_BWD_ARGS) { return run(kFused, S4_BWD_PASS); }
int s4_flash_attn_bwd_dkv(S4_BWD_ARGS) { return run(kDkv, S4_BWD_PASS); }
int s4_flash_attn_bwd_dq(S4_BWD_ARGS) { return run(kDq, S4_BWD_PASS); }

const char* s4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
