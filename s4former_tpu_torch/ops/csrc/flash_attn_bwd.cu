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
//   a zeroed f32 dq workspace with atomicAdd (summation order of dq varies
//   from run to run). One launch, one recompute of p.
// - dkv: the same block without the dq part.
// - dq:  one block per (64-row q tile, head, image); it walks the k tiles
//   and keeps dq in registers. Deterministic.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3): 2 L^2 D
// FLOP per product per (image, head), 5 products fused, 4 dkv, 3 dq. At
// B=1, L=1025, H=12, D=64, bf16 the fused pass is 8.07 GFLOP -> 8.2 us,
// against ~10 MB of operands -> 3 us: bounded by operations.
//
// Design (the simple correct one, like the forward): 256 threads, each
// owning a 4x4 patch of every 64x64 product; the products run on the f32
// FMA pipes from shared memory, not on the tensor cores. Left for later:
// mma/wgmma, TMA with double buffering, bf16 staging, and a dq reduction
// without atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + kTile - 1) / kTile, p.H, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFused = 0, kDkv = 1, kDq = 2 };

template <typename T, bool kHasBias>
cudaError_t dispatch(Which which, const Params& p, int B,
                     cudaStream_t stream) {
  switch (which) {
    case kFused:
      return launch(flash_attn_bwd_kv_kernel<T, kHasBias, true>, p, B, stream);
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
