// Flash-attention forward for Hopper (sm_90a), with an additive logit bias.
//
// Replaces the TPU kernel `_fwd_kernel` (s4former_tpu/ops/flash_attention.py:88,
// launched by `_fwd` at l.133). Same function, not the same blocks:
//
//   o[b, i, h, :] = sum_j softmax_j(q_i . k_j * scale + bias[b, 0|h, i, j]) v_j
//   lse[b, h, i]  = m_i + log(l_i)      (running max m, running sum l)
//
// q, k, v are read in the caller's [B, L, H, D] layout through strides (the
// fused qkv projection's output is used as is: no transpose, no pad). The
// ragged key tail is masked in the kernel; a bias is [B, 1|H, L, L] in the
// q dtype, and a head-broadcast bias (the PASA bias) is indexed by b only.
// Scores, the running max and the running sum are f32, scale = 1/sqrt(D).
// o is written [B, L, H, D] in the q dtype, lse [B, H, L] in f32.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3):
//   max(4*B*H*L^2*D / 989e12 s, (q+k+v+o bytes + one bias per image) / 3.35e12 s)
//   B=1, L=1025, H=12, D=64, bf16: 3.2 GFLOP -> 3.3 us; 8.4 MB with the
//   PASA bias -> 2.5 us. So the kernel is bounded by tensor-core operations.
//
// Design (the simple correct one): one block of 256 threads per
// (64-row q tile, head, image); it walks the 64-row k/v tiles through shared
// memory with an online softmax. Each thread owns a 4x4 patch of the score
// tile and of the output tile. What this leaves on the table: the products
// run on the f32 FMA pipes from shared memory, not on the tensor cores
// (wgmma), tiles are loaded by the threads instead of TMA with no
// double-buffering, and the f32 staging of k, v and p costs shared-memory
// bandwidth. Those are later work; this kernel is the reference for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim (every ViT config of the repo)
constexpr int kBlockM = 64;     // q rows per block
constexpr int kBlockN = 64;     // k rows per tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 elements each
constexpr int kPad = kD + 1;    // f32 row stride: no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBlockM * kPad + kBlockN * kPad + kBlockN * kD +
                     kBlockM * kPad);

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  void* o;
  float* lse;
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

template <typename T, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockM][kPad]
  float* ks = qs + kBlockM * kPad;     // [kBlockN][kPad]
  float* vs = ks + kBlockN * kPad;     // [kBlockN][kD]
  float* ps = vs + kBlockN * kD;       // [kBlockM][kPad]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // columns tx, tx+16, tx+32, tx+48
  const int ty = tid >> 4;   // rows 4*ty .. 4*ty+3
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* bias = nullptr;
  if (kHasBias) {
    bias = static_cast<const T*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
  }

  for (int idx = tid; idx < kBlockM * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    const int row = m0 + r;
    qs[r * kPad + c] = row < L ? to_f32(q[row * p.q_sl + c]) : 0.f;
  }

  float m_i[4];
  float l_i[4];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kBlockN;
    __syncthreads();  // the last tile's p.v is done with ks, vs and ps
    for (int idx = tid; idx < kBlockN * kD; idx += kThreads) {
      const int r = idx / kD;
      const int c = idx % kD;
      const int row = n0 + r;
      const bool ok = row < L;
      ks[r * kPad + c] = ok ? to_f32(k[row * p.k_sl + c]) : 0.f;
      vs[r * kD + c] = ok ? to_f32(v[row * p.v_sl + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * kPad + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kPad + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (col >= L) {
          x = kNegInf;
        } else if (kHasBias && row < L) {
          x += to_f32(bias[row * p.bias_sl + col]);
        }
        s[i][j] = x;
      }
    }

    // online softmax: a row's 64 columns live on the 16 lanes of one
    // half-warp, so xor-shuffles of 8, 4, 2, 1 reduce a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha;
        ps[(4 * ty + i) * kPad + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBlockN; ++c) {
      float pv[4];
      float vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kPad + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[c * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= L) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / l;
    T* orow = o + ((static_cast<int64_t>(b) * L + row) * p.H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * L + row] = m_i[i] + logf(l);
    }
  }
}

template <typename T, bool kHasBias>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<T, kHasBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.H, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16. bias may be null.
int s4_flash_attn_fwd(const void* q, const void* k, const void* v,
                      const void* bias, void* o, void* lse,
                      int64_t q_sb, int64_t q_sl, int64_t q_sh,
                      int64_t k_sb, int64_t k_sl, int64_t k_sh,
                      int64_t v_sb, int64_t v_sl, int64_t v_sh,
                      int64_t bias_sb, int64_t bias_sh, int64_t bias_sl,
                      int B, int L, int H, int D, int dtype, void* stream) {
  if (D != kD || L < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.lse = static_cast<float*>(lse);
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
    err = bias ? launch<float, true>(p, B, s) : launch<float, false>(p, B, s);
  } else {
    err = bias ? launch<__nv_bfloat16, true>(p, B, s)
               : launch<__nv_bfloat16, false>(p, B, s);
  }
  return static_cast<int>(err);
}

const char* s4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
