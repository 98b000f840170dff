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
// The entry point dispatches on dtype: 0 (float32) runs the FMA kernel,
// 1 (bfloat16) the tensor-core kernel.
//
// bf16, flash_attn_fwd_tc_kernel: one block of 4 warps per (64-row q tile,
// head, image), each warp 16 q rows. Q, then K and V in two stages, come in
// by 16-byte cp.async (zero-filled past L), so tile t+1 loads while tile t
// computes. S = Q K^T and O += P V run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate; see flash_attn_tc.cuh). The online
// softmax stays on the accumulator fragments (row max by quad shuffles, the
// row sum per thread until the end); p is rounded to bf16 for P V, the TPU
// kernel's rounding point (l.121). The bias rows are 2*L bytes apart, not
// 16-byte aligned, so each thread reads its fragment's bias values with
// 2-byte loads straight into registers. Shared memory 40 KB: up to 5 blocks
// an SM. What it leaves for later: wgmma from shared memory, TMA with
// mbarriers, warp specialisation and persistent blocks.
//
// float32, flash_attn_fwd_kernel: the simple FMA kernel, kept because the
// f32 correctness phases hold it to 1e-4 (TF32 tensor cores would not). One
// block of 256 threads per (64-row q tile, head, image), each thread a 4x4
// patch of the score and output tiles, tiles staged in f32 through shared
// memory by the threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attn_tc.cuh"

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

template <bool kHasBias>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias = nullptr;
  if (kHasBias) {
    bias = static_cast<const float*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
  }

  for (int idx = tid; idx < kBlockM * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    const int row = m0 + r;
    qs[r * kPad + c] = row < L ? q[row * p.q_sl + c] : 0.f;
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
      ks[r * kPad + c] = ok ? k[row * p.k_sl + c] : 0.f;
      vs[r * kD + c] = ok ? v[row * p.v_sl + c] : 0.f;
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
          x += bias[row * p.bias_sl + col];
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

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= L) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / l;
    float* orow = o + ((static_cast<int64_t>(b) * L + row) * p.H + h) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * L + row] = m_i[i] + logf(l);
    }
  }
}

constexpr int kTcThreads = 128;   // 4 warps, 16 q rows each
// Q, and two stages of K and V, bf16
constexpr size_t kTcSmemBytes = sizeof(__nv_bfloat16) * 5 * s4tc::kTileElems;

template <bool kHasBias>
__global__ void __launch_bounds__(kTcThreads, 3)
flash_attn_fwd_tc_kernel(const Params p) {
  using namespace s4tc;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) bf16 smem_tc[];
  bf16* qs = smem_tc;                   // [64][64]
  bf16* ks = qs + kTileElems;           // [2][64][64]
  bf16* vs = ks + 2 * kTileElems;       // [2][64][64]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  // this thread's two q rows (g and g+8 of its warp's 16); the bias rows
  // are clamped into the array, rows past L are never written
  const int row0 = m0 + warp * 16 + g;
  const bf16* brow[2] = {nullptr, nullptr};
  if (kHasBias) {
    const bf16* bias =
        static_cast<const bf16*>(p.bias) + b * p.bias_sb + h * p.bias_sh;
    brow[0] = bias + static_cast<int64_t>(min(row0, L - 1)) * p.bias_sl;
    brow[1] = bias + static_cast<int64_t>(min(row0 + 8, L - 1)) * p.bias_sl;
  }

  load_tile_async<kTcThreads>(qs, q, p.q_sl, m0, L);
  load_tile_async<kTcThreads>(ks, k, p.k_sl, 0, L);
  load_tile_async<kTcThreads>(vs, v, p.v_sl, 0, L);
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  float m_i[2] = {kNegInf, kNegInf};   // running max, log2 units
  float l_i[2] = {0.f, 0.f};           // this thread's share of the sum
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[4][4];

  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int n0 = it * kBlockN;
    if (it + 1 < n_tiles) {   // the next K, V tile into the other stage
      load_tile_async<kTcThreads>(ks + (stage ^ 1) * kTileElems, k, p.k_sl,
                                  n0 + kBlockN, L);
      load_tile_async<kTcThreads>(vs + (stage ^ 1) * kTileElems, v, p.v_sl,
                                  n0 + kBlockN, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(qf[kk], a_addr(qs, warp * 16, kk * 16));
    }

    // bias of (row g | g+8, cols n0 + 8j + 2t + 0|1); columns clamped
    // into the array, those past L are masked below
    float bv[8][4];
    if (kHasBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[j][e] = bf16_at(brow[e >> 1] +
                             min(n0 + 8 * j + 2 * t + (e & 1), L - 1));
    }

    const bf16* kst = ks + stage * kTileElems;
    const bf16* vst = vs + stage * kTileElems;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, b_addr_nk(kst, jj * 16, kk * 16));
        mma_16816(s[2 * jj], qf[kk], kb[0], kb[1]);
        mma_16816(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scores in log2 units; columns past L at -1e30 before the max
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (kHasBias) x = fmaf(bv[j][e], kLog2e, x);
        if (n0 + 8 * j + 2 * t + (e & 1) >= L) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // a row's 64 columns: one lane quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_i[i] - mx[i]);
      m_i[i] = mx[i];
      l_i[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_i[e >> 1]);
        l_i[e >> 1] += s[j][e];
        acc[j][e] *= alpha[e >> 1];
      }
    uint32_t pa[4][4];
    c_to_a(s, pa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, b_addr_kn(vst, jj * 16, kk * 16));
        mma_16816(acc[2 * jj], pa[kk], vb[0], vb[1]);
        mma_16816(acc[2 * jj + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is free for the load two tiles on
  }

  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    const int row = row0 + 8 * i;
    if (row >= L) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    const float inv = 1.f / l;
    bf16* orow = o + ((static_cast<int64_t>(b) * L + row) * p.H + h) * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
    if (t == 0) {
      p.lse[(static_cast<int64_t>(b) * p.H + h) * L + row] =
          m_i[i] * kLn2 + logf(l);
    }
  }
}

template <bool kHasBias>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<kHasBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.H, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kHasBias>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_tc_kernel<kHasBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, p.H, B);
  kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(p);
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
    err = bias ? launch_f32<true>(p, B, s) : launch_f32<false>(p, B, s);
  } else {
    err = bias ? launch_bf16<true>(p, B, s) : launch_bf16<false>(p, B, s);
  }
  return static_cast<int>(err);
}

const char* s4_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
