// FlashAttention-2 forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_fwd_kernel`): causal / sliding-window GQA
// attention with an fp32 online softmax, scale 1/sqrt(D), masked logits
// -1e30 and the denominator clamped at 1e-30.  Masked entries get weight 0,
// so a row with no visible key gives 0, never NaN.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (S ~ 500-600, H = 28, Hkv = 4, D = 128, bf16) the work is ~2.4 GFLOP and
// ~9.4 MB per layer, so the card's floor is ~2.8 us of memory traffic.
// This first kernel does its products with fp32 FMAs out of shared memory
// (no tensor cores), so it is bound by shared-memory bandwidth and FMA
// issue, far above that floor.  `wgmma`, TMA and warp specialisation are
// later work.
//
// Design:
//  * One block per (64-row q tile, head, batch).  The TPU kernel's
//    sequential kv grid axis becomes a loop inside the block over 32-row kv
//    tiles; blocks run in parallel with nothing carried between them.
//  * The kv loop starts at the window's left edge and stops at the causal
//    diagonal, so fully masked tiles are never loaded.
//  * GQA: the kv head is h / G, computed in the kernel; K/V are never
//    repeated.
//  * q/k/v/o are addressed through their element strides in the model's
//    [B, S, H, D] layout: no transposed copy is made.
//  * Tiles are held in shared memory as fp32, rows padded to D+1 floats so
//    the threads of a warp that read different rows hit different banks.
//    Each of the 256 threads owns a 4x2 block of the score tile and a
//    4x(D/16) block of the output accumulator, kept in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 32;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr float NEG = -1e30f;

struct Strides4 {
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1)        // sQ
         + BK * (D + 1)      // sK
         + BK * D            // sV
         + BQ * (BK + 1)     // sP: scores, then probabilities
         + 3 * BQ;           // running max, denominator, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides4 qs,
          Strides4 ks, Strides4 vs, Strides4 os, int group, int Sq, int Skv,
          int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int NJ = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  float* sM = sP + BQ * PP;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    sQ[r * DP + c] = qi < Sq ? to_f(qb[qi * qs.s + c * qs.d]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // kv range: from the window's left edge (rounded down to a tile) to the
  // causal diagonal of the tile's last row
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's sP / sV are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool ok = kj < Skv;
      sK[r * DP + c] = ok ? to_f(kb[kj * ks.s + c * ks.d]) : 0.f;
      sV[r * D + c] = ok ? to_f(vb[kj * vs.s + c * vs.d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = sK[tx * DP + d], k1v = sK[(tx + 16) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(ty + 16 * i) * DP + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool ok = qpos < Sq && kpos < Skv &&
                        (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        sP[r * PP + c] = ok ? s[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per column
    for (int r = warp; r < BQ; r += THREADS / 32) {
      const float x = sP[r * PP + lane];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = x > NEG ? expf(x - m_new) : 0.f;
      const float l_add = warp_sum(p);
      sP[r * PP + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sA[r] = a;
        sL[r] = sL[r] * a + l_add;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
    T* ob = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[(tx + 16 * j) * os.d] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides4& qs, const Strides4& ks,
                   const Strides4& vs, const Strides4& os, int B, int H,
                   int Hkv, int Sq, int Skv, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os,
      H / Hkv, Sq, Skv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, const Strides4& qs, const Strides4& ks,
                       const Strides4& vs, const Strides4& os, int B, int H,
                       int Hkv, int Sq, int Skv, int causal, int window,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, Sq, Skv,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, Sq, Skv,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, H, Hkv, Sq, Skv,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, in the
// [B, S, H, D] order of each tensor.  window <= 0 means no window.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int B, int H, int Hkv, int Sq,
                        int Skv, int D, long long qsb, long long qss,
                        long long qsh, long long qsd, long long ksb,
                        long long kss, long long ksh, long long ksd,
                        long long vsb, long long vss, long long vsh,
                        long long vsd, long long osb, long long oss,
                        long long osh, long long osd, int causal, int window,
                        float scale, void* stream) {
  const Strides4 qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd},
      vs{vsb, vss, vsh, vsd}, os{osb, oss, osh, osd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, o, qs, ks, vs, os, B, H, Hkv, Sq,
                            Skv, causal, window, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, qs, ks, vs, os, B, H,
                                    Hkv, Sq, Skv, causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
