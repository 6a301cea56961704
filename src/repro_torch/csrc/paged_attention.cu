// Paged decode attention for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (`paged_attention_kernel`, body `_kernel`): one query token per sequence
// attends to the K/V pages its page table names, with an fp32 online
// softmax.  Table entries of -1 are clamped to page 0, pages that start at
// or past the sequence's length are not read, positions at or past the
// length are masked (weight 0), and the denominator is clamped at 1e-30.
//
// What bounds it on the H100: decode reads every K/V byte of the batch's
// context once and does 4 FLOP per byte pair of it, so it is bound by
// memory bandwidth: at the serving path's shapes (B = 8, ~580 tokens,
// Hkv = 4, D = 128, bf16) ~9.5 MB per layer, ~2.8 us at 3.35 TB/s.  This
// first kernel runs one block per (sequence, kv head), B * Hkv = 32 blocks
// on 132 SMs, so it cannot draw the card's full bandwidth; splitting the
// context across blocks (flash-decoding) is later work.
//
// Design:
//  * The TPU kernel's scalar-prefetched page table becomes a table row that
//    each block reads itself; its sequential page grid axis becomes a loop
//    inside the block.
//  * The block loads its G = H / Hkv query heads once, then walks the table
//    in tiles of whole pages (up to 64 tokens), staging K and V in shared
//    memory as fp32, and updates the softmax state of all G rows together,
//    so each K/V byte is read from device memory once for the G heads.
//  * The pool is addressed through the four element strides of the layer's
//    [P, T, Hkv, D] view, so the engine passes its pool without a copy.
//  * K rows are padded to D+1 floats so lanes that read different tokens
//    hit different banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE_TOKENS = 64;  // most tokens staged per iteration
constexpr float NEG = -1e30f;

struct Strides4 {
  long long a, b, c, d;
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
size_t smem_floats(int G) {
  return G * D                          // sQ
         + TILE_TOKENS * (D + 1)        // sK
         + TILE_TOKENS * D              // sV
         + G * TILE_TOKENS              // sP
         + G * D                        // sAcc
         + 3 * G;                       // max, denominator, rescale
}

// q [B, H, D] and o [B, H, D] by strides (b, h, d); pools [P, T, Hkv, D] by
// strides (page, slot, head, d); table [B, PP] int32 contiguous; lengths [B].
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_fwd(const T* __restrict__ q, const T* __restrict__ kp,
          const T* __restrict__ vp, const int* __restrict__ table,
          const int* __restrict__ lengths, T* __restrict__ o,
          Strides4 qs, Strides4 ks, Strides4 vs, Strides4 os, int G,
          int page_tokens, int PP, float scale) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + G * D;
  float* sV = sK + TILE_TOKENS * DP;
  float* sP = sV + TILE_TOKENS * D;
  float* sAcc = sP + G * TILE_TOKENS;
  float* sM = sAcc + G * D;
  float* sL = sM + G;
  float* sA = sL + G;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int len = lengths[b];
  const int* row = table + static_cast<long long>(b) * PP;
  const int n_pages = min(PP, (len + page_tokens - 1) / page_tokens);
  const int tile_pages = max(1, TILE_TOKENS / page_tokens);

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    sQ[i] = to_f(q[b * qs.a + (hk * G + g) * qs.b + c * qs.c]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG;
    sL[g] = 0.f;
  }

  for (int p0 = 0; p0 < n_pages; p0 += tile_pages) {
    const int ntok = min(tile_pages, n_pages - p0) * page_tokens;
    const int t0 = p0 * page_tokens;   // position of the tile's first token
    __syncthreads();   // the previous tile's sP / sV are consumed
    for (int i = tid; i < ntok * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int page = max(row[p0 + r / page_tokens], 0);
      const int slot = r % page_tokens;
      sK[r * DP + c] =
          to_f(kp[page * ks.a + slot * ks.b + hk * ks.c + c * ks.d]);
      sV[r * D + c] =
          to_f(vp[page * vs.a + slot * vs.b + hk * vs.c + c * vs.d]);
    }
    __syncthreads();

    for (int i = tid; i < G * ntok; i += THREADS) {
      const int g = i / ntok, t = i % ntok;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[g * D + d], sK[t * DP + d], s);
      sP[g * TILE_TOKENS + t] = t0 + t < len ? s * scale : NEG;
    }
    __syncthreads();

    // online softmax: one warp per head row
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG;
      for (int t = lane; t < ntok; t += 32)
        mx = fmaxf(mx, sP[g * TILE_TOKENS + t]);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float x = sP[g * TILE_TOKENS + t];
        const float p = x > NEG ? expf(x - m_new) : 0.f;
        sP[g * TILE_TOKENS + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sA[g] = a;
        sL[g] = sL[g] * a + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      float a = sAcc[i] * sA[g];
      for (int t = 0; t < ntok; ++t)
        a = fmaf(sP[g * TILE_TOKENS + t], sV[t * D + c], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, c = i % D;
    const float denom = fmaxf(sL[g], 1e-30f);
    o[b * os.a + (hk * G + g) * os.b + c * os.c] = from_f<T>(sAcc[i] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* o,
                   const Strides4& qs, const Strides4& ks,
                   const Strides4& vs, const Strides4& os, int B, int Hkv,
                   int G, int page_tokens, int PP, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  paged_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(o), qs, ks,
      vs, os, G, page_tokens, PP, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* table, const int* lengths, void* o,
                       const Strides4& qs, const Strides4& ks,
                       const Strides4& vs, const Strides4& os, int B,
                       int Hkv, int G, int page_tokens, int PP, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, kp, vp, table, lengths, o, qs, ks, vs, os, B,
                           Hkv, G, page_tokens, PP, scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, table, lengths, o, qs, ks, vs, os, B,
                           Hkv, G, page_tokens, PP, scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, table, lengths, o, qs, ks, vs, os, B,
                            Hkv, G, page_tokens, PP, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: q and o in
// (b, h, d) order (the fourth is unused), the pools in (page, slot, head, d)
// order.
int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                        const void* table, const void* lengths, void* o,
                        int dtype, int B, int H, int Hkv, int D,
                        int page_tokens, int PP, long long qsb,
                        long long qsh, long long qsd, long long ksp,
                        long long kst, long long ksh, long long ksd,
                        long long vsp, long long vst, long long vsh,
                        long long vsd, long long osb, long long osh,
                        long long osd, float scale, void* stream) {
  const Strides4 qs{qsb, qsh, qsd, 0}, ks{ksp, kst, ksh, ksd},
      vs{vsp, vst, vsh, vsd}, os{osb, osh, osd, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  const int G = H / Hkv;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, kp, vp, tbl, lens, o, qs, ks, vs, os, B,
                            Hkv, G, page_tokens, PP, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, kp, vp, tbl, lens, o, qs, ks, vs,
                                    os, B, Hkv, G, page_tokens, PP, scale,
                                    st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
