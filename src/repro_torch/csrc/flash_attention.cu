// FlashAttention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma, TMA), fp32 with FMAs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_fwd_kernel`): causal / sliding-window GQA
// attention with an fp32 online softmax, scale 1/sqrt(D), masked logits
// -1e30 and the denominator clamped at 1e-30.  Masked entries get weight 0,
// so a row with no visible key gives 0, never NaN.
//
// What bounds it on the H100: at qwen2-7b's prefill (S ~ 560, H = 28,
// Hkv = 4, D = 128) ~2.4 GFLOP and ~9.4 MB per layer, so the floor is
// ~2.8 us of memory traffic; at zamba2-1.2b's (B = 4, S = 4096, H = 32,
// D = 64) 275 GFLOP, so the floor is 0.278 ms of bf16 tensor-core work.
// The bf16 kernel feeds the tensor cores from shared memory filled by TMA;
// how close it comes to those floors is measured in PERF.md.
//
// bf16 design (`flash_bf16`):
//  * One block per (128-row q tile, head, batch): two warpgroups of 64 q
//    rows each, held to 128 registers a thread so that two blocks share an
//    SM and one's softmax runs while the other's products do.  The heaviest
//    (last) q tiles go first.  The kv loop starts at the window's left
//    edge and stops at the causal diagonal, so tiles fully above the
//    diagonal or left of the window are never loaded; only tiles that
//    cross the diagonal, the window's edge or the end of k are masked.
//  * The Q tile and a 2-stage ring of 64-row K/V tiles arrive by TMA,
//    completion counted on mbarriers.  The tensor maps are built per call
//    on the host from the views' strides, so q/k/v are read in the model's
//    strided [B, S, H, D] layout (kv head h / G); rows past the end arrive
//    as zeros.  Thread 0 refills a stage once both warpgroups are done
//    with it, so the next tile's copy overlaps this tile's products.
//  * S = Q·Kᵀ and O += P·V are wgmma products with fp32 accumulators.  The
//    tiles use the 128-byte swizzle (64-byte at D = 32) that the wgmma
//    descriptors name; Q and K are K-major, V is read N-major with the
//    transpose bit.  P goes from the S accumulator to bf16 registers as the
//    A operand of P·V, with no trip through shared memory.
//  * The online softmax runs on the accumulator fragments in the exp2
//    domain: each thread holds two rows' entries; row maxima combine over
//    the quad of lanes that share a row, row sums are reduced once at the
//    end.
//  * Given an `lse` pointer (only when a gradient will be asked for), the
//    epilogue also stores each row's log-sum-exp, m + log2(l) taken back
//    to base e, for the backward kernel (flash_attention_bwd.cu); 4 bytes
//    a row against the output's 2·D.  Null costs a branch per row.
//
// fp32 inputs take `flash_fp32`, FMAs out of shared memory: a dtype
// dispatch inside this library, not a fallback.  Only the fp32 parity
// checks run it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using hopper::LOG2E;
using hopper::Strides4;

constexpr float NEG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ bf16, wgmma
template <int D>
struct Bf16Cfg {
  static constexpr int BQ = 128;                  // q rows per block
  static constexpr int BK = 64;                   // kv rows per tile
  static constexpr int THREADS = 256;             // two warpgroups
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int SWE = SWB / 2;             // elements per span
  static constexpr int NSUB = D / SWE;            // column sub-tiles
  static constexpr int LAYOUT = SWB == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one of K, V
  static constexpr int STAGES = 2;
  // 1 KB of slack to align the tiles to the swizzle atom, then the tiles,
  // then three barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 3 * 8;
};

template <int D>
__global__ void __launch_bounds__(256, 2)
flash_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ o, Strides4 os,
           float* __restrict__ lse, int group, int Sq, int Skv, int causal,
           int window, float sl2) {
  using C = Bf16Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, SWB = C::SWB, SWE = C::SWE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* sQ = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* sKV = sQ + C::Q_BYTES;   // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sKV + C::STAGES * 2 * C::KV_BYTES);  // full[0], full[1], q
  uint64_t* qbar = bars + C::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BK;
  const int n_t = max(0, (k_hi + BK - 1) / BK - t_lo);

  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [=](int stage, int t) {
    unsigned char* dk = sKV + stage * 2 * C::KV_BYTES;
    unsigned char* dv = dk + C::KV_BYTES;
    hopper::mbar_expect_tx(bars + stage, 2 * C::KV_BYTES);
#pragma unroll
    for (int sub = 0; sub < C::NSUB; ++sub) {
      hopper::tma_load_4d(dk + sub * BK * SWB, mk, bars + stage, sub * SWE,
                          hk, t * BK, b);
      hopper::tma_load_4d(dv + sub * BK * SWB, mv, bars + stage, sub * SWE,
                          hk, t * BK, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < C::STAGES + 1; ++i) hopper::mbar_init(bars + i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
    for (int sub = 0; sub < C::NSUB; ++sub)
      hopper::tma_load_4d(sQ + sub * BQ * SWB, &tq, qbar, sub * SWE, h, q0,
                          b);
    for (int s = 0; s < C::STAGES && s < n_t; ++s) load_kv(s, t_lo + s);
  }

  // this thread's rows of the warpgroup's 64: r and r + 8
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int wg_first = q0 + wg * 64, wg_last = wg_first + 63;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < n_t; ++it) {
    const int t = t_lo + it, st = it % C::STAGES, k0 = t * BK;
    const unsigned char* sK = sKV + st * 2 * C::KV_BYTES;
    const unsigned char* sV = sK + C::KV_BYTES;
    hopper::mbar_wait(bars + st, (it / C::STAGES) & 1);

    // a tile wholly above this warpgroup's diagonal, or left of its
    // window, adds nothing to its rows
    const bool idle = (causal && k0 > wg_last) ||
                      (window > 0 && k0 + BK - 1 <= wg_first - window);
    if (!idle) {
      // ---- S = Q Kᵀ (this warpgroup's 64 rows x BK)
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int sub = kk / (SWE / 16), off = (kk % (SWE / 16)) * 32;
        const uint64_t da = hopper::make_desc(
            hopper::smem_addr(sQ + sub * BQ * SWB + wg * 64 * SWB + off), 16,
            8 * SWB, C::LAYOUT);
        const uint64_t db = hopper::make_desc(
            hopper::smem_addr(sK + sub * BK * SWB + off), 16, 8 * SWB,
            C::LAYOUT);
        hopper::wgmma_ss<BK>(s, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(s);

      // ---- masks, online softmax in the exp2 domain.  Entry i sits at row
      // row0 + 8 * ((i / 2) % 2), column k0 + 8 * (i / 4) + col0 + i % 2.
      const bool masked = k0 + BK > Skv ||
                          (causal && k0 + BK - 1 > wg_first) ||
                          (window > 0 && k0 <= wg_last - window);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * sl2;
        if (masked) {
          const int qpos = row0 + 8 * ((i / 2) % 2);
          const int kpos = k0 + 8 * (i / 4) + col0 + i % 2;
          const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : NEG;
        }
        s[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        // a masked entry in a row with nothing visible yet has x == m == NEG
        const float p = (masked && s[i] == NEG) ? 0.f : exp2f(s[i] - m[r]);
        s[i] = p;
        l[r] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // ---- P to bf16 A fragments: k-step j covers columns 16j .. 16j + 15
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);
          pa[j][x] = *reinterpret_cast<const uint32_t*>(&v);
        }

      // ---- O += P V; V is [BK rows][D] in column sub-tiles of SWE
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t db = hopper::make_desc(
            hopper::smem_addr(sV + j * 16 * SWB), BK * SWB, 8 * SWB,
            C::LAYOUT);
        hopper::wgmma_rs_tb<D>(acc, pa[j], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
    }

    __syncthreads();   // both warpgroups are done with this stage
    if (tid == 0 && it + C::STAGES < n_t) load_kv(st, t + C::STAGES);
  }

  // ---- O / l; entry i of acc: row row0 + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + col0 + i % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the row's log-sum-exp of the scaled logits, natural base; a row with
    // no visible key stores +inf, so exp(logit - lse) gives it weight 0
    const int qi = row0 + 8 * r;
    if (lse && lane % 4 == 0 && qi < Sq)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qi] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : INFINITY;
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* ob = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      ob[c * os.d] = __float2bfloat16(acc[4 * j + 2 * r] * l[r]);
      ob[(c + 1) * os.d] = __float2bfloat16(acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, float* lse, const Strides4& qs,
                        const Strides4& ks, const Strides4& vs,
                        const Strides4& os, int B, int H,
                        int Hkv, int Sq, int Skv, int causal, int window,
                        float scale, int block_q, int block_k,
                        cudaStream_t stream) {
  using C = Bf16Cfg<D>;
  if (block_q != C::BQ || block_k != C::BK) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!hopper::encode_bshd_bf16(maps, q, qs, B, Sq, H, D, C::BQ, C::SWB) ||
      !hopper::encode_bshd_bf16(maps + 1, k, ks, B, Skv, Hkv, D, C::BK,
                                C::SWB) ||
      !hopper::encode_bshd_bf16(maps + 2, v, vs, B, Skv, Hkv, D, C::BK,
                                C::SWB))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_bf16<D>), C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_bf16<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), os, lse,
      H / Hkv, Sq, Skv, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// ------------------------------------------------------------ fp32, FMAs
// One block per (64-row q tile, head, batch), a loop over 32-row kv tiles.
// Tiles are held in shared memory as fp32, rows padded to D+1 floats so the
// threads of a warp that read different rows hit different banks; each of
// the 256 threads owns a 4x2 block of the score tile and a 4x(D/16) block
// of the output accumulator.
constexpr int F_BQ = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;

template <int D>
constexpr size_t fp32_smem_floats() {
  return F_BQ * (D + 1)        // sQ
         + F_BK * (D + 1)      // sK
         + F_BK * D            // sV
         + F_BQ * (F_BK + 1)   // sP: scores, then probabilities
         + 3 * F_BQ;           // running max, denominator, rescale
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, Strides4 qs,
           Strides4 ks, Strides4 vs, Strides4 os, int group, int Sq, int Skv,
           int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = F_BK + 1;
  constexpr int NJ = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + F_BQ * DP;
  float* sV = sK + F_BK * DP;
  float* sP = sV + F_BK * D;
  float* sM = sP + F_BQ * PP;
  float* sL = sM + F_BQ;
  float* sA = sL + F_BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < F_BQ * D; i += F_THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    sQ[r * DP + c] = qi < Sq ? qb[qi * qs.s + c * qs.d] : 0.f;
  }
  if (tid < F_BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // kv range: from the window's left edge (rounded down to a tile) to the
  // causal diagonal of the tile's last row
  const int q_last = min(q0 + F_BQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / F_BK) * F_BK;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += F_BK) {
    __syncthreads();   // the previous tile's sP / sV are consumed
    for (int i = tid; i < F_BK * D; i += F_THREADS) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool ok = kj < Skv;
      sK[r * DP + c] = ok ? kb[kj * ks.s + c * ks.d] : 0.f;
      sV[r * D + c] = ok ? vb[kj * vs.s + c * vs.d] : 0.f;
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
    for (int r = warp; r < F_BQ; r += F_THREADS / 32) {
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
    for (int c = 0; c < F_BK; ++c) {
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
    float* ob = o + b * os.b + qi * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[(tx + 16 * j) * os.d] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* o, const Strides4& qs, const Strides4& ks,
                        const Strides4& vs, const Strides4& os, int B, int H,
                        int Hkv, int Sq, int Skv, int causal, int window,
                        float scale, int block_q, int block_k,
                        cudaStream_t stream) {
  if (block_q != F_BQ || block_k != F_BK) return cudaErrorInvalidValue;
  const size_t smem = fp32_smem_floats<D>() * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = hopper::allow_smem(
      reinterpret_cast<const void*>(flash_fp32<D>), static_cast<int>(smem),
      smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_fp32<D><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      H / Hkv, Sq, Skv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  lse, when not null (bf16 only),
// receives each row's log-sum-exp of the scaled logits as fp32 [B, H, Sq]
// (natural base, +inf where no key is visible), for the backward.
// Strides are in elements, in the [B, S, H, D] order of each tensor; bf16
// views need a unit last stride and 16-byte aligned base and strides
// (TMA).  window <= 0 means no window.  block_q / block_k are the caller's
// plan and must be the tiles this library was built with for (dtype, D).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, float* lse, int dtype, int B, int H,
                        int Hkv, int Sq, int Skv, int D, long long qsb,
                        long long qss, long long qsh, long long qsd,
                        long long ksb, long long kss, long long ksh,
                        long long ksd, long long vsb, long long vss,
                        long long vsh, long long vsd, long long osb,
                        long long oss, long long osh, long long osd,
                        int causal, int window, float scale, int block_q,
                        int block_k, void* stream) {
  const Strides4 qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd},
      vs{vsb, vss, vsh, vsd}, os{osb, oss, osh, osd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS                                                     \
  qs, ks, vs, os, B, H, Hkv, Sq, Skv, causal, window, scale, block_q, \
      block_k, st
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && !lse) {
    if (D == 32) err = launch_fp32<32>(q, k, v, o, FLASH_ARGS);
    if (D == 64) err = launch_fp32<64>(q, k, v, o, FLASH_ARGS);
    if (D == 128) err = launch_fp32<128>(q, k, v, o, FLASH_ARGS);
  } else if (dtype == 1) {
    if (D == 32) err = launch_bf16<32>(q, k, v, o, lse, FLASH_ARGS);
    if (D == 64) err = launch_bf16<64>(q, k, v, o, lse, FLASH_ARGS);
    if (D == 128) err = launch_bf16<128>(q, k, v, o, lse, FLASH_ARGS);
  }
#undef FLASH_ARGS
  return static_cast<int>(err);
}

}  // extern "C"
