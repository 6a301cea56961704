// FlashAttention backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma, TMA), fed by the log-sum-exp that the forward kernel
// (flash_attention.cu, `flash_bf16`) saves when a gradient will be asked
// for.
//
// Replaces no TPU kernel: the JAX package's op differentiates its plain
// jnp version (src/repro/kernels/flash_attention/ops.py, `_bwd`), and so did
// this port's op until this kernel.  That recompute builds several fp32
// tensors of the whole S x S square, causal half included, on every call.
//
// What bounds it on the H100: five products over the visible (q, k) pairs
// (S = Q·Kᵀ, dP = dO·Vᵀ, dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K), 2·D operations
// each per pair and head.  At smollm-360m's training microbatch (B 4,
// S 2048, 15 heads over 5 of 64, causal) that is ~80.6 GFLOP, 0.0815 ms at
// 989 TFLOP/s, against 0.025 ms for its 83.9 MB (q, k, v, out, dO, dq, dk
// and dv once).  So it is bound by operations: every product runs on wgmma
// from shared memory, P and dS are recomputed tile by tile and never leave
// the SM but as bf16 operands, and tiles wholly masked are never visited.
//
// Design:
//  * `flash_bwd_prep`: delta = rowsum(dO ∘ O) in fp32, and the forward's
//    log-sum-exp moved to base 2, into a [B, H, 2, Sq_pad] scratch whose
//    rows past Sq hold lse +inf and delta 0 (Sq_pad: Sq to whole q tiles);
//    it also sets dQ's fp32 accumulator to 0, so the wrapper need not.
//  * `flash_bwd`: one block per (128 kv rows, kv head, batch), two
//    warpgroups of 64 kv rows each, the heaviest (first) kv tiles first.
//    K_j and V_j arrive once by TMA and stay.  The block walks every q head
//    of its group and every 64-row q tile that sees kv tile j (causal: from
//    the diagonal on; a window: up to its right edge), with Q_i, dO_i and
//    their lse / delta rows in a 2-stage ring of TMA and bulk copies
//    counted on mbarriers.  Per q tile, each warpgroup, its kv rows the M of
//    every product but dQ's:
//      Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, SS wgmma, fp32 accumulators, in two
//      groups;
//      Pᵀ = exp2(Sᵀ·scale·log2e − lse2), masked as the forward masks,
//      while dPᵀ is still in flight;
//      dSᵀ = Pᵀ ∘ (dPᵀ − delta), in fp32;
//      dV += Pᵀ·dO and dK += dSᵀ·Q, RS wgmma: Pᵀ and dSᵀ go from the
//      accumulators to bf16 A fragments, with no trip through shared memory;
//      dSᵀ to shared memory as bf16 in the 128-byte swizzle, so that
//      dQ_i = dS·K can read both operands transposed (MN-major); each
//      warpgroup takes half of D over all 128 kv rows;
//      the fp32 dQ tile goes to shared memory and is added into an fp32
//      [B, H, Sq_pad, D] accumulator by one bulk reduce, done in L2 by the
//      copy engine.
//    dK and dV sum the whole group in registers, so they need no atomics.
//    dK takes the softmax scale in the epilogue.
//  * `flash_bwd_dq`: dQ · scale to bf16, in q's [B, Sq, H, D] layout.
//  * V's head may be narrower than Q's and K's (`DV` < `D`, latent
//    attention at (192, 128)): dPᵀ = V·dOᵀ contracts over DV and dV is
//    DV wide, the rest over D.  There the accumulators dK (96 registers a
//    thread) and dV (64) leave no room for dQ's 48 beside P and dS, so
//    dV and dK are waited for before dQ, which each warpgroup computes
//    as three 32-column pieces of its 96 columns; the shared memory is
//    226 KB of the 227 a block may take.
//
// Reductions in another order: dQ's tiles are added in L2 in the order the
// blocks reach them, which changes from run to run (fp32: ~1e-7 of a
// row's size per add); P and dS are rounded to bf16 for their products, as
// the forward rounds P for P·V.  chip_smoke.py holds dq, dk and dv to the
// fp32 plain recompute at 2e-2 of the reference's norm.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using hopper::LOG2E;
using hopper::Strides4;

// D: the head size of Q and K; DV: that of V and dO
template <int D, int DV>
struct BwdCfg {
  static_assert((D >= 64) == (DV >= 64), "one swizzle for all tiles");
  static constexpr int BKV = 128;                 // kv rows per block
  static constexpr int BQ = 64;                   // q rows per tile
  static constexpr int THREADS = 256;             // two warpgroups
  static constexpr int SWB = D >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int SWE = SWB / 2;             // elements per span
  static constexpr int NSUB = D / SWE;            // column sub-tiles, Q / K
  static constexpr int NSUB_V = DV / SWE;         // column sub-tiles, V / dO
  static constexpr int NSUB_MAX = NSUB > NSUB_V ? NSUB : NSUB_V;
  static constexpr int LAYOUT = SWB == 128 ? 1 : 2;
  static constexpr int DH = D / 2;                // dQ columns a warpgroup
  // dQ's columns go in pieces of DQN (all at once up to 64)
  static constexpr int DQN = DH <= 64 ? DH : 32;
  static constexpr int NPIECE = DH / DQN;
  static constexpr bool SPLIT = D != DV;          // dK, dV waited before dQ
  static constexpr int K_BYTES = BKV * D * 2;
  static constexpr int V_BYTES = BKV * DV * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int DO_BYTES = BQ * DV * 2;
  static constexpr int STAGE_BYTES = Q_BYTES + DO_BYTES;
  static constexpr int ROW_BYTES = BQ * 4;        // lse2 or delta of a tile
  static constexpr int STAGES = 2;
  static constexpr int DS_BYTES = BKV * BQ * 2;   // dSᵀ, bf16, 128-byte rows
  static constexpr int DQ_BYTES = BQ * D * 4;     // one dQ tile, fp32
  // 1 KB of slack to align the tiles to the swizzle atom; K, V; each
  // stage's Q and dO; dSᵀ; the dQ tile; each stage's lse2 and delta rows;
  // three barriers
  static constexpr int SMEM = 1024 + K_BYTES + V_BYTES +
                              STAGES * STAGE_BYTES + DS_BYTES + DQ_BYTES +
                              STAGES * 2 * ROW_BYTES + (STAGES + 1) * 8;
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// delta and the base-2 log-sum-exp of each (b, h, q) row, and the row of
// dQ's accumulator set to 0: DV / 8 threads a row, 16 bytes of O and of
// dO each (both with a unit last stride and 16-byte aligned rows) and
// 4·D / (DV / 8) of the accumulator
template <int D, int DV>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o, Strides4 os,
               const __nv_bfloat16* __restrict__ dout, Strides4 dos,
               const float* __restrict__ lse, float* __restrict__ aux,
               float* __restrict__ dq_acc, int H, int Sq, int Sq_pad,
               long long rows) {
  constexpr int TPR = DV / 8;   // threads a row
  constexpr int ZERO4 = D / TPR / 4;   // float4s of dQ a thread zeroes
  const int part = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (256 / TPR) + threadIdx.x / TPR;
  // rows (B·H·Sq_pad) fills whole blocks, so no warp is left part-empty
  // for the shuffles below
  if (row >= rows) return;
  const int q = static_cast<int>(row % Sq_pad);
  const long long bh = row / Sq_pad;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  float4* zero =
      reinterpret_cast<float4*>(dq_acc + row * D + part * (D / TPR));
#pragma unroll
  for (int z = 0; z < ZERO4; ++z) zero[z] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc = 0.f;
  if (q < Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * os.b + q * os.s + h * os.h + part * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + q * dos.s + h * dos.h + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 a = __bfloat1622float2(o2[x]);
      const float2 c = __bfloat1622float2(g2[x]);
      acc += a.x * c.x + a.y * c.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    float* r = aux + bh * 2 * Sq_pad;
    r[q] = q < Sq ? lse[bh * Sq + q] * LOG2E : INFINITY;
    r[Sq_pad + q] = acc;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(256, 1)
flash_bwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ aux, float* __restrict__ dq_acc,
          __nv_bfloat16* __restrict__ dk, Strides4 dks,
          __nv_bfloat16* __restrict__ dv, Strides4 dvs, int group, int Sq,
          int Skv, int Sq_pad, int causal, int window, float sl2,
          float scale) {
  using C = BwdCfg<D, DV>;
  constexpr int BQ = C::BQ, BKV = C::BKV, SWB = C::SWB, SWE = C::SWE;
  constexpr int DH = C::DH, DQN = C::DQN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* sK = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* sV = sK + C::K_BYTES;
  unsigned char* sQ = sV + C::V_BYTES;    // stage s: Q, then dO
  unsigned char* sDS = sQ + C::STAGES * C::STAGE_BYTES;
  float* sDQ = reinterpret_cast<float*>(sDS + C::DS_BYTES);
  float* sRow = sDQ + BQ * D;             // stage s: lse2, then delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRow + C::STAGES * 2 * BQ);
  uint64_t* kvbar = bars + C::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * group;
  const int k0 = blockIdx.x * BKV;
  const int k_last = min(k0 + BKV, Skv) - 1;
  // the q tiles that see some key of this kv tile: causal needs
  // q >= k >= k0, a window q < k + window
  const int nq = (Sq + BQ - 1) / BQ;
  const int t_lo = causal ? min(k0 / BQ, nq) : 0;
  const int t_hi =
      window > 0 ? min(nq, (k_last + window - 1) / BQ + 1) : nq;
  const int n_t = max(0, t_hi - t_lo);
  const int n_it = group * n_t;   // (q head of the group, q tile) pairs

  const CUtensorMap *mq = &tq, *mdo = &tdo;
  auto load_q = [=](int stage, int it) {
    const int h = hk * group + it / n_t, t = t_lo + it % n_t;
    unsigned char* dq_ = sQ + stage * C::STAGE_BYTES;
    unsigned char* ddo = dq_ + C::Q_BYTES;
    float* rows = sRow + stage * 2 * BQ;
    uint64_t* bar = bars + stage;
    hopper::mbar_expect_tx(bar, C::STAGE_BYTES + 2 * C::ROW_BYTES);
#pragma unroll
    for (int sub = 0; sub < C::NSUB_MAX; ++sub) {
      if (sub < C::NSUB)
        hopper::tma_load_4d(dq_ + sub * BQ * SWB, mq, bar, sub * SWE, h,
                            t * BQ, b);
      if (sub < C::NSUB_V)
        hopper::tma_load_4d(ddo + sub * BQ * SWB, mdo, bar, sub * SWE, h,
                            t * BQ, b);
    }
    const float* src =
        aux + (static_cast<long long>(b) * H + h) * 2 * Sq_pad + t * BQ;
    hopper::bulk_load(rows, src, C::ROW_BYTES, bar);
    hopper::bulk_load(rows + BQ, src + Sq_pad, C::ROW_BYTES, bar);
  };

  if (tid == 0) {
    for (int i = 0; i < C::STAGES + 1; ++i) hopper::mbar_init(bars + i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    hopper::mbar_expect_tx(kvbar, C::K_BYTES + C::V_BYTES);
#pragma unroll
    for (int sub = 0; sub < C::NSUB_MAX; ++sub) {
      if (sub < C::NSUB)
        hopper::tma_load_4d(sK + sub * BKV * SWB, &tk, kvbar, sub * SWE, hk,
                            k0, b);
      if (sub < C::NSUB_V)
        hopper::tma_load_4d(sV + sub * BKV * SWB, &tv, kvbar, sub * SWE, hk,
                            k0, b);
    }
    for (int s = 0; s < C::STAGES && s < n_it; ++s) load_q(s, s);
  }

  // this thread's rows of its warpgroup's 64 (r and r + 8) and columns
  // (col0, col0 + 1 in each group of 8), as in every accumulator below
  const int row_in = warp * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;
  const int kw0 = k0 + wg * 64;   // the warpgroup's first kv row
  const int ncol = wg * DH;       // its first dQ column

  float dk_acc[D / 2], dv_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;

  if (n_it > 0) hopper::mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % C::STAGES;
    const int h = hk * group + it / n_t, q0 = (t_lo + it % n_t) * BQ;
    const unsigned char* cQ = sQ + st * C::STAGE_BYTES;
    const unsigned char* cDO = cQ + C::Q_BYTES;
    const float* lse2 = sRow + st * 2 * BQ;
    const float* delta = lse2 + BQ;
    hopper::mbar_wait(bars + st, (it / C::STAGES) & 1);

    // ---- Sᵀ = K Qᵀ, then dPᵀ = V dOᵀ (this warpgroup's 64 kv rows x BQ),
    // two groups, so that P is computed while dPᵀ is in flight
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int sub = kk / (SWE / 16), off = (kk % (SWE / 16)) * 32;
      hopper::wgmma_ss<BQ>(
          s,
          hopper::make_desc(
              hopper::smem_addr(sK + sub * BKV * SWB + wg * 64 * SWB + off),
              16, 8 * SWB, C::LAYOUT),
          hopper::make_desc(hopper::smem_addr(cQ + sub * BQ * SWB + off), 16,
                            8 * SWB, C::LAYOUT),
          1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const int sub = kk / (SWE / 16), off = (kk % (SWE / 16)) * 32;
      hopper::wgmma_ss<BQ>(
          dp,
          hopper::make_desc(
              hopper::smem_addr(sV + sub * BKV * SWB + wg * 64 * SWB + off),
              16, 8 * SWB, C::LAYOUT),
          hopper::make_desc(hopper::smem_addr(cDO + sub * BQ * SWB + off),
                            16, 8 * SWB, C::LAYOUT),
          1);
    }
    hopper::wgmma_commit();

    // ---- Pᵀ, then dSᵀ.  Entry i sits at kv row kw0 + row_in +
    // 8 * ((i / 2) % 2), q column q0 + 8 * (i / 4) + col0 + i % 2.
    const bool masked = kw0 + 63 >= Skv || q0 + BQ > Sq ||
                        (causal && kw0 + 63 > q0) ||
                        (window > 0 && kw0 <= q0 + BQ - 1 - window);
    hopper::wgmma_wait<1>();
    hopper::reg_fence(s);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i / 4) + col0 + i % 2;
      float p = exp2f(s[i] * sl2 - lse2[c]);
      if (masked) {
        const int kpos = kw0 + row_in + 8 * ((i / 2) % 2), qpos = q0 + c;
        const bool ok = kpos < Skv && qpos < Sq &&
                        (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        p = ok ? p : 0.f;
      }
      s[i] = p;
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dp);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dp[i] = s[i] * (dp[i] - delta[8 * (i / 4) + col0 + i % 2]);

    // ---- to bf16 A fragments: k-step j covers q columns 16j .. 16j + 15
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[j][x] = pack_bf16(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);
        dsa[j][x] = pack_bf16(dp[8 * j + 2 * x], dp[8 * j + 2 * x + 1]);
      }

    // ---- dSᵀ to shared memory: row = kv row in the block, 128 bytes of q
    // columns, 16-byte chunk c at chunk c ^ (row % 8) (the 128-byte swizzle)
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = wg * 64 + row_in + 8 * (x % 2);
        const int chunk = 2 * j + x / 2;
        *reinterpret_cast<uint32_t*>(sDS + r * 128 +
                                     ((chunk ^ (r % 8)) * 16) + col0 * 2) =
            dsa[j][x];
      }

    // ---- dV += Pᵀ dO, dK += dSᵀ Q; dO and Q are [BQ rows][DV] and
    // [BQ rows][D], read N-major in column sub-tiles of SWE
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      hopper::wgmma_rs_tb<DV>(
          dv_acc, pa[j],
          hopper::make_desc(hopper::smem_addr(cDO + j * 16 * SWB), BQ * SWB,
                            8 * SWB, C::LAYOUT),
          1);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j)
      hopper::wgmma_rs_tb<D>(
          dk_acc, dsa[j],
          hopper::make_desc(hopper::smem_addr(cQ + j * 16 * SWB), BQ * SWB,
                            8 * SWB, C::LAYOUT),
          1);
    hopper::wgmma_commit();
    if constexpr (C::SPLIT) {
      // P and dS leave the registers before dQ's accumulators come
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dk_acc);
      hopper::reg_fence(dv_acc);
    }

    hopper::fence_proxy_async();
    if (tid == 0) hopper::bulk_wait_read();   // the last dQ tile has left
    __syncthreads();                          // dSᵀ whole, sDQ free

    // ---- dQ_i[:, ncol .. ncol + DH) = dS K over the block's 128 kv rows,
    // in NPIECE pieces of DQN columns; piece p reads K's columns from
    // ncol + p·DQN as dQ's B operand
    float dqp[C::NPIECE][DQN / 2];
#pragma unroll
    for (int p = 0; p < C::NPIECE; ++p)
#pragma unroll
      for (int i = 0; i < DQN / 2; ++i) dqp[p][i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int p = 0; p < C::NPIECE; ++p) {
        const int c = ncol + p * DQN;
        const unsigned char* sKq =
            sK + (c / SWE) * BKV * SWB + (c % SWE) * 2;
        hopper::wgmma_ss_tt<DQN>(
            dqp[p],
            hopper::make_desc(hopper::smem_addr(sDS + kk * 16 * 128),
                              BKV * 128, 8 * 128, 1),
            hopper::make_desc(hopper::smem_addr(sKq + kk * 16 * SWB),
                              BKV * SWB, 8 * SWB, C::LAYOUT),
            1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();   // dQ, and this tile's dV and dK
#pragma unroll
    for (int p = 0; p < C::NPIECE; ++p) hopper::reg_fence(dqp[p]);
    hopper::reg_fence(dk_acc);
    hopper::reg_fence(dv_acc);

    // the tile row-major, [BQ][D] fp32, as dq_acc holds it
#pragma unroll
    for (int p = 0; p < C::NPIECE; ++p)
#pragma unroll
      for (int i = 0; i < DQN / 2; i += 2) {
        const int r = row_in + 8 * ((i / 2) % 2);
        const int c = ncol + p * DQN + 8 * (i / 4) + col0;
        *reinterpret_cast<float2*>(sDQ + r * D + c) =
            make_float2(dqp[p][i], dqp[p][i + 1]);
      }
    hopper::fence_proxy_async();
    __syncthreads();   // the dQ tile whole; this stage's Q and dO consumed
    if (tid == 0) {
      hopper::bulk_reduce_add_f32(
          dq_acc + ((static_cast<long long>(b) * H + h) * Sq_pad + q0) * D,
          sDQ, C::DQ_BYTES);
      hopper::bulk_commit();
      if (it + C::STAGES < n_it) load_q(st, it + C::STAGES);
    }
  }
  if (tid == 0) hopper::bulk_wait();

  // ---- dK · scale and dV, bf16; entry i of an accumulator: row
  // 8 * ((i / 2) % 2), column 8 * (i / 4) + col0 + i % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kw0 + row_in + 8 * r;
    if (kpos >= Skv) continue;
    __nv_bfloat16* kr = dk + b * dks.b + kpos * dks.s + hk * dks.h;
    __nv_bfloat16* vr = dv + b * dvs.b + kpos * dvs.s + hk * dvs.h;
#pragma unroll
    for (int j = 0; j < (D > DV ? D : DV) / 8; ++j) {
      const int c = 8 * j + col0;
      if (j < D / 8)
        *reinterpret_cast<__nv_bfloat162*>(kr + c) = __floats2bfloat162_rn(
            dk_acc[4 * j + 2 * r] * scale,
            dk_acc[4 * j + 2 * r + 1] * scale);
      if (j < DV / 8)
        *reinterpret_cast<__nv_bfloat162*>(vr + c) = __floats2bfloat162_rn(
            dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// dq[b, q, h, :] = bf16(scale · dq_acc[b, h, q, :]), 8 columns a thread,
// in dq's order (contiguous); DV only names the instantiation
template <int D, int DV>
__global__ void __launch_bounds__(256)
flash_bwd_dq(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
             int H, int Sq, int Sq_pad, float scale, long long n8) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * 256) {
    const int d = static_cast<int>(i % (D / 8)) * 8;
    long long r = i / (D / 8);
    const int h = static_cast<int>(r % H);
    r /= H;
    const int q = static_cast<int>(r % Sq);
    const long long b = r / Sq;
    const float4* src = reinterpret_cast<const float4*>(
        acc + ((b * H + h) * Sq_pad + q) * D + d);
    const float4 x = src[0], y = src[1];
    uint4 out;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
    o2[0] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    o2[1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
    o2[2] = __floats2bfloat162_rn(y.x * scale, y.y * scale);
    o2[3] = __floats2bfloat162_rn(y.z * scale, y.w * scale);
    *reinterpret_cast<uint4*>(dq + i * 8) = out;
  }
}

template <int D, int DV>
cudaError_t launch_bwd(const void* const* t, const Strides4* st,
                       const float* lse, float* aux, float* dq_acc, int B,
                       int H, int Hkv, int Sq, int Skv, int Sq_pad,
                       int causal, int window, float scale, int block_q,
                       int block_kv, cudaStream_t stream) {
  using C = BwdCfg<D, DV>;
  if (block_q != C::BQ || block_kv != C::BKV) return cudaErrorInvalidValue;
  if (Sq_pad % C::BQ || Sq_pad < Sq || Sq_pad - Sq >= C::BQ)
    return cudaErrorInvalidValue;
  // t and st: q, k, v, out, dout, dq, dk, dv.  out and dout are read 16
  // bytes at a time, dq written so, dk and dv in pairs of columns; dq is
  // contiguous
  for (int i = 3; i < 8; ++i)
    if (st[i].d != 1) return cudaErrorInvalidValue;
  if (st[5].h != D || st[5].s != static_cast<long long>(H) * D ||
      st[5].b != static_cast<long long>(Sq) * H * D)
    return cudaErrorInvalidValue;
  const long long prep_rows = static_cast<long long>(B) * H * Sq_pad;
  const long long per_block = 256 / (DV / 8);
  flash_bwd_prep<D, DV><<<static_cast<unsigned>((prep_rows + per_block - 1) /
                                            per_block),
                      256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(t[3]), st[3],
      static_cast<const __nv_bfloat16*>(t[4]), st[4], lse, aux, dq_acc, H,
      Sq, Sq_pad, prep_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // after a launch: encoding a map needs a current context, which a thread
  // that has made no CUDA call yet (autograd's device thread, when this
  // backward is the first op it runs) holds only once the runtime has
  // launched something from it
  CUtensorMap maps[4];   // q, k, v, dout
  if (!hopper::encode_bshd_bf16(maps, t[0], st[0], B, Sq, H, D, C::BQ,
                                C::SWB) ||
      !hopper::encode_bshd_bf16(maps + 1, t[1], st[1], B, Skv, Hkv, D,
                                C::BKV, C::SWB) ||
      !hopper::encode_bshd_bf16(maps + 2, t[2], st[2], B, Skv, Hkv, DV,
                                C::BKV, C::SWB) ||
      !hopper::encode_bshd_bf16(maps + 3, t[4], st[4], B, Sq, H, DV, C::BQ,
                                C::SWB))
    return cudaErrorInvalidValue;

  static std::atomic<uint64_t> smem_set{0};
  err = hopper::allow_smem(reinterpret_cast<const void*>(flash_bwd<D, DV>),
                           C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + C::BKV - 1) / C::BKV, Hkv, B);
  flash_bwd<D, DV><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], aux, dq_acc,
      static_cast<__nv_bfloat16*>(const_cast<void*>(t[6])), st[6],
      static_cast<__nv_bfloat16*>(const_cast<void*>(t[7])), st[7], H / Hkv,
      Sq, Skv, Sq_pad, causal, window, scale * LOG2E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n8 = static_cast<long long>(B) * Sq * H * D / 8;
  const long long blocks = (n8 + 255) / 256;
  flash_bwd_dq<D, DV><<<static_cast<unsigned>(blocks < 132 * 16 ? blocks
                                                            : 132 * 16),
                    256, 0, stream>>>(
      dq_acc, static_cast<__nv_bfloat16*>(const_cast<void*>(t[5])), H, Sq,
      Sq_pad, scale, n8);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 q / k [B, S, H(kv), D], v [B, Skv, Hkv, DV], the forward's out and
// the gradient dout [B, Sq, H, DV], its lse fp32 [B, H, Sq]; writes dq,
// dk, dv (dk and dv [B, Skv, Hkv, D | DV] with a unit last stride); D and
// DV equal, or 192 and 128.  `strides` holds
// 8 x 4 element strides in the [B, S, H, D] order of q, k, v, out, dout,
// dq, dk, dv; q, k, v and dout are read by TMA (unit last stride, 16-byte
// aligned base and strides).  aux: fp32 scratch [B, H, 2, Sq_pad]; dq_acc:
// fp32 scratch [B, H, Sq_pad, D] (16-byte aligned); Sq_pad is Sq rounded up to whole
// q tiles.  window <= 0 means no window.  block_q / block_kv are the
// caller's plan and must be the tiles this library was built with.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const float* lse, const void* dout,
                        float* aux, float* dq_acc, void* dq, void* dk,
                        void* dv, int B, int H, int Hkv, int Sq, int Skv,
                        int D, int DV, int Sq_pad, const long long* strides,
                        int causal, int window, float scale, int block_q,
                        int block_kv, void* stream) {
  const void* t[8] = {q, k, v, out, dout, dq, dk, dv};
  Strides4 st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = Strides4{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                     strides[4 * i + 3]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_ARGS                                                         \
  t, st, lse, aux, dq_acc, B, H, Hkv, Sq, Skv, Sq_pad, causal, window, \
      scale, block_q, block_kv, s
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32 && DV == 32) err = launch_bwd<32, 32>(BWD_ARGS);
  if (D == 64 && DV == 64) err = launch_bwd<64, 64>(BWD_ARGS);
  if (D == 128 && DV == 128) err = launch_bwd<128, 128>(BWD_ARGS);
  if (D == 192 && DV == 128) err = launch_bwd<192, 128>(BWD_ARGS);
#undef BWD_ARGS
  return static_cast<int>(err);
}

}  // extern "C"
