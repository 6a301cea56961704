// Paged decode attention for Hopper (sm_90a), fp32 and bf16 inputs: a
// split-KV ("flash-decoding") kernel and a merge.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:76
// (`paged_attention_kernel`, body `_kernel`): one query token per sequence
// attends to the K/V pages its page table names, with an fp32 online
// softmax.  Table entries of -1 read page 0, pages that start at or past
// the sequence's length are not read, positions at or past the length get
// weight 0, the denominator is clamped at 1e-30, and a row with no valid
// position gives 0.
//
// What bounds it on the H100: every K/V byte of the batch's context is read
// once and used for G = H / Hkv query heads, 4·G FLOP per K/V element pair,
// ~7 FLOP per byte at qwen2-7b's G = 7: far below the ~295 FLOP per byte
// at which the bf16 tensor cores, and not memory, become the limit.  So it
// is bound by bytes.  At the serving shape (B = 8, H = 28, Hkv = 4, D =
// 128, 16-token pages, lengths 516 + 7 × 580, bf16) that is 9.37 MB per
// layer, 2.83 us at 3.35 TB/s.  Drawing that bandwidth takes many bytes in
// flight from every SM, which one block per (sequence, kv head), 32 blocks
// on 132 SMs, cannot give.
//
// Design:
//  * Split-KV.  The host splits each table into spans of whole pages
//    (`plan` in kernels/paged_attention/kernel.py, from the table width,
//    never from the device's lengths) and launches a block per (kv head,
//    sequence, span): 4 × 8 × 10 = 320 blocks at the serving shape.  A span
//    wholly at or past its sequence's length returns at once.  Each block
//    writes an fp32 partial (acc [D], m, l for each of its G heads) to
//    scratch the wrapper allocates; `paged_merge` combines the spans by the
//    log-sum-exp rule and writes the output in q's dtype.  With one span
//    the first kernel writes the output itself and no merge runs.
//  * Loads.  A block walks its span in 32-token tiles, each token's K and V
//    row for its kv head (D contiguous elements, 256 bytes at D = 128 bf16)
//    copied by 16-byte cp.async, four lanes per token, into a three-stage
//    ring in shared memory: two tiles are in flight while one is used.
//    Tokens are addressed one by one (page = table[pos / T], one divide
//    per token and tile, none per element), so any page size works.  A
//    token at or past the length is zero-filled, not read.  TMA was not
//    taken: its tensor map is encoded on the host per call, which a
//    host-bound decode step would pay 28 times, and its box would tie the
//    tile to the page size.
//  * K/V stay in their storage dtype in shared memory and are widened to
//    fp32 in registers.  Each row's 16-byte chunks are XOR-swizzled by the
//    row (`Cfg::swz`) so that the reads below hit distinct banks.
//  * The G query heads of the kv head are held together, so each K/V byte
//    is read once for all G.  bf16: each warp takes 16 tokens of a tile
//    and half of the output columns, with a softmax state of its own (no
//    barrier but the ring's); S = Q·Kᵀ on mma.sync m16n8k16 with q as the
//    A operand in registers (G padded to 16 rows) and K by ldmatrix, the
//    online softmax in fp32 on the accumulator fragments, then O += P·V
//    with V by ldmatrix.trans and fp32 sums; the two token halves merge
//    through shared memory at the end.  The products of bf16 q and K are
//    exact in fp32, and P is not rounded to bf16 once: it is split into a
//    bf16 high part and a bf16 remainder in the accumulator's own layout,
//    two products per V fragment, so it keeps 16 significant bits (the
//    output itself is bf16, 8 bits).  Why tensor cores at ~7 FLOP per
//    byte: with the scores, a block-wide softmax and P·V on the CUDA
//    cores (as the fp32 path below runs them) a tile's arithmetic and
//    barriers took longer on the card than its loads, so that design was
//    bound by the instructions it issues, not by bytes.  On mma.sync the
//    same tile is a few dozen instructions per warp.
//    fp32, the parity path: scores on the CUDA cores, four lanes per
//    token; one warp per head row for the softmax; P·V with P never
//    rounded, each thread summing (head, 16-byte column chunk) items over
//    the tile's tokens, so the sums fit in registers at any G.
//  * The pools are read through the strides of the engine's [P, T, Hkv, D]
//    layer view, never copied; the C entry refuses a view whose head dim
//    is not contiguous or whose base or other strides are not 16-byte
//    aligned.
//  * The merge is launched as a programmatic dependent of the split
//    kernel (every split block releases it at once), so its launch
//    overlaps the split kernel and it waits for that grid only before it
//    reads.
//  * The dynamic shared-memory limit is raised once per instantiation and
//    device, not on every launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;          // 4 warps
constexpr int NT = 32;                // tokens per tile
constexpr int STAGES = 3;             // tiles in the cp.async ring
constexpr int SP = NT + 1;            // row stride of the score tile
constexpr int MERGE_THREADS = 128;
constexpr float NEG = -1e30f;
static_assert(THREADS == 4 * NT, "four lanes per token of a tile");
static_assert(NT == 32, "one lane per token in the softmax");

struct Strides4 {
  long long a, b, c, d;
};

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* table;
  const int* lengths;
  void* o;
  float* part_acc;    // [B, H, splits, D]
  float2* part_ml;    // [B, H, splits] of (m, l)
  Strides4 qs, ks, vs, os;
  int H, G, page_tokens, PP, split_tokens;
  float scale;
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

// 16 bytes of the storage dtype widened to fp32: 4 floats or 8 bf16
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two floats x0, x1 as bf16 pairs (x0 in the low half): `hi` rounds them,
// `lo` rounds what that left, so hi + lo carries 16 significant bits
// (relative error <= 2^-16, against 2^-8 for hi alone).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = uint32_t(__bfloat16_as_ushort(h0)) |
       uint32_t(__bfloat16_as_ushort(h1)) << 16;
  lo = uint32_t(__bfloat16_as_ushort(
           __float2bfloat16(x0 - __bfloat162float(h0)))) |
       uint32_t(__bfloat16_as_ushort(
           __float2bfloat16(x1 - __bfloat162float(h1)))) << 16;
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

// Sizes of one instantiation: T the storage dtype, D the head dim, GM the
// most query heads per kv head it takes (8 or 32).
template <typename T, int D, int GM>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);         // elements per chunk
  static constexpr int CPR = D / VEC;                // chunks per row
  static constexpr int TILE = NT * CPR;              // chunks of K per tile
  static constexpr int MT = (GM + 15) / 16;          // 16-row score tiles
  static constexpr size_t RING = size_t(STAGES) * 2 * TILE * 16;
  static_assert(CPR % 4 == 0, "four lanes per row");
  // fp32 P·V: a thread owns (head, column chunk) items, each summed over
  // all tokens of a tile (acc [ITEMS][VEC])
  static constexpr int ITEMS = (GM * CPR + THREADS - 1) / THREADS;
  static_assert(2 * size_t(MT) * 16 * (D + 2) * 4 <= RING,
                "the token halves' sums fit the ring");

  // Where chunk c of row r lies in its row: c XOR swz(r).  Any 8
  // consecutive rows get 8 different XORs (4 on 64-byte rows, which pair
  // up in 128 bytes), so the 8 rows one mma operand load reads fall in
  // different banks; rows 2i and 2i+1 differ in the XOR's bit 2, so the
  // two tokens of a quarter-warp of the fp32 score loop do too.
  static __device__ __forceinline__ int swz(int r) {
    return CPR >= 8 ? (r & 7) ^ ((r & 1) << 2) : (r >> 1) & 3;
  }
};

// dynamic shared memory of a block: the K/V ring, then the fp32 path's
// q [G][D], scores [G][SP], and m, l and rescale factor per head (the
// bf16 path keeps these in registers; one size for both keeps one plan)
__host__ __device__ constexpr size_t smem_bytes(size_t ring, int G, int D) {
  return ring + 4 * size_t(G * D + G * SP + 3 * G);
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(THREADS) paged_fwd(Params p) {
  using C = Cfg<T, D, GM>;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);   // [STAGES][K, V][TILE]
  float* sQ = reinterpret_cast<float*>(smem + C::RING);
  const int G = p.G;
  float* sS = sQ + G * D;
  float* sM = sS + G * SP;
  float* sL = sM + G;
  float* sA = sL + G;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  hopper::launch_dependents();    // the merge may be scheduled already
  const int tok0 = split * p.split_tokens;
  const int cap = min(tok0 + p.split_tokens, p.PP * p.page_tokens);
  // the token of a tile this thread loads (and, in fp32, scores), and its
  // quarter of the row
  const int r = tid >> 2, h = tid & 3;
  const int* row = p.table + static_cast<long long>(b) * p.PP;
  // the length, the table entries of this thread's tokens in the first
  // tiles and q are read together, so that they wait for memory once
  int first_pages[STAGES - 1];
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    const int tok = tok0 + t * NT + r;
    first_pages[t] = tok < cap ? row[tok / p.page_tokens] : 0;
  }
  const int len = p.lengths[b];
  // q: bf16 as the mma A operand in registers (rows past G zero), fp32
  // pre-scaled in shared memory
  const T* q = static_cast<const T*>(p.q) + b * p.qs.a + hk * G * p.qs.b;
  uint32_t qa[MMA ? C::MT : 1][MMA ? D / 16 : 1][4];
  if constexpr (MMA) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = mt * 16 + (lane >> 2) + (j & 1) * 8;
          const int k = ks * 16 + 2 * (lane & 3) + (j >> 1) * 8;
          uint32_t x = 0;
          if (g < G && (GM > 8 || (j & 1) == 0)) {
            const T* qg = q + g * p.qs.b + k * p.qs.c;
            x = uint32_t(__bfloat16_as_ushort(qg[0])) |
                uint32_t(__bfloat16_as_ushort(qg[p.qs.c])) << 16;
          }
          qa[mt][ks][j] = x;
        }
  } else {
    for (int i = tid; i < G * D; i += THREADS)
      sQ[i] = to_f(q[(i / D) * p.qs.b + (i % D) * p.qs.c]) * p.scale;
    for (int g = tid; g < G; g += THREADS) {
      sM[g] = NEG;
      sL[g] = 0.f;
    }
  }
  const int end = min(cap, len);
  T* o = static_cast<T*>(p.o);
  const long long row0 = static_cast<long long>(b) * p.H + hk * G;

  if (tok0 >= end) {      // nothing of this span is in the sequence
    if (splits == 1) {
      for (int i = tid; i < G * D; i += THREADS)
        o[b * p.os.a + (hk * G + i / D) * p.os.b + (i % D) * p.os.c] =
            from_f<T>(0.f);
    } else {       // a zero partial with weight 0: the merge needs no test
      for (int i = tid; i < G * D; i += THREADS)
        p.part_acc[((row0 + i / D) * splits + split) * D + i % D] = 0.f;
      for (int g = tid; g < G; g += THREADS)
        p.part_ml[(row0 + g) * splits + split] = make_float2(NEG, 0.f);
    }
    return;
  }

  const int swz_r = C::swz(r);
  const T* kp = static_cast<const T*>(p.kp);
  const T* vp = static_cast<const T*>(p.vp);

  // cp.async of token r's K and V rows of a tile; the first tiles' table
  // entries were read above
  auto load_tile = [&](int tile, int entry) {
    const int tok = tok0 + tile * NT + r;
    const bool ok = tok < end;
    long long koff = 0, voff = 0;
    if (ok) {
      const int pi = tok / p.page_tokens;
      const int slot = tok - pi * p.page_tokens;
      const long long page = max(tile < STAGES - 1 ? entry : row[pi], 0);
      koff = page * p.ks.a + slot * p.ks.b + hk * p.ks.c;
      voff = page * p.vs.a + slot * p.vs.b + hk * p.vs.c;
    }
    uint4* dk = ring + (tile % STAGES) * 2 * C::TILE + r * C::CPR;
    uint4* dv = dk + C::TILE;
#pragma unroll
    for (int j = 0; j < C::CPR / 4; ++j) {
      const int c = h + 4 * j;
      hopper::cp_async_16(dk + (c ^ swz_r), kp + koff + c * C::VEC, ok);
      hopper::cp_async_16(dv + (c ^ swz_r), vp + voff + c * C::VEC, ok);
    }
  };

  const int n_tiles = (end - tok0 + NT - 1) / NT;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t, first_pages[t]);
    hopper::cp_async_commit();
  }
  // tile i has landed, and every thread is done with tile i - 1, whose
  // stage the load of tile i + STAGES - 1 reuses
  auto next_tile = [&](int i) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1, 0);
    hopper::cp_async_commit();
    return ring + (i % STAGES) * 2 * C::TILE;
  };

  if constexpr (MMA) {
    // Warp w takes tokens 16·(w & 1) .. +15 of every tile and output
    // columns (w >> 1)·D/2 .. +D/2, with a softmax state of its own over
    // its tokens: no barrier but the ring's.  S = Q·Kᵀ, then O += P·V with
    // P (bf16) in the accumulator's fragment layout, on mma.sync.
    constexpr int NJ = D / 16;                 // n8 column tiles per warp
    constexpr int R = C::MT * 16;              // padded rows
    const int th = warp & 1, ch = warp >> 1;
    float m_r[C::MT][2], l_r[C::MT][2], oacc[C::MT][NJ][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m_r[mt][hr] = NEG;
        l_r[mt][hr] = 0.f;
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][nj][e] = 0.f;
    }
    // ldmatrix row of this lane: K's matrices are (tokens 0-7 | 8-15) x
    // (k chunk lo | hi), V's (tokens 0-7 | 8-15) x (column chunk j | j+1)
    const int k_row = th * 16 + (lane & 7) + ((lane >> 4) << 3);
    const int k_hi = (lane >> 3) & 1;
    const int v_row = th * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_hi = lane >> 4;
    const int k_swz = C::swz(k_row), v_swz = C::swz(v_row);

    for (int i = 0; i < n_tiles; ++i) {
      const uint4* tk = next_tile(i);
      const uint4* tv = tk + C::TILE;

      float sc[C::MT][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kb[4];
        hopper::ldmatrix_x4(kb, tk + k_row * C::CPR +
                                    ((2 * ks + k_hi) ^ k_swz));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          hopper::mma_bf16_16816(sc[mt][0], qa[mt][ks], kb[0], kb[1]);
          hopper::mma_bf16_16816(sc[mt][1], qa[mt][ks], kb[2], kb[3]);
        }
      }

      // online softmax of rows lane/4 (e = 0, 1) and lane/4 + 8 (e = 2,
      // 3) over this warp's 16 tokens: the four lanes of a quad hold them
      const int t0 = tok0 + i * NT + th * 16 + 2 * (lane & 3);
      uint32_t pa[C::MT][4], pl[C::MT][4];    // P as bf16 hi + lo
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = NEG;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float x = t0 + nt * 8 + (e & 1) < end
                                  ? sc[mt][nt][e] * p.scale : NEG;
              sc[mt][nt][e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_r[mt][hr], mx);
          const float a = expf(m_r[mt][hr] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
              const float x = sc[mt][nt][e];
              const float w = x > NEG ? expf(x - m_new) : 0.f;
              sc[mt][nt][e] = w;
              sum += w;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l_r[mt][hr] = l_r[mt][hr] * a + sum;
          m_r[mt][hr] = m_new;
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            oacc[mt][nj][2 * hr] *= a;
            oacc[mt][nj][2 * hr + 1] *= a;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_bf16(sc[mt][j >> 1][2 * (j & 1)],
                     sc[mt][j >> 1][2 * (j & 1) + 1], pa[mt][j], pl[mt][j]);
      }

#pragma unroll
      for (int nj = 0; nj < NJ; nj += 2) {
        uint32_t vb[4];
        hopper::ldmatrix_x4_trans(
            vb, tv + v_row * C::CPR + ((ch * NJ + nj + v_hi) ^ v_swz));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          hopper::mma_bf16_16816(oacc[mt][nj], pl[mt], vb[0], vb[1]);
          hopper::mma_bf16_16816(oacc[mt][nj + 1], pl[mt], vb[2], vb[3]);
          hopper::mma_bf16_16816(oacc[mt][nj], pa[mt], vb[0], vb[1]);
          hopper::mma_bf16_16816(oacc[mt][nj + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }

    // the two token halves' (m, l, O) meet in shared memory (the ring,
    // free once every thread is done with the last tile) and are merged
    // by the log-sum-exp rule
    __syncthreads();
    float* red_o = reinterpret_cast<float*>(smem);     // [2][R][D]
    float* red_ml = red_o + 2 * R * D;                 // [2][R][2]
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int c = ch * (D / 2) + nj * 8 + 2 * (lane & 3) + (e & 1);
          red_o[(th * R + g) * D + c] = oacc[mt][nj][e];
        }
      if (ch == 0 && (lane & 3) == 0)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int g = mt * 16 + (lane >> 2) + hr * 8;
          red_ml[(th * R + g) * 2] = m_r[mt][hr];
          red_ml[(th * R + g) * 2 + 1] = l_r[mt][hr];
        }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, c = i % D;
      const float m0 = red_ml[g * 2], l0 = red_ml[g * 2 + 1];
      const float m1 = red_ml[(R + g) * 2], l1 = red_ml[(R + g) * 2 + 1];
      const float m = fmaxf(m0, m1);
      const float w0 = expf(m0 - m), w1 = expf(m1 - m);
      const float x = red_o[g * D + c] * w0 + red_o[(R + g) * D + c] * w1;
      const float l = l0 * w0 + l1 * w1;
      if (splits == 1) {
        o[b * p.os.a + (hk * G + g) * p.os.b + c * p.os.c] =
            from_f<T>(x / fmaxf(l, 1e-30f));
      } else {
        p.part_acc[((row0 + g) * splits + split) * D + c] = x;
        if (c == 0)
          p.part_ml[(row0 + g) * splits + split] = make_float2(m, l);
      }
    }
  } else {
    // fp32, the parity path: scores and P·V on the CUDA cores, one
    // block-wide softmax state per head
    float acc[C::ITEMS][C::VEC];
#pragma unroll
    for (int k = 0; k < C::ITEMS; ++k)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) acc[k][e] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
      const uint4* tk = next_tile(i);
      const uint4* tv = tk + C::TILE;

      // scores: token r for every head, this lane's quarter of the row
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll
      for (int j = 0; j < C::CPR / 4; ++j) {
        const int c = h + 4 * j;
        float kf[C::VEC];
        unpack(tk[r * C::CPR + (c ^ swz_r)], kf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4* qv =
                reinterpret_cast<const float4*>(sQ + g * D + c * C::VEC);
#pragma unroll
            for (int e = 0; e < C::VEC / 4; ++e) {
              const float4 x = qv[e];
              s[g] = fmaf(x.x, kf[4 * e], s[g]);
              s[g] = fmaf(x.y, kf[4 * e + 1], s[g]);
              s[g] = fmaf(x.z, kf[4 * e + 2], s[g]);
              s[g] = fmaf(x.w, kf[4 * e + 3], s[g]);
            }
          }
        }
      }
      const bool valid = tok0 + i * NT + r < end;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {                      // G is the same for the whole block
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
          if ((g & 3) == h) sS[g * SP + r] = valid ? s[g] : NEG;
        }
      }
      __syncthreads();

      // online softmax: one warp per head row, one lane per token
      for (int g = warp; g < G; g += THREADS / 32) {
        const float x = sS[g * SP + lane];
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float e = x > NEG ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(e);
        sS[g * SP + lane] = e;
        if (lane == 0) {
          const float a = expf(m_prev - m_new);
          sA[g] = a;
          sL[g] = sL[g] * a + sum;
          sM[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc · a + P · V
#pragma unroll
      for (int k = 0; k < C::ITEMS; ++k) {
        const int item = tid + k * THREADS;
        if (item < G * C::CPR) {
          const int g = item / C::CPR, c = item % C::CPR;
          const float a = sA[g];
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) acc[k][e] *= a;
          const float* pg = sS + g * SP;
#pragma unroll 4
          for (int t = 0; t < NT; ++t) {
            float vf[C::VEC];
            unpack(tv[t * C::CPR + (c ^ C::swz(t))], vf);
            const float w = pg[t];
#pragma unroll
            for (int e = 0; e < C::VEC; ++e)
              acc[k][e] = fmaf(w, vf[e], acc[k][e]);
          }
        }
      }
    }

    // each item's sums go out as they are: no thread writes sM or sL
    // after the last softmax's barrier
#pragma unroll
    for (int k = 0; k < C::ITEMS; ++k) {
      const int item = tid + k * THREADS;
      if (item < G * C::CPR) {
        const int g = item / C::CPR, c0 = item % C::CPR * C::VEC;
        if (splits == 1) {
          const float l = fmaxf(sL[g], 1e-30f);
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            o[b * p.os.a + (hk * G + g) * p.os.b + (c0 + e) * p.os.c] =
                from_f<T>(acc[k][e] / l);
        } else {
          float* dst = p.part_acc + ((row0 + g) * splits + split) * D + c0;
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) dst[e] = acc[k][e];
        }
      }
    }
    if (splits > 1)
      for (int g = tid; g < G; g += THREADS)
        p.part_ml[(row0 + g) * splits + split] = make_float2(sM[g], sL[g]);
  }
}

// One thread per 4 output columns of a (sequence, head) row: the spans'
// partials weighted by exp(m_s - max m).  An empty span wrote acc = 0,
// m = -1e30, l = 0, so it adds nothing (and a row with no valid position
// ends as 0 / 1e-30 = 0: its weights are exp(0) = 1 on zeros).  Launched
// as a programmatic dependent of the split kernel: it waits for that grid
// before it reads.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_merge(Params p, int D, int splits, int n_quads) {
  hopper::wait_primary();
  const int i = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (i >= n_quads) return;
  const int quads = D / 4;
  const int rw = i / quads, c4 = i - rw * quads;
  const int b = rw / p.H, hh = rw - b * p.H;
  const float2* ml = p.part_ml + static_cast<long long>(rw) * splits;
  const float4* pa = reinterpret_cast<const float4*>(
      p.part_acc + static_cast<long long>(rw) * splits * D) + c4;
  // one pass, rescaling as the running max grows; the loads do not
  // depend on the sums, so unrolled they are in flight together
  float m = NEG, l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float2 x = ml[s];
    const float4 v = pa[s * quads];
    const float m_new = fmaxf(m, x.x);
    const float c = expf(m - m_new), w = expf(x.x - m_new);
    l = fmaf(l, c, w * x.y);
    a.x = fmaf(a.x, c, w * v.x);
    a.y = fmaf(a.y, c, w * v.y);
    a.z = fmaf(a.z, c, w * v.z);
    a.w = fmaf(a.w, c, w * v.w);
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* dst = static_cast<T*>(p.o) + b * p.os.a + hh * p.os.b;
  const float out[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dst[(c4 * 4 + e) * p.os.c] = from_f<T>(out[e] * inv);
}

template <typename T, int D, int GM>
cudaError_t launch(const Params& p, int B, int Hkv, int splits,
                   size_t smem, cudaStream_t stream) {
  using C = Cfg<T, D, GM>;
  if (smem != smem_bytes(C::RING, p.G, D)) return cudaErrorInvalidValue;
  static unsigned raised_on = 0;   // devices whose limit is raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(raised_on >> dev & 1u)) {
    err = cudaFuncSetAttribute(
        paged_fwd<T, D, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(C::RING, GM, D)));
    if (err != cudaSuccess) return err;
    raised_on |= 1u << dev;
  }
  paged_fwd<T, D, GM><<<dim3(Hkv, B, splits), THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n_quads = B * p.H * D / 4;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_quads + MERGE_THREADS - 1) / MERGE_THREADS);
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_merge<T>, p, D, splits, n_quads);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const Params& p, int B, int Hkv, int splits,
                       size_t smem, cudaStream_t stream) {
  if (p.G <= 8) return launch<T, D, 8>(p, B, Hkv, splits, smem, stream);
  if (p.G <= 32) return launch<T, D, 32>(p, B, Hkv, splits, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_d(int D, const Params& p, int B, int Hkv, int splits,
                       size_t smem, cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(p, B, Hkv, splits, smem, stream);
    case 64: return dispatch_g<T, 64>(p, B, Hkv, splits, smem, stream);
    case 128: return dispatch_g<T, 128>(p, B, Hkv, splits, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: q and o in
// (b, h, d) order, the pools in (page, slot, head, d) order.  The pools
// are read by 16-byte copies: d's stride must be 1 and their base and
// other strides 16-byte aligned, else cudaErrorMisalignedAddress is
// returned before any launch.  split_tokens, splits, threads and smem come
// from `plan`; a plan that does not match what this library is built for
// is refused.  With splits > 1 part_acc [B, H, splits, D] and part_ml [B,
// H, splits, 2] are fp32 scratch, and the merge is launched after the
// split kernel.
int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                        const void* table, const void* lengths, void* o,
                        void* part_acc, void* part_ml, int dtype, int B,
                        int H, int Hkv, int D, int page_tokens, int PP,
                        int split_tokens, int splits, int threads,
                        int smem, long long qsb,
                        long long qsh, long long qsd, long long ksp,
                        long long kst, long long ksh, long long ksd,
                        long long vsp, long long vst, long long vsh,
                        long long vsd, long long osb, long long osh,
                        long long osd, float scale, void* stream) {
  if (Hkv < 1 || H % Hkv || splits < 1 || split_tokens < 1 ||
      page_tokens < 1 || threads != THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long vec = dtype == 0 ? 4 : 8;      // elements per 16 bytes
  auto aligned = [vec](const void* base, long long sp, long long st,
                       long long sh, long long sd) {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 && sd == 1 &&
           sp % vec == 0 && st % vec == 0 && sh % vec == 0;
  };
  if (!aligned(kp, ksp, kst, ksh, ksd) || !aligned(vp, vsp, vst, vsh, vsd))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{q, kp, vp, static_cast<const int*>(table),
           static_cast<const int*>(lengths), o,
           static_cast<float*>(part_acc), static_cast<float2*>(part_ml),
           {qsb, qsh, qsd, 0}, {ksp, kst, ksh, ksd}, {vsp, vst, vsh, vsd},
           {osb, osh, osd, 0}, H, H / Hkv, page_tokens, PP, split_tokens,
           scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, p, B, Hkv, splits, smem, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, p, B, Hkv, splits, smem, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
