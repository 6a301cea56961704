// Chunked Mamba-2 SSD scan for Hopper (sm_90a), fp32, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan/kernel.py
// (`ssd_scan_kernel`, body `_kernel`): per (batch, head), over chunks of Q
// steps, with l = cumsum(dta) inside the chunk,
//
//   y  = tril(C Bᵀ ⊙ exp(l_i − l_j)) · XW + exp(l) ⊙ (C · S_startᵀ)
//   S' = exp(l_Q)·S + Σ_j exp(l_Q − l_j)·XW_j ⊗ B_j
//
// and the state S [P, N] after the last chunk is written out.  An s0
// pointer seeds the state; null means zeros.
//
// What bounds it on the H100: at the serving shape (B = 4, S = 4096,
// H = 64, P = N = 64, Q = 128) the call must move ~0.55 GB (xw in, y out),
// 0.165 ms at 3.35 TB/s, and do ~21.5 GFLOP, 0.130 ms at the rate that
// gives fp32-accurate products on the tensor cores (split TF32, a third of
// 495 TFLOP/s): bound by bytes.  The chunk states add a B·H·C·P·N fp32
// scratch (134 MB there), written once, read and rewritten once, read once.
//
// Design: the TPU kernel walks the chunks in order, carrying S.  Here the
// chunks run in parallel, in the plain version's own order (ref.py), in
// three launches:
//  1. `chunk_states`, one block per (chunk, batch, group of heads): B_c is
//     staged once for the group; per head, l by a warp scan, then
//     state_c = (w ⊙ XW)ᵀ · B with w_j = exp(l_Q − l_j), and the chunk's
//     decay exp(l_Q), into the scratch.
//  2. `state_pass`, one thread per (batch, head, state entry): the short
//     sequential pass S_c = exp(l_Q,c)·S_{c−1} + state_c from s0, which
//     overwrites each chunk's state with the state at its start and writes
//     s_final.
//  3. `chunk_outputs`, one block per (chunk, batch, group of heads):
//     G = C·Bᵀ [Q, Q] once for the group; per head,
//     y = exp(l) ⊙ (C · S_startᵀ) + tril(G ⊙ exp(l_i − l_j)) · XW.
// Every product is mma.sync m16n8k8 TF32 in split form (hi·hi + hi·lo +
// lo·hi, fp32 accumulators), which keeps fp32's accuracy.  The factors
// exp(l_i − l_j) are formed as the A fragments are loaded, only for j <= i:
// above the diagonal l_i − l_j is positive and may be large, and exp of it
// would overflow.  Output tiles are dealt to the warps in an order that
// evens out the triangle's uneven rows.  A block's heads take turns in
// two buffers: the next head's inputs arrive by cp.async (4 bytes each, so
// any strides do) while this head's products run.
//
// Sizes: P and N are padded to T in {16, 32, 64}, Q to a multiple of 16,
// with zeros.  The output launch holds G in shared memory, so its size
// grows as Q²: a chunk whose tiles exceed one block's shared memory fails
// at cudaFuncSetAttribute, and the error is returned.  xw, dta, b, c and y
// are addressed through their element strides, so the caller may pass
// [B, S, H, P] data as a transposed view, no copy.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int THREADS = 256;       // chunk states, state pass
constexpr int WARPS = THREADS / 32;
constexpr int OUT_THREADS = 512;   // chunk outputs: a warp per y tile
constexpr int OUT_WARPS = OUT_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides4 {
  long long a, b, c, d;
};
struct Strides3 {
  long long a, b, c;
};

struct Dims {
  int B, H, P, N, Q;
  int Qp;   // Q padded to a multiple of 16
  int C;    // chunks, S / Q
  int HB;   // heads per block
};

// ---------------------------------------------------------- tensor cores
// x = hi + lo exactly, hi a TF32 value (x truncated to 10 mantissa
// bits).  lo goes to the tensor cores as it is: they read the top 19 bits
// of a TF32 operand, so lo is truncated too, an error of at most 2^-20 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a 16x8 tile (split): a[0..3] at (g, t), (g+8, t),
// (g, t+4), (g+8, t+4) with g = lane / 4, t = lane % 4
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
  }
};
// B fragment of an 8x8 tile (split): b[0], b[1] at (k = t, n = g),
// (k = t + 4, n = g)
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};
// c[x] += a·b[x] for x < NJ in split TF32, the small cross terms first;
// each term goes out over all NJ accumulators in turn, so that
// consecutive products do not wait on each other
template <int NJ>
__device__ __forceinline__ void mma3(float (&c)[NJ][4], const FragA& a,
                                     const FragB (&b)[NJ]) {
#pragma unroll
  for (int x = 0; x < NJ; ++x) mma_tf32(c[x], a.lo, b[x].hi);
#pragma unroll
  for (int x = 0; x < NJ; ++x) mma_tf32(c[x], a.hi, b[x].lo);
#pragma unroll
  for (int x = 0; x < NJ; ++x) mma_tf32(c[x], a.hi, b[x].hi);
}

// cp.async of one float, so that any strides and alignments are read;
// with `ok` false the float is zero-filled and nothing is read
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool ok) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(ok ? 4 : 0)
      : "memory");
}
// rows x cols of a strided matrix into dst[rows_pad][T] (leading
// dimension ld), zero-padded
template <int T>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, long long cs, int rows,
                                      int rows_pad, int cols) {
  for (int e = threadIdx.x; e < rows_pad * T; e += blockDim.x) {
    const int j = e / T, p = e % T;
    const bool ok = j < rows && p < cols;
    cp_async_f32(dst + j * ld + p, ok ? src + j * rs + p * cs : src, ok);
  }
}
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          long long cs, int n, int n_pad) {
  for (int j = threadIdx.x; j < n_pad; j += blockDim.x)
    cp_async_f32(dst + j, j < n ? src + j * cs : src, j < n);
}

// l = cumsum(l) over Q entries in place, by one warp; returns l[Q - 1].
// Each lane reads back only what it wrote itself.
__device__ float warp_cumsum(float* l, int Q, int lane) {
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int j = base + lane;
    float v = j < Q ? l[j] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += t;
    }
    v += carry;
    if (j < Q) l[j] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  return carry;
}

// shared-memory layouts in floats.  Leading dimensions are padded so that
// the fragment loads of a warp hit 32 different banks: an operand read at
// (row g, column t) wants ld = 4 mod 8, one read at (t, g) ld = 8 mod 16.
// A head's inputs are double-buffered: the next head's arrive by cp.async
// while this one's products run.
template <int T>
struct Lay {
  static constexpr int LDK = T + 8;    // [k][n] operands
  static constexpr int LDR = T + 4;    // [row][k] operands
  // B, XW x 2, dta / w x 2
  static size_t states_floats(int Qp) {
    return 3 * static_cast<size_t>(Qp) * LDK + 2 * Qp;
  }
  // C, XW x 2 (the second first holds B for G), S_start x 2, G, dta / l
  // x 2, exp(l)
  static size_t outputs_floats(int Qp) {
    return static_cast<size_t>(Qp) * LDR + 2 * static_cast<size_t>(Qp) * LDK +
           2 * static_cast<size_t>(T) * LDR +
           static_cast<size_t>(Qp) * (Qp + 4) + 3 * Qp;
  }
};

// ------------------------------------------------------ 1. chunk states
template <int T>
__global__ void __launch_bounds__(THREADS)
chunk_states(const float* __restrict__ xw, const float* __restrict__ dta,
             const float* __restrict__ bm, float* __restrict__ states,
             float* __restrict__ decay, Dims d, Strides4 xs, Strides3 ds,
             Strides3 bs) {
  using L = Lay<T>;
  extern __shared__ float smem[];
  // buffer `buf` of a double-buffered array sits at base + buf * size
  float* sB = smem;                              // [Qp][LDK]: B[j][n]
  float* sX = sB + d.Qp * L::LDK;                // 2 x [Qp][LDK]: XW
  float* sL = sX + 2 * d.Qp * L::LDK;            // 2 x [Qp]: dta, then w
  const int ch = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long t0 = static_cast<long long>(ch) * d.Q;
  const int h0 = static_cast<int>(blockIdx.z) * d.HB;
  const int h_end = min(d.H, h0 + d.HB);

  auto stage_head = [&](int hi, int buf) {
    stage<T>(sX + buf * d.Qp * L::LDK, L::LDK,
             xw + bi * xs.a + hi * xs.b + t0 * xs.c, xs.c, xs.d, d.Q, d.Qp,
             d.P);
    stage_vec(sL + buf * d.Qp, dta + bi * ds.a + hi * ds.b + t0 * ds.c, ds.c,
              d.Q, d.Qp);
    cp_async_commit();
  };
  stage<T>(sB, L::LDK, bm + bi * bs.a + t0 * bs.b, bs.b, bs.c, d.Q, d.Qp,
           d.N);
  stage_head(h0, 0);

  // output tiles of the [T(p), T(n)] state: per warp one row tile of 16 p
  // and NJ n-tiles of 8
  constexpr int NT = T / 8, TILES = (T / 16) * NT;
  constexpr int NJ = TILES >= WARPS ? TILES / WARPS : 1;
  const int rt = warp / (NT / NJ), n_base = (warp % (NT / NJ)) * NJ;
  const bool active = rt < T / 16;

  for (int hi = h0, buf = 0; hi < h_end; ++hi, buf ^= 1) {
    if (hi + 1 < h_end) {
      stage_head(hi + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* w = sL + buf * d.Qp;
    if (warp == 0) {
      const float lq = warp_cumsum(w, d.Q, lane);
      for (int j = lane; j < d.Qp; j += 32)
        w[j] = j < d.Q ? exp2f((lq - w[j]) * LOG2E) : 0.f;
      if (lane == 0)
        decay[(static_cast<long long>(bi) * d.H + hi) * d.C + ch] =
            exp2f(lq * LOG2E);
    }
    __syncthreads();
    if (active) {
      // state[p][n] = Σ_j (w_j XW[j][p]) B[j][n]: A(p, j) = w_j sX[j][p],
      // B(j, n) = sB[j][n]
      const float* x = sX + buf * d.Qp * L::LDK;
      float acc[NJ][4];
#pragma unroll
      for (int a = 0; a < NJ; ++a)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[a][y] = 0.f;
      const int p0 = rt * 16;
      for (int k = 0; k < d.Qp; k += 8) {
        const float wa = w[k + t], wb = w[k + t + 4];
        FragA a;
        const float av[4] = {wa * x[(k + t) * L::LDK + p0 + g],
                             wa * x[(k + t) * L::LDK + p0 + g + 8],
                             wb * x[(k + t + 4) * L::LDK + p0 + g],
                             wb * x[(k + t + 4) * L::LDK + p0 + g + 8]};
        a.set(av);
        FragB bf[NJ];
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          const int n0 = (n_base + c) * 8;
          bf[c].set(sB[(k + t) * L::LDK + n0 + g],
                    sB[(k + t + 4) * L::LDK + n0 + g]);
        }
        mma3(acc, a, bf);
      }
      float* st = states +
                  ((static_cast<long long>(bi) * d.H + hi) * d.C + ch) *
                      d.P * d.N;
#pragma unroll
      for (int c = 0; c < NJ; ++c)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int p = p0 + g + 8 * (y / 2);
          const int n = (n_base + c) * 8 + 2 * t + y % 2;
          if (p < d.P && n < d.N) st[p * d.N + n] = acc[c][y];
        }
    }
    __syncthreads();   // this buffer is refilled two heads on
  }
}

// --------------------------------------------------------- 2. state pass
// eight chunks' loads in flight per thread
__global__ void __launch_bounds__(THREADS)
state_pass(float* __restrict__ states, const float* __restrict__ decay,
           const float* __restrict__ s0, float* __restrict__ s_final,
           Dims d) {
  const int pn = d.P * d.N;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= pn) return;
  const long long bh = blockIdx.y;
  float s = s0 ? s0[bh * pn + e] : 0.f;
  float* st = states + bh * d.C * pn + e;
  const float* dc = decay + bh * d.C;
  for (int c0 = 0; c0 < d.C; c0 += 8) {
    float add[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      add[u] = c0 + u < d.C ? st[static_cast<long long>(c0 + u) * pn] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < d.C) {
        // the state at the chunk's start replaces its contribution
        st[static_cast<long long>(c0 + u) * pn] = s;
        s = fmaf(dc[c0 + u], s, add[u]);
      }
  }
  s_final[bh * pn + e] = s;
}

// ----------------------------------------------------- 3. chunk outputs
template <int T>
__global__ void __launch_bounds__(OUT_THREADS)
chunk_outputs(const float* __restrict__ xw, const float* __restrict__ dta,
              const float* __restrict__ bm, const float* __restrict__ cm,
              const float* __restrict__ states, float* __restrict__ y,
              Dims d, Strides4 xs, Strides3 ds, Strides3 bs, Strides3 cs,
              Strides4 ys) {
  using L = Lay<T>;
  extern __shared__ float smem[];
  const int ldg = d.Qp + 4;
  // buffer `buf` of a double-buffered array sits at base + buf * size
  float* sC = smem;                                  // [Qp][LDR]
  float* sX = sC + d.Qp * L::LDR;                    // 2 x [Qp][LDK]: XW
  float* sS = sX + 2 * d.Qp * L::LDK;                // 2 x [T][LDR]
  float* sG = sS + 2 * T * L::LDR;                   // [Qp][Qp + 4]
  float* sL = sG + d.Qp * ldg;                       // 2 x [Qp]: dta, l
  float* sE = sL + 2 * d.Qp;                         // exp(l)
  float* sB = sX + d.Qp * L::LDK;                    // [Qp][LDR], for G,
                                                     // in XW's buffer 1
  const int ch = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long t0 = static_cast<long long>(ch) * d.Q;
  const int rtiles = d.Qp / 16;
  const int h0 = static_cast<int>(blockIdx.z) * d.HB;
  const int h_end = min(d.H, h0 + d.HB);

  auto stage_head = [&](int hi, int buf) {
    stage<T>(sX + buf * d.Qp * L::LDK, L::LDK,
             xw + bi * xs.a + hi * xs.b + t0 * xs.c, xs.c, xs.d, d.Q, d.Qp,
             d.P);
    stage<T>(sS + buf * T * L::LDR, L::LDR,
             states + ((static_cast<long long>(bi) * d.H + hi) * d.C + ch) *
                          d.P * d.N,
             d.N, 1, d.P, T, d.N);
    stage_vec(sL + buf * d.Qp, dta + bi * ds.a + hi * ds.b + t0 * ds.c, ds.c,
              d.Q, d.Qp);
    cp_async_commit();
  };
  stage<T>(sC, L::LDR, cm + bi * cs.a + t0 * cs.b, cs.b, cs.c, d.Q, d.Qp,
           d.N);
  stage<T>(sB, L::LDR, bm + bi * bs.a + t0 * bs.b, bs.b, bs.c, d.Q, d.Qp,
           d.N);
  cp_async_commit();
  stage_head(h0, 0);
  cp_async_wait<1>();
  __syncthreads();

  // G = C Bᵀ on its lower triangle of 16x8 tiles, once for all the heads:
  // A(i, n) = sC[i][n], B(n, j) = sB[j][n]
  for (int job = warp; job < rtiles * (d.Qp / 8); job += OUT_WARPS) {
    const int r = job / (d.Qp / 8), ct = job % (d.Qp / 8);
    if (ct * 8 > r * 16 + 15) continue;
    const int i0 = r * 16, j0 = ct * 8;
    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    for (int k = 0; k < T; k += 8) {
      FragA a;
      const float av[4] = {sC[(i0 + g) * L::LDR + k + t],
                           sC[(i0 + g + 8) * L::LDR + k + t],
                           sC[(i0 + g) * L::LDR + k + t + 4],
                           sC[(i0 + g + 8) * L::LDR + k + t + 4]};
      a.set(av);
      FragB bf[1];
      bf[0].set(sB[(j0 + g) * L::LDR + k + t],
                sB[(j0 + g) * L::LDR + k + t + 4]);
      mma3(acc, a, bf);
    }
#pragma unroll
    for (int y2 = 0; y2 < 4; ++y2)
      sG[(i0 + g + 8 * (y2 / 2)) * ldg + j0 + 2 * t + y2 % 2] = acc[0][y2];
  }
  __syncthreads();   // G is whole, and sB may now take the next head

  // y tiles: 16 rows x NJ n-tiles each; row tile r costs r + 1 steps of
  // the triangle, so the jobs go out heaviest first, back and forth over
  // the warps
  constexpr int NJ = T / 8 < 4 ? T / 8 : 4;
  constexpr int CG = T / 8 / NJ;
  const int n_jobs = rtiles * CG;

  for (int hi = h0, buf = 0; hi < h_end; ++hi, buf ^= 1) {
    if (hi + 1 < h_end) {
      stage_head(hi + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = sX + buf * d.Qp * L::LDK;
    const float* ss = sS + buf * T * L::LDR;
    float* sl = sL + buf * d.Qp;
    if (warp == 0) {
      const float lq = warp_cumsum(sl, d.Q, lane);
      // l in log2 units from here on; padding: finite, never unmasked
      for (int j = lane; j < d.Qp; j += 32) {
        sl[j] = (j < d.Q ? sl[j] : lq) * LOG2E;
        sE[j] = exp2f(sl[j]);
      }
    }
    __syncthreads();

    float* y_bh = y + bi * ys.a + hi * ys.b;
    for (int w = warp, lap = 0; w < n_jobs; ++lap,
             w = lap % 2 ? (lap + 1) * OUT_WARPS - 1 - warp
                         : lap * OUT_WARPS + warp) {
      const int r = rtiles - 1 - w / CG, n_base = (w % CG) * NJ;
      const int i0 = r * 16;
      float acc[NJ][4];
#pragma unroll
      for (int x = 0; x < NJ; ++x)
#pragma unroll
        for (int y2 = 0; y2 < 4; ++y2) acc[x][y2] = 0.f;

      // C · S_startᵀ: A(i, n) = sC[i][n], B(n, p) = sS[p][n]
      for (int k = 0; k < T; k += 8) {
        FragA a;
        const float av[4] = {sC[(i0 + g) * L::LDR + k + t],
                             sC[(i0 + g + 8) * L::LDR + k + t],
                             sC[(i0 + g) * L::LDR + k + t + 4],
                             sC[(i0 + g + 8) * L::LDR + k + t + 4]};
        a.set(av);
        FragB bf[NJ];
#pragma unroll
        for (int x = 0; x < NJ; ++x) {
          const int p0 = (n_base + x) * 8;
          bf[x].set(ss[(p0 + g) * L::LDR + k + t],
                    ss[(p0 + g) * L::LDR + k + t + 4]);
        }
        mma3(acc, a, bf);
      }
      const float e0 = sE[i0 + g], e1 = sE[i0 + g + 8];
#pragma unroll
      for (int x = 0; x < NJ; ++x) {
        acc[x][0] *= e0;
        acc[x][1] *= e0;
        acc[x][2] *= e1;
        acc[x][3] *= e1;
      }

      // + tril(G ⊙ exp(l_i − l_j)) · XW over j <= i0 + 15:
      // A(i, j) formed here, B(j, p) = sX[j][p].  Only the k-steps that
      // reach the diagonal block are masked.
      const int ia = i0 + g, ib = i0 + g + 8;
      const float l0 = sl[ia], l1 = sl[ib];
      for (int k = 0; k < i0 + 16; k += 8) {
        const int ja = k + t, jb = k + t + 4;
        const float la = sl[ja], lb = sl[jb];
        float ex[4] = {l0 - la, l1 - la, l0 - lb, l1 - lb};
        if (k + 7 > i0) {
          // the mask goes on the exponent: above the diagonal it is
          // positive and may be large
          ex[0] = ja <= ia ? ex[0] : -INFINITY;
          ex[1] = ja <= ib ? ex[1] : -INFINITY;
          ex[2] = jb <= ia ? ex[2] : -INFINITY;
          ex[3] = jb <= ib ? ex[3] : -INFINITY;
        }
        const float av[4] = {sG[ia * ldg + ja] * exp2f(ex[0]),
                             sG[ib * ldg + ja] * exp2f(ex[1]),
                             sG[ia * ldg + jb] * exp2f(ex[2]),
                             sG[ib * ldg + jb] * exp2f(ex[3])};
        FragA a;
        a.set(av);
        FragB bf[NJ];
#pragma unroll
        for (int x = 0; x < NJ; ++x) {
          const int p0 = (n_base + x) * 8;
          bf[x].set(sx[ja * L::LDK + p0 + g], sx[jb * L::LDK + p0 + g]);
        }
        mma3(acc, a, bf);
      }

#pragma unroll
      for (int x = 0; x < NJ; ++x)
#pragma unroll
        for (int y2 = 0; y2 < 4; ++y2) {
          const int i = i0 + g + 8 * (y2 / 2);
          const int p = (n_base + x) * 8 + 2 * t + y2 % 2;
          if (i < d.Q && p < d.P)
            y_bh[(t0 + i) * ys.c + p * ys.d] = acc[x][y2];
        }
    }
    __syncthreads();   // this buffer is refilled two heads on
  }
}

template <int T>
cudaError_t launch(const float* xw, const float* dta, const float* b,
                   const float* c, const float* s0, float* y, float* s_final,
                   float* states, float* decay, const Dims& d,
                   const Strides4& xs, const Strides3& ds,
                   const Strides3& bs, const Strides3& cs,
                   const Strides4& ys, cudaStream_t stream) {
  using L = Lay<T>;
  const size_t sm1 = L::states_floats(d.Qp) * sizeof(float);
  const size_t sm3 = L::outputs_floats(d.Qp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_outputs<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sm3));
  if (err != cudaSuccess) {
    // a chunk whose tiles exceed one block's shared memory; clear the
    // error, or the next launch's cudaGetLastError would return it
    cudaGetLastError();
    return err;
  }
  const dim3 blocks(d.C, d.B, (d.H + d.HB - 1) / d.HB);
  chunk_states<T><<<blocks, THREADS, sm1, stream>>>(xw, dta, b, states,
                                                    decay, d, xs, ds, bs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass<<<dim3((d.P * d.N + THREADS - 1) / THREADS, d.B * d.H), THREADS,
               0, stream>>>(states, decay, s0, s_final, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_outputs<T><<<blocks, OUT_THREADS, sm3, stream>>>(
      xw, dta, b, c, states, y, d, xs, ds, bs, cs, ys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All tensors fp32.  Strides are in elements: xw and y in (b, h, s, p)
// order, dta in (b, h, s), b and c in (b, s, n).  S must be a multiple of
// Q; s0 may be null.  The caller's plan gives the padded width `tile`
// (16, 32 or 64, at least P and N) and the heads per block, and the
// scratch: states [B, H, S / Q, P, N] and decay [B, H, S / Q], contiguous.
int ssd_scan_fwd(const void* xw, const void* dta, const void* b,
                 const void* c, const void* s0, void* y, void* s_final,
                 void* states, void* decay, int B, int H, int S, int P,
                 int N, int Q, int tile, int heads_per_block, long long xsb,
                 long long xsh, long long xss, long long xsp, long long dsb,
                 long long dsh, long long dss, long long bsb, long long bss,
                 long long bsn, long long csb, long long css, long long csn,
                 long long ysb, long long ysh, long long yss, long long ysp,
                 void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || Q <= 0 || S % Q ||
      P > tile || N > tile || heads_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, H, P, N, Q, (Q + 15) / 16 * 16, S / Q, heads_per_block};
  const Strides4 xs{xsb, xsh, xss, xsp}, ys{ysb, ysh, yss, ysp};
  const Strides3 ds{dsb, dsh, dss}, bs{bsb, bss, bsn}, cs{csb, css, csn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_ARGS                                                         \
  static_cast<const float*>(xw), static_cast<const float*>(dta),         \
      static_cast<const float*>(b), static_cast<const float*>(c),        \
      static_cast<const float*>(s0), static_cast<float*>(y),             \
      static_cast<float*>(s_final), static_cast<float*>(states),         \
      static_cast<float*>(decay), d, xs, ds, bs, cs, ys, st
  cudaError_t err = cudaErrorInvalidValue;
  if (tile == 16) err = launch<16>(SSD_ARGS);
  if (tile == 32) err = launch<32>(SSD_ARGS);
  if (tile == 64) err = launch<64>(SSD_ARGS);
#undef SSD_ARGS
  return static_cast<int>(err);
}

}  // extern "C"
