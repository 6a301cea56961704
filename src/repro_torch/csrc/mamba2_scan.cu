// Chunked Mamba-2 SSD scan for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan/kernel.py
// (`ssd_scan_kernel`, body `_kernel`): per (batch, head), over chunks of Q
// steps taken in order, with l = cumsum(dta) inside the chunk,
//
//   y  = tril(C Bᵀ ⊙ exp(l_i − l_j)) · XW + exp(l) ⊙ (C · Sᵀ)
//   S' = exp(l_Q)·S + Σ_j exp(l_Q − l_j)·XW_j ⊗ B_j
//
// and the state S [P, N] after the last chunk is written out.  An s0
// pointer seeds the state; null means zeros.
//
// What bounds it on the H100: at the serving shape (B = 4, S = 4096,
// H = 64, P = N = 64, Q = 128) the call moves ~0.55 GB (xw in, y out) but
// needs ~21.5 GFLOP of fp32 work (the token recurrence, 5·P·N per token
// and head, is less than the chunked form's ~26 GFLOP), so it is bound by
// operations: ~0.32 ms at the 67 TFLOP/s fp32 rate.  This first kernel,
// which does the chunked form's ~34 GFLOP (C·Bᵀ per head), does its
// products with fp32 FMAs out of shared memory, without tensor cores, so
// it is bound by shared-memory traffic and FMA throughput, far above that
// floor; it runs one block per (batch, head), 256 blocks at the serving
// shape and only 64 at batch 1, on 132 SMs.  C·Bᵀ is the same for every
// head of a batch row; a later design can compute it once.
//
// Design:
//  * The TPU kernel carries S in VMEM scratch across a sequential chunk
//    grid axis.  Here one block owns one (batch, head) and loops over the
//    chunks itself, holding S in shared memory in fp32.
//  * Per chunk the block stages xw [Q, P], b and c [Q, N] and dta [Q] in
//    shared memory (rows padded by one float, so the lanes of a warp that
//    read different rows hit different banks), scans dta with one warp,
//    forms the [Q, Q] weights of the intra-chunk product in shared memory,
//    then writes y and updates S.  At Q = 128, P = N = 64 that is 184 KB of
//    dynamic shared memory, one block per SM.
//  * exp(l_i − l_j) is formed only for j <= i: above the diagonal l_i − l_j
//    is positive and may be large, and exp of it would overflow to inf.
//  * xw, dta, b, c and y are addressed through their element strides, so
//    the caller may pass [B, S, H, P] data as a transposed view, no copy.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

struct Strides4 {
  long long a, b, c, d;
};
struct Strides3 {
  long long a, b, c;
};

// shared-memory layout in floats: S [P][N+1], XW [Q][P+1], B and C
// [Q][N+1], M [Q][Q+1], L, E = exp(L), W = exp(L_Q - L) [Q] each
inline size_t smem_floats(int P, int N, int Q) {
  return static_cast<size_t>(P) * (N + 1) + static_cast<size_t>(Q) * (P + 1) +
         2 * static_cast<size_t>(Q) * (N + 1) +
         static_cast<size_t>(Q) * (Q + 1) + 3 * static_cast<size_t>(Q);
}

// xw [B, H, S, P], dta [B, H, S], b/c [B, S, N], y [B, H, S, P] by element
// strides; s0 (may be null) and s_final [B, H, P, N] contiguous.
__global__ void __launch_bounds__(THREADS)
ssd_scan(const float* __restrict__ xw, const float* __restrict__ dta,
         const float* __restrict__ bm, const float* __restrict__ cm,
         const float* __restrict__ s0, float* __restrict__ y,
         float* __restrict__ s_final, int H, int S, int P, int N, int Q,
         Strides4 xs, Strides3 ds, Strides3 bs, Strides3 cs, Strides4 ys) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1, ldq = Q + 1;
  float* sS = smem;
  float* sX = sS + P * ldn;
  float* sB = sX + Q * ldp;
  float* sC = sB + Q * ldn;
  float* sM = sC + Q * ldn;
  float* sL = sM + Q * ldq;
  float* sE = sL + Q;
  float* sW = sE + Q;

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float* xw_bh = xw + bi * xs.a + hi * xs.b;
  const float* dta_bh = dta + bi * ds.a + hi * ds.b;
  const float* b_b = bm + bi * bs.a;
  const float* c_b = cm + bi * cs.a;
  float* y_bh = y + bi * ys.a + hi * ys.b;
  const long long sbase = (static_cast<long long>(bi) * H + hi) * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    sS[p * ldn + n] = s0 ? s0[sbase + e] : 0.f;
  }

  const int n_chunks = S / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long t0 = static_cast<long long>(ch) * Q;
    // ---- stage the chunk
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e % P;
      sX[j * ldp + p] = xw_bh[(t0 + j) * xs.c + p * xs.d];
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e % N;
      sB[j * ldn + n] = b_b[(t0 + j) * bs.b + n * bs.c];
      sC[j * ldn + n] = c_b[(t0 + j) * cs.b + n * cs.c];
    }
    for (int j = tid; j < Q; j += THREADS) sL[j] = dta_bh[(t0 + j) * ds.c];
    __syncthreads();

    // ---- l = cumsum(dta), by warp 0; each lane reads back only what it
    // wrote itself, so the warp needs no barrier inside
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int j = base + tid;
        float v = j < Q ? sL[j] : 0.f;
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(FULL, v, o);
          if (tid >= o) v += t;
        }
        v += carry;
        if (j < Q) sL[j] = v;
        carry = __shfl_sync(FULL, v, 31);
      }
      for (int j = tid; j < Q; j += 32) {   // carry = l_Q now
        sE[j] = expf(sL[j]);
        sW[j] = expf(carry - sL[j]);
      }
    }
    __syncthreads();

    // ---- M[i][j] = (c_i · b_j) exp(l_i − l_j) for j <= i, else 0; the
    // exponent is formed only where it is <= 0
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e % Q;
      float m = 0.f;
      if (j <= i) {
        const float* ci = sC + i * ldn;
        const float* bj = sB + j * ldn;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(ci[n], bj[n], dot);
        m = dot * expf(sL[i] - sL[j]);
      }
      sM[i * ldq + j] = m;
    }
    __syncthreads();

    // ---- y_i = Σ_{j<=i} M[i][j] xw_j + exp(l_i) (c_i · Sᵀ)
    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e % P;
      const float* mi = sM + i * ldq;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(mi[j], sX[j * ldp + p], acc);
      const float* ci = sC + i * ldn;
      const float* sp = sS + p * ldn;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], sp[n], inter);
      y_bh[(t0 + i) * ys.c + p * ys.d] = fmaf(sE[i], inter, acc);
    }
    __syncthreads();   // every read of the old S is done

    // ---- S' = exp(l_Q) S + Σ_j exp(l_Q − l_j) xw_j ⊗ b_j; each thread
    // reads and writes only its own entries
    const float decay = sE[Q - 1];
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(sW[j] * sX[j * ldp + p], sB[j * ldn + n], acc);
      sS[p * ldn + n] = fmaf(decay, sS[p * ldn + n], acc);
    }
    __syncthreads();   // the next chunk overwrites XW, B, C
  }

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    s_final[sbase + e] = sS[p * ldn + n];
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All tensors fp32.  Strides are in elements: xw and y in (b, h, s, p)
// order, dta in (b, h, s), b and c in (b, s, n).  S must be a multiple of
// Q.  s0 may be null.
int ssd_scan_fwd(const void* xw, const void* dta, const void* b,
                 const void* c, const void* s0, void* y, void* s_final,
                 int B, int H, int S, int P, int N, int Q, long long xsb,
                 long long xsh, long long xss, long long xsp, long long dsb,
                 long long dsh, long long dss, long long bsb, long long bss,
                 long long bsn, long long csb, long long css, long long csn,
                 long long ysb, long long ysh, long long yss, long long ysp,
                 void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || Q <= 0 || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    // a (P, N, Q) whose tiles exceed one block's shared memory; clear the
    // error, or the next launch's cudaGetLastError would return it
    cudaGetLastError();
    return static_cast<int>(err);
  }
  ssd_scan<<<B * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(dta),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_final), H, S, P, N, Q,
      Strides4{xsb, xsh, xss, xsp}, Strides3{dsb, dsh, dss},
      Strides3{bsb, bss, bsn}, Strides3{csb, css, csn},
      Strides4{ysb, ysh, yss, ysp});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
