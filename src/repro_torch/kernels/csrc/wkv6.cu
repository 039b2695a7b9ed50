// RWKV6 wkv recurrence (data-dependent decay) for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:79 (`wkv6` /
// `_wkv_kernel`).  For each row n, head h and token t, with the state S
// (dh x dh, [key i, value j]) carried across tokens:
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- S[i][j] exp(log_w_t[i]) + k_t[i] v_t[j]
// r/k/v/log_w are (N, T, H, dh) f32; rows fold K members (N = K * B), so
// u is (K, H, dh) and row n reads member n / B's u.  The state is read
// as s0 and written as s_T through (member, slot) strides with the
// trailing (H, dh, dh) contiguous: a layer's view of the serving cache
// pool, (K, count, B, H, dh, dh)[:, c], narrowed on B for one slot, is
// updated in place without a copy.  s0 and s_T may be the same memory:
// each thread reads its own column of the state before any token and
// writes only that column after the last.
//
// The TPU kernel expands each 32-token chunk into dense (CH, CH, dh)
// decay tensors for the MXU and carries the state in VMEM across a
// sequential chunk axis.  Here the recurrence runs as written, token by
// token, which is what a GPU thread does well: the factors exp(log_w)
// are <= 1, so nothing can overflow whatever the decays.
//
// What bounds it: bytes.  Decode (N = K*B = 16, T = 1, H = 64, dh = 64)
// reads and writes the 16.8 MB state, ~34.9 MB in all (~10 us at 3.35
// TB/s); a prefill chunk (N 4, T 128) moves ~50 MB (~15 us) for ~0.54
// GFLOP (~8 us at the 67 TFLOP/s f32 rate).
//
// Design (simple and right first):
//   - one block per (row n, head h), one thread per value channel j; the
//     block is dh rounded up to the bucket DH in {32, 64, 128} threads;
//   - thread j holds its column S[:, j] in DH registers (rows i >= dh
//     stay 0), loaded and stored coalesced across the block;
//   - tokens are staged kTC at a time in shared memory: r, k, v,
//     exp(log_w) and u*k, zero past dh and past T, so the inner loop
//     has no guards; every thread reads the same staged word (a
//     broadcast, no bank conflicts);
//   - per token each thread does 3 FMAs per key row i for y, the bonus
//     sum r.(u*k) and the state update.
// Parallelism across tokens (the chunked form) and across the key rows
// of a column are the steps for speed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTC = 16;  // tokens staged per round

template <int DH>
__global__ void __launch_bounds__(DH) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lw,
    const float* __restrict__ u, const float* s0, float* sT,
    float* __restrict__ y, int B, int T, int H, int dh, long long s0_k,
    long long s0_b, long long sT_k, long long sT_b) {
  __shared__ float r_s[kTC][DH];
  __shared__ float k_s[kTC][DH];
  __shared__ float v_s[kTC][DH];
  __shared__ float w_s[kTC][DH];
  __shared__ float uk_s[kTC][DH];

  const int n = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int member = n / B;
  const int b = n % B;
  const int j = threadIdx.x;
  const bool live = j < dh;
  const long long head = static_cast<long long>(h) * dh * dh;
  const float* s_in = s0 + member * s0_k + b * s0_b + head;
  float* s_out = sT + member * sT_k + b * sT_b + head;
  const float uj = live ? u[(static_cast<long long>(member) * H + h) * dh + j]
                        : 0.f;
  const long long row_stride = static_cast<long long>(H) * dh;
  const long long at0 = static_cast<long long>(n) * T * row_stride +
                        static_cast<long long>(h) * dh + j;

  float S[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i)
    S[i] = (live && i < dh) ? s_in[static_cast<long long>(i) * dh + j] : 0.f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int nt = min(kTC, T - t0);
    __syncthreads();  // the previous round's staged tokens are consumed
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 1.f;
      if (live && tt < nt) {
        const long long at = at0 + (t0 + tt) * row_stride;
        rv = r[at];
        kv = k[at];
        vv = v[at];
        wv = expf(lw[at]);
      }
      r_s[tt][j] = rv;
      k_s[tt][j] = kv;
      v_s[tt][j] = vv;
      w_s[tt][j] = wv;
      uk_s[tt][j] = uj * kv;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = v_s[tt][j];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float ri = r_s[tt][i];
        acc = fmaf(ri, S[i], acc);
        bonus = fmaf(ri, uk_s[tt][i], bonus);
        S[i] = fmaf(S[i], w_s[tt][i], k_s[tt][i] * vj);
      }
      if (live) y[at0 + (t0 + tt) * row_stride] = fmaf(bonus, vj, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DH; ++i)
      if (i < dh) s_out[static_cast<long long>(i) * dh + j] = S[i];
  }
}

template <int DH>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* s0,
                   float* sT, float* y, int K, int B, int T, int H, int dh,
                   long long s0_k, long long s0_b, long long sT_k,
                   long long sT_b, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(K) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  wkv6_kernel<DH><<<static_cast<unsigned>(blocks), DH, 0, stream>>>(
      r, k, v, lw, u, s0, sT, y, B, T, H, dh, s0_k, s0_b, sT_k, sT_b);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Strides are in floats.  dh must be in [1, 128].
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* lw, const float* u, const float* s0,
                           float* sT, float* y, int K, int B, int T, int H,
                           int dh, long long s0_k, long long s0_b,
                           long long sT_k, long long sT_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dh >= 1 && dh <= 32) {
    e = launch<32>(r, k, v, lw, u, s0, sT, y, K, B, T, H, dh, s0_k, s0_b,
                   sT_k, sT_b, s);
  } else if (dh > 32 && dh <= 64) {
    e = launch<64>(r, k, v, lw, u, s0, sT, y, K, B, T, H, dh, s0_k, s0_b,
                   sT_k, sT_b, s);
  } else if (dh > 64 && dh <= 128) {
    e = launch<128>(r, k, v, lw, u, s0, sT, y, K, B, T, H, dh, s0_k, s0_b,
                    sT_k, sT_b, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
