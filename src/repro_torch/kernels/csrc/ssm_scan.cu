// Mamba selective scan h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:26
// (`_scan_kernel`, called by `ssm_scan` at :52).  For each row n (rows
// fold K members: N = K * B), state channel d and state index s:
//     h_t[d][s] = a_t[d][s] * h_{t-1}[d][s] + b_t[d][s]
// a, b and hs are (N, T, D, Ns) f32, contiguous.  The state is read as
// h0 and written as h_T through (member, slot) strides with the trailing
// (D, Ns) contiguous: a Mamba layer's view of the serving cache pool,
// (K, count, B, D, Ns)[:, c], narrowed on B for one slot, is updated in
// place without a copy.  h0 and h_T may be the same memory: each thread
// reads its own state elements before the first step and writes only
// those after the last.
//
// What bounds it: bytes.  The work is elementwise, one FMA per 12 bytes
// of a, b and hs, so tensor cores have nothing to do.  At jamba's
// shapes (D 8192, Ns 16, K = 2): a decode step (N 8, T 1) moves ~21 MB
// (~6.3 us at 3.35 TB/s), a 128-token prefill chunk (N 2) ~405 MB
// (~0.121 ms).
//
// Design (simple and right first):
//   - one thread per four consecutive state elements of one row, as one
//     16-byte vector (a scalar variant takes inputs whose sizes or
//     strides are not multiples of four floats); neighbouring threads
//     read neighbouring addresses at every step, so each warp moves 512
//     contiguous bytes of a, of b and of hs per step;
//   - each thread walks t in order with h in registers, and loads the
//     next 16 / V steps of a and b (V floats a thread) before their FMAs
//     (they do not depend on h): 128 bytes in flight per thread, with
//     registers capped for three 256-thread blocks on each SM;
//   - the grid covers N * D * Ns / 4 threads: 262k at decode, 65k at a
//     prefill chunk; T is not split;
//   - short T (decode is T = 1; below kSmallT = 8) has its own variant:
//     the look-ahead arrays buy nothing there, and their registers held
//     the long-T kernel to three blocks an SM, so the decode's 262k
//     threads ran in about 2.6 waves with 48 bytes in flight each.  The
//     variant walks T one step at a time with 32-bit indexing and
//     registers capped for eight blocks an SM (the whole SM's threads),
//     so a decode step runs in one wave with all of a, b and h0 in
//     flight at once.  It does not replace the long-T kernel: with one
//     step of a and b in flight a thread instead of four, it is 7-10%
//     slower at a prefill chunk and at T 2048 (PERF.md).  kSmallT is
//     where the two tie at the decode shape.
// The TPU kernel's VMEM chunking and padding of T are not carried over:
// the time loop inside a thread takes the place of its sequential grid
// axis, and the thread masks its own ragged end of T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallT = 8;            // T below this takes the short-T kernel
constexpr int kBlocksPerSM = 3;       // T >= kSmallT
constexpr int kSmallBlocksPerSM = 8;  // T < kSmallT: 2048 threads an SM

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float zero() { return 0.f; }
  __device__ static float fma(float a, float h, float b) {
    return fmaf(a, h, b);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 fma(float4 a, float4 h, float4 b) {
    return make_float4(fmaf(a.x, h.x, b.x), fmaf(a.y, h.y, b.y),
                       fmaf(a.z, h.z, b.z), fmaf(a.w, h.w, b.w));
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) ssm_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* h0, float* hT, float* __restrict__ hs, long long n_vec,
    int B, int T, int row_vecs, long long h0_k, long long h0_b,
    long long hT_k, long long hT_b) {  // strides in floats
  using V_ = Vec<V>;
  using vec = typename V_::T;
  constexpr int kAhead = 16 / V;  // steps of a and b loaded ahead of use
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= n_vec) return;
  const long long n = e / row_vecs;  // row: member n / B, slot n % B
  const int j = static_cast<int>(e - n * row_vecs);
  const long long member = n / B, slot = n % B;
  const vec* h_in =
      reinterpret_cast<const vec*>(h0 + member * h0_k + slot * h0_b) + j;
  vec* h_out = reinterpret_cast<vec*>(hT + member * hT_k + slot * hT_b) + j;
  const long long base = n * T * row_vecs + j;  // in vectors
  const vec* av = reinterpret_cast<const vec*>(a) + base;
  const vec* bv = reinterpret_cast<const vec*>(b) + base;
  vec* hv = reinterpret_cast<vec*>(hs) + base;

  vec h = *h_in;
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    vec at[kAhead], bt[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool live = t0 + u < T;
      const long long off = static_cast<long long>(t0 + u) * row_vecs;
      at[u] = live ? av[off] : V_::zero();
      bt[u] = live ? bv[off] : V_::zero();
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t0 + u < T) {
        h = V_::fma(at[u], h, bt[u]);
        hv[static_cast<long long>(t0 + u) * row_vecs] = h;
      }
    }
  }
  *h_out = h;
}

// The short-T variant: the same recurrence one step at a time, with
// 32-bit indexing (n_vec < 2^31) so that it fits the 32 registers of
// eight blocks an SM.
template <int V>
__global__ void __launch_bounds__(kThreads, kSmallBlocksPerSM)
    ssm_scan_small_kernel(const float* __restrict__ a,
                          const float* __restrict__ b, const float* h0,
                          float* hT, float* __restrict__ hs, int n_vec, int B,
                          int T, int row_vecs, long long h0_k, long long h0_b,
                          long long hT_k, long long hT_b) {
  using V_ = Vec<V>;
  using vec = typename V_::T;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_vec) return;
  const int n = e / row_vecs, j = e - n * row_vecs;
  const int member = n / B, slot = n - member * B;
  const vec h_in = *(reinterpret_cast<const vec*>(h0 + member * h0_k +
                                                  slot * h0_b) + j);
  const long long base = static_cast<long long>(n) * T * row_vecs + j;
  const vec* av = reinterpret_cast<const vec*>(a) + base;
  const vec* bv = reinterpret_cast<const vec*>(b) + base;
  vec* hv = reinterpret_cast<vec*>(hs) + base;
  vec h = h_in;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const long long off = static_cast<long long>(t) * row_vecs;
    h = V_::fma(av[off], h, bv[off]);
    hv[off] = h;
  }
  *(reinterpret_cast<vec*>(hT + member * hT_k + slot * hT_b) + j) = h;
}

// plan: {small-T variant (1) or not (0), blocks, threads, floats a
// vector, steps loaded ahead}
constexpr int kPlanInts = 5;

template <int V>
cudaError_t launch(const float* a, const float* b, const float* h0,
                   float* hT, float* hs, int K, int B, int T, int D, int Ns,
                   long long h0_k, long long h0_b, long long hT_k,
                   long long hT_b, int* plan, cudaStream_t stream) {
  const int row_vecs = D * Ns / V;
  const long long n_vec = static_cast<long long>(K) * B * row_vecs;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool small = T < kSmallT && n_vec <= 0x7fffffffLL;
  if (plan) {
    const int p[kPlanInts] = {small ? 1 : 0, static_cast<int>(blocks),
                              kThreads, V, small ? 1 : 16 / V};
    for (int i = 0; i < kPlanInts; ++i) plan[i] = p[i];
  }
  if (small)
    ssm_scan_small_kernel<V>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            a, b, h0, hT, hs, static_cast<int>(n_vec), B, T, row_vecs, h0_k,
            h0_b, hT_k, hT_b);
  else
    ssm_scan_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(a, b, h0, hT, hs, n_vec, B, T, row_vecs,
                                   h0_k, h0_b, hT_k, hT_b);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Strides are in floats.  Takes the 16-byte path when every pointer is
// 16-byte aligned and D * Ns and the state's strides are multiples of 4,
// and the small-T variant when T < kSmallT.  `plan`, if not null,
// receives kPlanInts ints describing the launch.
extern "C" int ssm_scan_launch(const float* a, const float* b,
                               const float* h0, float* hT, float* hs, int K,
                               int B, int T, int D, int Ns, long long h0_k,
                               long long h0_b, long long hT_k,
                               long long hT_b, int* plan, void* stream) {
  if (K <= 0 || B <= 0 || T <= 0 || D <= 0 || Ns <= 0 ||
      static_cast<long long>(D) * Ns > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (static_cast<long long>(D) * Ns) % 4 == 0 &&
                    h0_k % 4 == 0 && h0_b % 4 == 0 && hT_k % 4 == 0 &&
                    hT_b % 4 == 0 && aligned16(a) && aligned16(b) &&
                    aligned16(h0) && aligned16(hT) && aligned16(hs);
  cudaError_t e =
      vec4 ? launch<4>(a, b, h0, hT, hs, K, B, T, D, Ns, h0_k, h0_b, hT_k,
                       hT_b, plan, s)
           : launch<1>(a, b, h0, hT, hs, K, B, T, D, Ns, h0_k, h0_b, hT_k,
                       hT_b, plan, s);
  return static_cast<int>(e);
}
