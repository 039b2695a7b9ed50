// RWKV6 wkv recurrence (data-dependent decay) for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:79 (`wkv6` /
// `_wkv_kernel`).  For each row n, head h and token t, with the state S
// (dh x dh, [key i, value j]) carried across tokens:
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- S[i][j] exp(log_w_t[i]) + k_t[i] v_t[j]
// r/k/v/log_w are (N, T, H, dh) f32 with log_w <= 0 (the models' decays
// are -exp(.)); rows fold K members (N = K * B), so u is (K, H, dh) and
// row n reads member n / B's u.  The state is read as s0 and written as
// s_T through (member, slot) strides with the trailing (H, dh, dh)
// contiguous: a layer's view of the serving cache pool, (K, count, B, H,
// dh, dh)[:, c], narrowed on B for one slot, is updated in place without
// a copy.  s0 and s_T may be the same memory: each block reads its own
// part of the state before the first token and writes only that part
// after the last.
//
// What bounds it: bytes, at every shape the models run.  The decode step
// (N = K*B = 16, T 1, H 64, dh 64) reads and writes the 16.8 MB state,
// ~34.9 MB in all (~10 us at 3.35 TB/s); a 128-token prefill chunk (N 4)
// moves ~50 MB (~15 us) for 4 N T H dh^2 = 0.54 GFLOP (~8 us at the 67
// TFLOP/s f32 rate); apply (N 4, T 2048) ~0.68 GB (~0.20 ms) for 8.6
// GFLOP (~0.13 ms).  The token-by-token form cannot reach either: one
// block per (row, head) is 256 blocks of 2 warps at a prefill chunk, each
// token a dependent chain through the whole head.
//
// Design, the chunked path (T > 1):
//   - one block per (row n, head h, tile of CT value columns): column j
//     of S and y[:, j] depend only on v[:, j], so tiles need no talk
//     between blocks.  The intra-chunk scores below are the same for
//     every tile of a head, so each tile recomputes them.  At dh 64 the
//     tile is 64 columns, the whole head (nothing repeated; 256 blocks at
//     rwkv6-7b's prefill, two an SM); tiles of 16 and 32 columns repeat
//     the scores and measured slower (PERF.md).  The tile is fixed per dh
//     bucket at compile time (col_tile below);
//   - a loop over chunks of kCH = 16 tokens inside the block replaces the
//     TPU's sequential chunk axis, and the block is a two-stage pipeline
//     over it.  The scores of chunk c need no state, so score warps 0-3
//     compute chunk c's operands while product warps 4-7 run chunk c - 1's
//     products; named barriers hand each chunk over (kBarReady) and hand
//     its buffers back (kBarFree), and what passes between the stages
//     has two copies by chunk parity.  The score warps stage the next
//     chunk's r, k, log_w and v with cp.async (zero-filled past T and past
//     dh) as soon as its buffers are free.  The tile of S (dh x CT) stays
//     in shared memory, two copies: y reads one while the update writes
//     the other;
//   - inside a chunk all 16 tokens at once, in f32 on the CUDA cores.
//     The TPU kernel (and the JAX model's jnp form) takes differences of
//     la = the running sum of log_w, and their exps; here the decay
//     between two tokens is the product of the w = exp(log_w) <= 1
//     between them, so the only exps are one per token and key, every
//     factor is <= 1, and nothing overflows whatever the decays (the
//     separable exp(la_p[t]) exp(-la[j]) overflows f32 within two tokens
//     of -e^4).  The reference points of the sub-block factorisation are
//     the sub-blocks' ends (kSB = 8 tokens, s0 a sub-block's first):
//       Q[t]  = r[t] prod_{s0 <= q < t} w[q]       (= exp(la_p[t] - m[s]))
//       Kf[j] = k[j] prod_{j < q < s0 + 8} w[q]    (= exp(m[s+1] - la[j]))
//       G[s]  = prod of w over sub-block s,  Rin[t] = Q[t] (t < 8),
//       Rin[t] = Q[t] G[0] (t >= 8)
//       A[t][j] = Q[t] . Kf[j]                 j in sub-block 0, t in 1
//       A[t][j] = sum_i r[t] k[j] prod_{j<q<t} w[q]  (the diagonal
//                 sub-blocks' pairwise decays, a running product over j)
//       A[t][t] = r[t] . (u k[t])              (the bonus)
//       y = A v + Rin S
//       S <- (S G[0] + Kf[0:8]^T v[0:8]) G[1] + Kf[8:16]^T v[8:16]
//         = S G[0] G[1] + (Kf[0:8] G[1])^T v[0:8] + Kf[8:16]^T v[8:16]
//     Masked tokens (k = 0, log_w = 0) are state no-ops by this algebra;
//     y is written at every position;
//   - the products are register-tiled with 16-byte shared loads: warps
//     4-5 compute y (4 tokens x 4 columns a thread at CT 64), warps 6-7
//     the next S (16 keys x 4 columns, kept in registers from chunk to
//     chunk; shared memory gets a copy for y).  The score warps fold the
//     sub-block decays into the state's operands (E = G[0] G[1], Kf of
//     sub-block 0 times G[1]), so the update is S E + Ks^T v: one scaling
//     and 16 rank-1 steps.  The two stages share the SM's instruction
//     issue and shared-memory bandwidth, and neither alone takes most of
//     the time.  Tensor cores (3xTF32 mma.sync or wgmma) for the two
//     dense products and TMA staging are a later step; the tolerance
//     (atol 5e-4, rtol 1e-3) is not one to spend on plain TF32.
// The T = 1 decode step has its own kernel: one 256-thread block per
// (row, head), each thread 4 columns (16-byte accesses) of dh^2 / 1024
// key rows of the state, all its state loads issued before any use, and
// y reduced over the key rows through shared memory.  A 4-byte variant
// of both kernels takes dh, pointers or strides that are not multiples
// of 16 bytes.  kernels/ref.wkv6_chunked is the chunked path's plain
// twin, held against the oracles on the CPU.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCH = 16;               // tokens per chunk
constexpr int kSB = 8;                // tokens per sub-block
constexpr int kNSB = kCH / kSB;       // sub-blocks per chunk
constexpr int kGroup = 128;           // score warps 0-3
constexpr int kProd = 128;            // product warps 4-7
constexpr int kThreads = kGroup + kProd;  // the chunked kernel's block
constexpr int kLPT = kGroup / kCH;    // lanes per token, diagonal pass
constexpr int kStepThreads = 256;     // the T = 1 kernel's block
static_assert(kNSB == 2, "one off-diagonal sub-block pair per chunk");
static_assert(kLPT == kSB, "one lane per score of a diagonal row");
static_assert(kGroup == 2 * kSB * kSB, "two lanes per off-diagonal score");
// named barriers (0 is __syncthreads): within the score warps, within the
// product warps, chunk handed over (score -> product), operands consumed
// (product -> score)
constexpr int kBarScore = 1, kBarProd = 2, kBarReady = 3, kBarFree = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 fma4(float s, float4 b, float4 c) {
  return make_float4(fmaf(s, b.x, c.x), fmaf(s, b.y, c.y), fmaf(s, b.z, c.z),
                     fmaf(s, b.w, c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float comp(float4 a, int e) {
  return e == 0 ? a.x : (e == 1 ? a.y : (e == 2 ? a.z : a.w));
}

__device__ __forceinline__ void set4(float4& a, int e, float x) {
  if (e == 0) a.x = x; else if (e == 1) a.y = x; else if (e == 2) a.z = x;
  else a.w = x;
}

// a[0..7] on each of 8 consecutive lanes -> lane g (= lane % 8) gets the
// sum over the 8 lanes of a[g]: recursive halving, 7 shuffles.
__device__ __forceinline__ float reduce_scatter8(float (&a)[8], int g) {
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) {
    const bool hi = g & o;
#pragma unroll
    for (int e = 0; e < o; ++e) {
      const float send = hi ? a[e] : a[e + o];
      const float keep = hi ? a[e + o] : a[e];
      a[e] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return a[0];
}

// Shared memory of the chunked kernel, in floats.  Rows of token-major
// buffers are padded by 4 floats, so that neighbouring rows start 4 banks
// apart.  The staged r, k and log_w, and what the score warps write for
// the product warps (the scores, Rin, Kf, Ks, E and v) have two copies,
// by chunk parity.
template <int DH, int CT>
struct Layout {
  static constexpr int RS = DH + 4;   // [token][key] row stride
  static constexpr int VS = CT + 4;   // [token or key][column] row stride
  static constexpr int AS = kCH + 4;  // score row stride
  static constexpr int TOK = kCH * RS;
  static constexpr int R = 0,                      // 2 x [kCH][RS] each
      K = R + 2 * TOK, L = K + 2 * TOK, W = L + 2 * TOK,
      Q = W + TOK,                                 // [kSB][RS]: tokens 8-15
      RIN = Q + kSB * RS,                          // 2 x [kCH][RS]
      KF = RIN + 2 * TOK,                          // 2 x [kCH][RS]
      V = KF + 2 * TOK,                            // 2 x [kCH][VS]
      A = V + 2 * kCH * VS,                        // 2 x [kCH][AS]
      S = A + 2 * kCH * AS,                        // 2 x [DH][VS]
      KS = S + 2 * DH * VS,                        // 2 x [kSB][RS]
      E = KS + 2 * kSB * RS,                       // 2 x [DH]
      G = E + 2 * DH,                              // [kNSB][DH]
      U = G + kNSB * DH,                           // [DH]
      FLOATS = U + DH;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

struct Args {
  const float *r, *k, *v, *lw, *u, *s0;
  float *sT, *y;
  int K, B, T, H, dh;
  long long s0_k, s0_b, sT_k, sT_b;  // strides in floats
};

template <int DH, int CT, bool V4>
__global__ void __launch_bounds__(kThreads, 2) wkv6_chunk_kernel(
    Args a, int n_tiles) {
  using L = Layout<DH, CT>;
  constexpr int RS = L::RS, VS = L::VS, AS = L::AS, KQ = DH / 4,
                CG = CT / 4;
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm + L::R;
  float* k_s = sm + L::K;
  float* l_s = sm + L::L;
  float* w_s = sm + L::W;
  float* q_s = sm + L::Q;
  float* rin_s = sm + L::RIN;
  float* kf_s = sm + L::KF;
  float* v_s = sm + L::V;
  float* a_s = sm + L::A;
  float* s_s = sm + L::S;
  float* ks_s = sm + L::KS;  // Kf of sub-block 0 times G[1], for the state
  float* e_s = sm + L::E;    // the chunk's decay G[0] G[1]
  float* g_s = sm + L::G;
  float* u_s = sm + L::U;

  const int tid = threadIdx.x;
  const int jt = blockIdx.x % n_tiles;
  const int nh = blockIdx.x / n_tiles;
  const int n = nh / a.H, h = nh % a.H;
  const int member = n / a.B, slot = n % a.B;
  const int T = a.T, dh = a.dh, col0 = jt * CT;
  const long long tok = static_cast<long long>(a.H) * dh;  // token stride
  const long long head = static_cast<long long>(n) * T * tok +
                         static_cast<long long>(h) * dh;
  const long long hs = static_cast<long long>(h) * dh * dh;
  const int n_chunks = (T + kCH - 1) / kCH;

  // chunk c's r, k, log_w -> r_s, k_s, l_s [c & 1] and its v columns ->
  // v_s[c & 1], by the score warps; nothing past the last chunk.  Each is
  // one cp.async group, committed even when empty, so that the groups a
  // thread waits on are counted the same way at every chunk.  A thread's
  // slots are the same in every chunk: quads tid + k * kGroup, each a
  // token row's 4 keys of one of r, k, log_w (the rows a step of k
  // covers: kGroup / KQ).
  static_assert((kCH * KQ) % kGroup == 0 && kGroup % KQ == 0, "slots");
  constexpr int kPer = kCH * KQ / kGroup;   // slots per array
  const int tt0 = tid / KQ, i0 = (tid % KQ) * 4;
  auto stage_rkl = [&](int c) {
    const int off = (c & 1) * L::TOK;
#pragma unroll
    for (int sl = 0; sl < 3 * kPer; ++sl) {
      const int which = sl / kPer, tt = tt0 + (sl % kPer) * (kGroup / KQ);
      const int t = c * kCH + tt;
      if (c >= n_chunks) break;
      const float* src = which == 0 ? a.r : (which == 1 ? a.k : a.lw);
      float* dst = (which == 0 ? r_s : (which == 1 ? k_s : l_s)) + off +
                   tt * RS + i0;
      const float* at = src + head + t * tok + i0;
      if constexpr (V4) {
        const bool ok = t < T && i0 < dh;
        cp_async16(dst, ok ? at : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = t < T && i0 + q < dh;
          cp_async4(dst + q, ok ? at + q : src, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  auto stage_v = [&](int c) {
    float* vb = v_s + (c & 1) * kCH * VS;
    for (int e = tid; c < n_chunks && e < kCH * CG; e += kGroup) {
      const int tt = e / CG, j = (e % CG) * 4, t = c * kCH + tt;
      const float* at = a.v + head + t * tok + col0 + j;
      if constexpr (V4) {
        const bool ok = t < T && col0 + j < dh;
        cp_async16(vb + tt * VS + j, ok ? at : a.v, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = t < T && col0 + j + q < dh;
          cp_async4(vb + tt * VS + j + q, ok ? at + q : a.v, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  if (tid < kGroup) {
    stage_rkl(0);
    stage_v(0);
  }
  // u, and both score buffers zeroed: their upper triangles are never
  // written
  for (int i = tid; i < DH; i += kThreads)
    u_s[i] = i < dh ? a.u[(static_cast<long long>(member) * a.H + h) * dh + i]
                    : 0.f;
  for (int e = tid; e < 2 * kCH * AS; e += kThreads) a_s[e] = 0.f;
  __syncthreads();

  if (tid < kGroup) {
    // --- the score warps: chunk c's operands while the product warps
    //     run chunk c - 1 ---
    for (int c = 0; c < n_chunks; ++c) {
      const int p = c & 1;
      const float* r_p = r_s + p * L::TOK;
      const float* k_p = k_s + p * L::TOK;
      float* l_p = l_s + p * L::TOK;
      float* a_p = a_s + p * kCH * AS;
      float* rin_p = rin_s + p * L::TOK;
      float* kf_p = kf_s + p * L::TOK;
      float* ks_p = ks_s + p * kSB * RS;
      float* e_p = e_s + p * DH;
      // committed: ..., r/k/log_w of c, v of c (one chunk back); the first
      // has landed when at most one group is pending
      cp_async_wait<1>();
      bar_sync(kBarScore, kGroup);  // chunk c's r, k, log_w landed
      // the next chunk's r, k, log_w go into the copies chunk c - 1 used
      stage_rkl(c + 1);

      // 1. per key i and sub-block sb (a warp: 32 keys of one sub-block):
      //    w = exp(log_w), and the products of w inside the sub-block
      //    before and after each token: Q = r * before, Kf = k * after,
      //    G[sb] = the whole product.  Rin = Q (sub-block 0; sub-block 1's
      //    is scaled by G[0] in step 2)
      for (int e = tid; e < kNSB * DH; e += kGroup) {
        const int sb = (e >> 5) & 1, i = ((e >> 6) << 5) | (e & 31);
        const int t0 = sb * kSB;
        float w[kSB];
#pragma unroll
        for (int t = 0; t < kSB; ++t) {
          w[t] = __expf(l_p[(t0 + t) * RS + i]);
          w_s[(t0 + t) * RS + i] = w[t];
        }
        float before = 1.f, after = 1.f;
#pragma unroll
        for (int t = 0; t < kSB; ++t) {
          const int at = (t0 + t) * RS + i;
          const float q = r_p[at] * before;
          if (sb) q_s[t * RS + i] = q;
          rin_p[at] = q;
          before *= w[t];
          const int bt = (t0 + kSB - 1 - t) * RS + i;
          kf_p[bt] = k_p[bt] * after;
          after *= w[kSB - 1 - t];
        }
        g_s[sb * DH + i] = before;
      }
      bar_sync(kBarScore, kGroup);

      // 2. Rin of sub-block 1 times G[0], the state's Ks and E; the
      //    diagonal sub-blocks and the bonus: 8 lanes per token t, each over
      //    DH / 8 keys; lane g ends with the score of key t - g (g = 0: the
      //    bonus)
      for (int e = tid; e < kSB * KQ; e += kGroup) {
        const int t = e / KQ, i = (e % KQ) * 4;
        const float4 g0 = ld4(g_s + i), g1 = ld4(g_s + DH + i);
        st4(rin_p + (kSB + t) * RS + i,
            mul4(ld4(rin_p + (kSB + t) * RS + i), g0));
        st4(ks_p + t * RS + i, mul4(ld4(kf_p + t * RS + i), g1));
        if (t == 0) st4(e_p + i, mul4(g0, g1));
      }
      {
        const int t = tid / kLPT, g = tid % kLPT, pos = t % kSB;
        const int pos_max = (t | (32 / kLPT - 1)) % kSB;  // the warp's last
        float acc[kSB];
#pragma unroll
        for (int d = 0; d < kSB; ++d) acc[d] = 0.f;
#pragma unroll
        for (int q = 0; q < DH / (4 * kLPT); ++q) {
          const int i = (q * kLPT + g) * 4;
          float4 x = ld4(r_p + t * RS + i);
          acc[0] = dot4(mul4(x, ld4(u_s + i)), ld4(k_p + t * RS + i), acc[0]);
#pragma unroll
          for (int d = 1; d < kSB; ++d) {
            if (d > pos_max) break;
            if (d <= pos) {
              const int j = t - d;
              acc[d] = dot4(x, ld4(k_p + j * RS + i), acc[d]);
              x = mul4(x, ld4(w_s + j * RS + i));
            }
          }
        }
        const float score = reduce_scatter8(acc, g);
        if (g <= pos) a_p[t * AS + t - g] = score;
      }
      // the off-diagonal sub-block A[8 + a][b] = Q[8 + a] . Kf[b], two
      // lanes a score
      {
        const int o = tid >> 1, half = tid & 1;
        const int t = o / kSB, j = o % kSB;
        float acc = 0.f;
#pragma unroll
        for (int q = half; q < KQ; q += 2)
          acc = dot4(ld4(q_s + t * RS + 4 * q), ld4(kf_p + j * RS + 4 * q),
                     acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (!half) a_p[(kSB + t) * AS + j] = acc;
      }
      // 3. the next chunk's v, into the copy chunk c - 1 used, once the
      //    product warps are done with it (so that all of this chunk's
      //    score work overlaps their chunk c - 1); then chunk c, its v
      //    landed, is handed over (committed since v of c: r/k/log_w and
      //    v of c + 1)
      if (c >= 1) bar_sync(kBarFree, kThreads);
      stage_v(c + 1);
      cp_async_wait<2>();
      __threadfence_block();
      bar_arrive(kBarReady, kThreads);
    }
  } else {
    // --- the product warps: y = A v + Rin S for the chunk's tokens and
    //     the tile's columns, and the tile's next state ---
    const int ptid = tid - kGroup;
    // warps 4-5: y, YR tokens x 4 columns a thread; warps 6-7: the next S,
    // SR keys x 4 columns a thread
    constexpr int kHalf = kProd / 2;
    constexpr int YR = kCH * CG / kHalf, SR = DH * CG / kHalf;
    // the state tile, while the score warps start on chunk 0
    const float* s_in = a.s0 + member * a.s0_k + slot * a.s0_b + hs;
    for (int e = ptid; e < DH * CG; e += kProd) {
      const int i = e / CG, j = (e % CG) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < dh) {
        const float* at = s_in + static_cast<long long>(i) * dh + col0 + j;
        if constexpr (V4) {
          if (col0 + j < dh) x = *reinterpret_cast<const float4*>(at);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col0 + j + q < dh) set4(x, q, at[q]);
        }
      }
      st4(s_s + i * VS + j, x);
    }
    bar_sync(kBarProd, kProd);
    if (ptid < kHalf) {
      const int j = (ptid % CG) * 4, t0 = (ptid / CG) * YR;
      for (int c = 0; c < n_chunks; ++c) {
        const int p = c & 1;
        const float* a_p = a_s + p * kCH * AS;
        const float* rin_p = rin_s + p * L::TOK;
        const float* v_c = v_s + p * kCH * VS;
        const float* s_c = s_s + p * DH * VS;
        bar_sync(kBarReady, kThreads);  // chunk c's operands
        float4 acc[YR];
#pragma unroll
        for (int rr = 0; rr < YR; ++rr)
          acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int kq_end = (t0 + YR + 3) / 4;  // A is lower triangular
#pragma unroll
        for (int kq = 0; kq < kCH / 4; ++kq) {
          if (kq >= kq_end) break;
          float4 a4[YR];
#pragma unroll
          for (int rr = 0; rr < YR; ++rr)
            a4[rr] = ld4(a_p + (t0 + rr) * AS + 4 * kq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 vv = ld4(v_c + (4 * kq + e) * VS + j);
#pragma unroll
            for (int rr = 0; rr < YR; ++rr)
              acc[rr] = fma4(comp(a4[rr], e), vv, acc[rr]);
          }
        }
#pragma unroll 2
        for (int kq = 0; kq < KQ; ++kq) {
          float4 a4[YR];
#pragma unroll
          for (int rr = 0; rr < YR; ++rr)
            a4[rr] = ld4(rin_p + (t0 + rr) * RS + 4 * kq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 ss = ld4(s_c + (4 * kq + e) * VS + j);
#pragma unroll
            for (int rr = 0; rr < YR; ++rr)
              acc[rr] = fma4(comp(a4[rr], e), ss, acc[rr]);
          }
        }
        const int col = col0 + j;
#pragma unroll
        for (int rr = 0; rr < YR; ++rr) {
          const int t = c * kCH + t0 + rr;
          if (t >= T) continue;
          float* out = a.y + head + t * tok + col;
          if constexpr (V4) {
            if (col < dh) st4(out, acc[rr]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < dh) out[e] = comp(acc[rr], e);
          }
        }
        // this chunk's operands are consumed (the last chunk's need no
        // signal: no copy waits on them); the next state is complete
        // before the next chunk reads it
        if (c + 1 < n_chunks) bar_arrive(kBarFree, kThreads);
        bar_sync(kBarProd, kProd);
      }
    } else {
      // the state tile lives in registers from chunk to chunk; shared
      // memory gets a copy for y
      const int j = ((ptid - kHalf) % CG) * 4;
      const int i0 = ((ptid - kHalf) / CG) * SR;
      float4 acc[SR];
#pragma unroll
      for (int rr = 0; rr < SR; ++rr) acc[rr] = ld4(s_s + (i0 + rr) * VS + j);
      for (int c = 0; c < n_chunks; ++c) {
        const int p = c & 1;
        const float* kf_p = kf_s + p * L::TOK;
        const float* ks_p = ks_s + p * kSB * RS;
        const float* e_p = e_s + p * DH;
        const float* v_c = v_s + p * kCH * VS;
        float* s_n = s_s + (p ^ 1) * DH * VS;
        bar_sync(kBarReady, kThreads);  // chunk c's operands
        // S E + Ks[0:8]^T v[0:8] + Kf[8:16]^T v[8:16]
#pragma unroll
        for (int rr = 0; rr < SR; ++rr) acc[rr] = scale4(acc[rr], e_p[i0 + rr]);
#pragma unroll 2
        for (int t = 0; t < kCH; ++t) {
          const float* kt = t < kSB ? ks_p + t * RS : kf_p + t * RS;
          const float4 vv = ld4(v_c + t * VS + j);
          if constexpr (SR % 4 == 0) {
#pragma unroll
            for (int q = 0; q < SR / 4; ++q) {
              const float4 kf = ld4(kt + i0 + 4 * q);
              acc[4 * q] = fma4(kf.x, vv, acc[4 * q]);
              acc[4 * q + 1] = fma4(kf.y, vv, acc[4 * q + 1]);
              acc[4 * q + 2] = fma4(kf.z, vv, acc[4 * q + 2]);
              acc[4 * q + 3] = fma4(kf.w, vv, acc[4 * q + 3]);
            }
          } else {
#pragma unroll
            for (int rr = 0; rr < SR; ++rr)
              acc[rr] = fma4(kt[i0 + rr], vv, acc[rr]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < SR; ++rr) st4(s_n + (i0 + rr) * VS + j, acc[rr]);
        if (c + 1 < n_chunks) bar_arrive(kBarFree, kThreads);
        bar_sync(kBarProd, kProd);
      }
    }
    const float* s_f = s_s + (n_chunks & 1) * DH * VS;
    float* s_out = a.sT + member * a.sT_k + slot * a.sT_b + hs;
    for (int e = ptid; e < DH * CG; e += kProd) {
      const int i = e / CG, j = (e % CG) * 4;
      if (i >= dh) continue;
      const float4 x = ld4(s_f + i * VS + j);
      float* at = s_out + static_cast<long long>(i) * dh + col0 + j;
      if constexpr (V4) {
        if (col0 + j < dh) *reinterpret_cast<float4*>(at) = x;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col0 + j + q < dh) at[q] = comp(x, q);
      }
    }
  }
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float zero() { return 0.f; }
  __device__ static float get(float x, int) { return x; }
  __device__ static void set(float& x, int, float s) { x = s; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float get(float4 x, int e) { return comp(x, e); }
  __device__ static void set(float4& x, int e, float s) { set4(x, e, s); }
};

// The T = 1 step: one block per (row, head); thread (rg, cg) holds columns
// cg*V .. cg*V + V - 1 of key rows rg, rg + RG, ...
template <int DH, int V>
__global__ void __launch_bounds__(kStepThreads) wkv6_step_kernel(Args a) {
  using V_ = Vec<V>;
  using vec = typename V_::T;
  constexpr int CG = DH / V, RG = kStepThreads / CG, RPT = DH / RG;
  static_assert(RG * RPT == DH, "rows split evenly");
  __shared__ float r_s[DH], k_s[DH], w_s[DH], uk_s[DH];
  __shared__ __align__(16) float red_s[RG][DH];
  const int tid = threadIdx.x;
  const int n = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int member = n / a.B, slot = n % a.B, dh = a.dh;
  const long long at = (static_cast<long long>(n) * a.H + h) * dh;
  const long long hs = static_cast<long long>(h) * dh * dh;
  const float* s_in = a.s0 + member * a.s0_k + slot * a.s0_b + hs;
  float* s_out = a.sT + member * a.sT_k + slot * a.sT_b + hs;
  const int cg = tid % CG, rg = tid / CG, j = cg * V;
  const bool col_ok = j < dh;

  vec S[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = rg + RG * q;
    S[q] = (i < dh && col_ok)
               ? *reinterpret_cast<const vec*>(s_in + static_cast<long long>(i) * dh + j)
               : V_::zero();
  }
  const vec vj = col_ok ? *reinterpret_cast<const vec*>(a.v + at + j) : V_::zero();
  for (int i = tid; i < DH; i += kStepThreads) {
    const bool ok = i < dh;
    const float kv = ok ? a.k[at + i] : 0.f;
    r_s[i] = ok ? a.r[at + i] : 0.f;
    k_s[i] = kv;
    w_s[i] = ok ? __expf(a.lw[at + i]) : 1.f;
    uk_s[i] = ok ? a.u[(static_cast<long long>(member) * a.H + h) * dh + i] * kv
                 : 0.f;
  }
  __syncthreads();
  vec acc = V_::zero();
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = rg + RG * q;
    const float ri = r_s[i], ki = k_s[i], wi = w_s[i], uki = uk_s[i];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float s = V_::get(S[q], e), ve = V_::get(vj, e);
      V_::set(acc, e, fmaf(ri, fmaf(uki, ve, s), V_::get(acc, e)));
      V_::set(S[q], e, fmaf(s, wi, ki * ve));
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = rg + RG * q;
    if (i < dh && col_ok)
      *reinterpret_cast<vec*>(s_out + static_cast<long long>(i) * dh + j) = S[q];
  }
  *reinterpret_cast<vec*>(&red_s[rg][j]) = acc;
  __syncthreads();
  for (int jj = tid; jj < dh; jj += kStepThreads) {
    float sum = 0.f;
#pragma unroll 8
    for (int g = 0; g < RG; ++g) sum += red_s[g][jj];
    a.y[at + jj] = sum;
  }
}

// plan: {path (0 = the T = 1 step, 1 = chunked), blocks, threads, chunk,
// column tile, dynamic shared bytes, 16-byte accesses}
constexpr int kPlanInts = 7;

template <int DH, int CT, bool V4>
cudaError_t launch_chunk(const Args& a, int* plan, cudaStream_t s) {
  using L = Layout<DH, CT>;
  auto kern = wkv6_chunk_kernel<DH, CT, V4>;
  const int n_tiles = (a.dh + CT - 1) / CT;
  const long long blocks = static_cast<long long>(a.K) * a.B * a.H * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (plan) {
    const int p[kPlanInts] = {1, static_cast<int>(blocks), kThreads, kCH, CT,
                              static_cast<int>(L::BYTES), V4 ? 1 : 0};
    for (int i = 0; i < kPlanInts; ++i) plan[i] = p[i];
  }
  if (L::BYTES > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::BYTES));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(blocks), kThreads, L::BYTES, s>>>(a, n_tiles);
  return cudaGetLastError();
}

template <int DH, int V>
cudaError_t launch_step(const Args& a, int* plan, cudaStream_t s) {
  const long long blocks = static_cast<long long>(a.K) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (plan) {
    const int p[kPlanInts] = {0, static_cast<int>(blocks), kStepThreads, 0, 0,
                              0, V == 4 ? 1 : 0};
    for (int i = 0; i < kPlanInts; ++i) plan[i] = p[i];
  }
  wkv6_step_kernel<DH, V><<<static_cast<unsigned>(blocks), kStepThreads, 0,
                            s>>>(a);
  return cudaGetLastError();
}

// The chunked path's value-column tile: the whole head at dh 33-64 on the
// 16-byte path (nothing repeated), 32 columns below or on the 4-byte path,
// 16 above dh 64 (a wider state tile is more registers than a thread has).
template <int DH, bool V4>
constexpr int col_tile() {
  return DH == 128 ? 16 : (DH == 64 && V4 ? 64 : 32);
}

template <int DH, bool V4>
cudaError_t launch_dh(const Args& a, int* plan, cudaStream_t s) {
  if (a.T == 1)
    return V4 ? launch_step<DH, 4>(a, plan, s) : launch_step<DH, 1>(a, plan, s);
  return launch_chunk<DH, col_tile<DH, V4>(), V4>(a, plan, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Strides are in floats.  dh must be in [1, 128].  Takes the 16-byte path
// when every pointer is 16-byte aligned and dh and the state's strides are
// multiples of 4.  `plan`, if not null, receives kPlanInts ints
// describing the launch.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* lw, const float* u, const float* s0,
                           float* sT, float* y, int K, int B, int T, int H,
                           int dh, long long s0_k, long long s0_b,
                           long long sT_k, long long sT_b, int* plan,
                           void* stream) {
  if (K <= 0 || B <= 0 || T < 0 || H <= 0 || dh < 1 || dh > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{r, k, v, lw, u, s0, sT, y, K, B, T, H, dh,
               s0_k, s0_b, sT_k, sT_b};
  const bool v4 = dh % 4 == 0 && s0_k % 4 == 0 && s0_b % 4 == 0 &&
                  sT_k % 4 == 0 && sT_b % 4 == 0 && aligned16(r) &&
                  aligned16(k) && aligned16(v) && aligned16(lw) &&
                  aligned16(u) && aligned16(s0) && aligned16(sT) &&
                  aligned16(y);
  cudaError_t e;
  if (dh <= 32)
    e = v4 ? launch_dh<32, true>(a, plan, s) : launch_dh<32, false>(a, plan, s);
  else if (dh <= 64)
    e = v4 ? launch_dh<64, true>(a, plan, s) : launch_dh<64, false>(a, plan, s);
  else
    e = v4 ? launch_dh<128, true>(a, plan, s)
           : launch_dh<128, false>(a, plan, s);
  return static_cast<int>(e);
}
