// Flash attention (tiled online softmax) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:93
// (`flash_attention` / `_attn_kernel`): q (N, T, H, dh) attends over k/v
// (N, S, Hkv, dh) with an online softmax, causal and sliding-window
// masks, and GQA by group-major row flattening (row r of a kv head's
// g*T query rows is head r / T at time r % T, so the g heads that share
// a kv head share every K/V tile).  Beyond the TPU kernel it takes
// per-row positions: q_pos (N, T) and k_pos (N, S), where a negative key
// position (the models' empty-slot sentinel) is never attended; that is
// what chunked prefill over a ring or gathered pages plus the chunk
// needs.  With no positions, query t sits at t and key s at s (the TPU
// kernel's top-left contract).  f32 and bf16 inputs; scores, the softmax
// state and the accumulator stay in f32.
//
// What bounds it: at the prefill chunk shapes, bytes (gemma3-1b's chunk
// moves ~5 MB, deepseek-7b's ~54 MB: 1.5 and 16 us at 3.35 TB/s); at
// the full forward (T = S = 2048), operations.  The first kernel
// multiplied on the CUDA cores in f32, visited every key tile, staged
// tiles as f32 (one block per SM at dh 256) and gave gemma3's Hkv = 1
// chunk 32 blocks: 4.7x slower than one scaled_dot_product_attention.
//
// Design:
//   - bf16 runs on the tensor cores: each warp of a 128-thread block owns
//     16 of the block's 64 query rows; Q K^T and P V are mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix (.trans for V)
//     from bf16 tiles whose rows are padded by 16 bytes, so ldmatrix is
//     free of bank conflicts.  K/V tiles are double-buffered with
//     cp.async (zero-filled past S).  The online softmax stays in
//     registers, reduced over the quad of lanes that share a row by
//     shuffles; P is rounded to bf16 in registers and reused as the A
//     operand of P V (the one numerical change from f32: ~2^-9 relative
//     per probability).  Key tiles are 64 keys, 32 at dh 256, where the
//     (16 x 256) f32 accumulator already takes 128 registers a thread.
//   - f32 keeps CUDA-core products (256 threads, each a 4 x 4 block of
//     scores and a 4 x dh/16 block of the accumulator), which hold the
//     f32 parity the JAX package's tests ask for.
//   - Both skip every key tile that no query of the block can see, by
//     one predicate (tile_live): a tile is read only if one of its keys
//     sits at a position >= 0 that is, under causality, at most the
//     block's largest query position and, under a window, above its
//     smallest minus the window.  The key positions are read before the
//     tile's K/V copies are issued, so a skipped tile costs no K/V bytes;
//     ring positions are not monotone, so the decision is per tile.
//   - When rows x kv heads x query tiles give fewer blocks than SMs
//     (gemma3-1b's chunk: 32), a block's key tiles are divided over
//     n_split blocks, each writing its partial (m, l, acc) in f32, and
//     the combine of attention_combine.cuh merges them.
//   - A query row with no valid key stays finite: scores of masked keys
//     are NEG_INF, keys past S get probability exactly 0, and a block
//     that reads no tile writes zeros; callers discard such rows.
// Still left: wgmma with TMA and warp specialisation for the full
// forward, where mma.sync's rate and the two-stage pipeline bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_combine.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the TPU kernel
constexpr int kBQ = 64;                    // query rows per block
constexpr int kNoKey = INT32_MIN;          // position of a key past S

enum DType { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// shared by both paths: the block's query positions and the skip predicate
// ---------------------------------------------------------------------------

// (smallest, largest) query position of the block's rows [r0, r0 + kBQ)
// that exist.  Every thread calls it.
__device__ __forceinline__ int2 block_qrange(const int* __restrict__ qpos_n,
                                             int r0, int rows, int T,
                                             int tid, int* sh) {
  if (tid == 0) {
    sh[0] = INT32_MAX;
    sh[1] = INT32_MIN;
  }
  __syncthreads();
  if (tid < kBQ && r0 + tid < rows) {
    const int t = (r0 + tid) % T;
    const int p = qpos_n != nullptr ? qpos_n[t] : t;
    atomicMin(sh, p);
    atomicMax(sh + 1, p);
  }
  __syncthreads();
  return make_int2(sh[0], sh[1]);
}

// Whether any query of the block can see a key of the tile [j0, j0 +
// bk): the one skip predicate of both paths (its twin is
// kernels/ref.flash_tile_live).  Writes the tile's key positions to
// kp_out (kNoKey past S).  Every thread calls it; the result is the
// block's.  Needs blockDim.x >= bk.
__device__ __forceinline__ bool tile_live(const int* __restrict__ kpos_n,
                                          int j0, int bk, int S, int2 qr,
                                          int causal, int window,
                                          int* kp_out, int tid) {
  bool ok = false;
  if (tid < bk) {
    const int s = j0 + tid;
    const int kp = s >= S ? kNoKey : kpos_n != nullptr ? kpos_n[s] : s;
    kp_out[tid] = kp;
    ok = kp >= 0 && (!causal || kp <= qr.y) &&
         (window <= 0 ||
          static_cast<long long>(kp) > static_cast<long long>(qr.x) - window);
  }
  return __syncthreads_or(ok) != 0;
}

// The masked, scaled score of one (query, key) pair, as ref.attention.
__device__ __forceinline__ float masked(float s, int kp, int qp, int causal,
                                        int window) {
  if (kp == kNoKey) return -INFINITY;
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok ? s : kNegInf;
}

// Output row (in (N, T, H) order) of group-major row R of kv head h.
__device__ __forceinline__ long long out_row(int n, int R, int T, int H,
                                             int h, int g) {
  const int gi = R / T;
  const int t = R - gi * T;
  return (static_cast<long long>(n) * T + t) * H + h * g + gi;
}

// ---------------------------------------------------------------------------
// the f32 path: CUDA-core products
// ---------------------------------------------------------------------------

constexpr int kThreadsF = 256;
constexpr int kBKF = 64;  // keys per tile
constexpr int kRM = 4;    // query rows per thread
constexpr int kCM = 4;    // keys per thread
constexpr int kKPad = 4;  // floats of padding after each staged K row
constexpr int kPPad = 4;  // ... after each probability row

// Stages 64 rows of DH f32 into shared memory (row stride `ld` floats).
// row_ptr(r) is the row's first element, or null for a row past the end
// (stored as zeros).  Every thread issues its loads of a group before it
// stores any of them.
template <int DH, typename RowPtr>
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, int tid,
                                               RowPtr row_ptr) {
  constexpr int kChunks = DH / 4;                 // 16-byte chunks per row
  constexpr int kPer = 64 * kChunks / kThreadsF;  // chunks per thread
  constexpr int kGroup = kPer < 8 ? kPer : 8;
  static_assert(kPer * kThreadsF == 64 * kChunks, "tile / thread mismatch");
#pragma unroll
  for (int g0 = 0; g0 < kPer; g0 += kGroup) {
    float4 buf[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = tid + (g0 + u) * kThreadsF;
      const int r = i / kChunks;
      const float* src = row_ptr(r);
      buf[u] = src != nullptr
                   ? *reinterpret_cast<const float4*>(src + (i - r * kChunks) * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = tid + (g0 + u) * kThreadsF;
      const int r = i / kChunks;
      *reinterpret_cast<float4*>(dst + r * ld + (i - r * kChunks) * 4) = buf[u];
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q (N, T, H, DH); k/v (N, S, Hkv, DH); q_pos (N, T) / k_pos (N, S) or
// null; out (N, T, H, DH); part as attention_combine.cuh when n_split >
// 1.  Grid: N * Hkv * ceil(g*T / 64) * n_split blocks, split fastest.
template <int DH>
__global__ void __launch_bounds__(kThreadsF, 1) flash_kernel_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, float* __restrict__ out,
    float* __restrict__ part, int T_, int S, int H, int Hkv, int causal,
    int window, float scale, int n_split) {
  constexpr int VW = DH >= 64 ? 4 : 2;   // output columns per chunk
  constexpr int NC = DH / (16 * VW);     // chunks per thread
  constexpr int KLD = DH + kKPad;
  constexpr int PLD = kBKF + kPPad;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (kBQ, DH)
  float* k_s = q_s + kBQ * DH;                    // (kBKF, KLD)
  float* v_s = k_s + kBKF * KLD;                  // (kBKF, DH)
  float* p_s = v_s + kBKF * DH;                   // (kBQ, PLD)
  int* kp_s = reinterpret_cast<int*>(p_s + kBQ * PLD);  // (kBKF,)
  int* qr_s = kp_s + kBKF;                              // (2,)

  const int g = H / Hkv;
  const int rows = g * T_;
  const int n_tiles = (rows + kBQ - 1) / kBQ;
  const int split = blockIdx.x % n_split;
  const int rest = blockIdx.x / n_split;
  const int tile = rest % n_tiles;
  const int nh = rest / n_tiles;
  const int n = nh / Hkv;
  const int h = nh - n * Hkv;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = tile * kBQ;
  const int* qpos_n = q_pos != nullptr ? q_pos + static_cast<long long>(n) * T_
                                       : nullptr;
  const int* kpos_n = k_pos != nullptr ? k_pos + static_cast<long long>(n) * S
                                       : nullptr;

  // the query tile: row r is head h*g + (r0+r) / T at time (r0+r) % T
  stage_rows_f32<DH>(q_s, DH, tid, [=](int r) -> const float* {
    const int R = r0 + r;
    if (R >= rows) return nullptr;
    return q + out_row(n, R, T_, H, h, g) * DH;
  });
  const int2 qr = block_qrange(qpos_n, r0, rows, T_, tid, qr_s);

  int qp[kRM];
  bool q_ok[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int R = r0 + ty * kRM + i;
    q_ok[i] = R < rows;
    const int t = q_ok[i] ? R % T_ : 0;
    qp[i] = qpos_n != nullptr ? qpos_n[t] : t;
  }
  float m[kRM], l[kRM], acc[kRM][NC * VW];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * VW; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (S + kBKF - 1) / kBKF;
  const int kt_hi = (split + 1) * n_kt / n_split;
  for (int jt = split * n_kt / n_split; jt < kt_hi; ++jt) {
    const int j0 = jt * kBKF;
    __syncthreads();  // the previous tile's value product is done
    if (!tile_live(kpos_n, j0, kBKF, S, qr, causal, window, kp_s, tid))
      continue;
    auto kv_row = [=](const float* base) {
      return [=](int r) -> const float* {
        const int s = j0 + r;
        if (s >= S) return nullptr;
        return base + ((static_cast<long long>(n) * S + s) * Hkv + h) * DH;
      };
    };
    stage_rows_f32<DH>(k_s, KLD, tid, kv_row(k));
    stage_rows_f32<DH>(v_s, DH, tid, kv_row(v));
    __syncthreads();

    // scores of this thread's 4 rows x 4 keys
    float sc[kRM][kCM];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCM; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[kRM], kv[kCM];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * kRM + i) * DH + d);
#pragma unroll
      for (int j = 0; j < kCM; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * KLD + d);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCM; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCM; ++j) {
        sc[i][j] = masked(sc[i][j] * scale, kp_s[tx + 16 * j], qp[i], causal,
                          window);
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCM; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        p_s[(ty * kRM + i) * PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * VW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p @ v over the tile's keys
#pragma unroll 2
    for (int c = 0; c < kBKF; c += 4) {
      float4 pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * kRM + i) * PLD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_s + (c + e) * DH;
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          float vv[VW];
          if constexpr (VW == 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(vr + (tx + 16 * jj) * VW);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x =
                *reinterpret_cast<const float2*>(vr + (tx + 16 * jj) * VW);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int x = 0; x < VW; ++x)
              acc[i][jj * VW + x] = fmaf(p, vv[x], acc[i][jj * VW + x]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    if (!q_ok[i]) continue;
    const long long orow = out_row(n, r0 + ty * kRM + i, T_, H, h, g);
    if (n_split == 1) {
      float* o = out + orow * DH;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
#pragma unroll
        for (int x = 0; x < VW; ++x)
          o[(tx + 16 * jj) * VW + x] = acc[i][jj * VW + x] * inv;
    } else {
      float* pp = part + (orow * n_split + split) * (DH + 2);
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
#pragma unroll
        for (int x = 0; x < VW; ++x)
          pp[(tx + 16 * jj) * VW + x] = acc[i][jj * VW + x];
      if (tx == 0) {
        pp[DH] = m[i];
        pp[DH + 1] = l[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 path: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kThreadsB = 128;  // 4 warps x 16 query rows

__host__ __device__ constexpr int key_tile_bf16(int dh) {
  return dh >= 256 ? 32 : 64;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DH>
constexpr long long smem_bf16() {
  constexpr int BK = key_tile_bf16(DH);
  return static_cast<long long>(kBQ + 4 * BK) * (DH + 8) * 2 +
         (2 * BK + 2) * 4;
}

// The same contract and grid as flash_kernel_f32, for bf16.  Thread
// `lane` of warp w holds query rows w*16 + lane/4 ("lo") and + 8 ("hi")
// in the mma fragment layouts.
template <int DH>
__global__ void __launch_bounds__(kThreadsB) flash_kernel_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int T_, int S, int H, int Hkv, int causal,
    int window, float scale, int n_split) {
  constexpr int BK = key_tile_bf16(DH);
  constexpr int LD = DH + 8;   // staged row: DH values + 16 bytes of pad
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  constexpr int NT = BK / 8;   // score fragments (8 keys each)
  constexpr int NO = DH / 8;   // output fragments (8 columns each)
  extern __shared__ __align__(16) char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (kBQ, LD)
  __nv_bfloat16* k_s = q_s + kBQ * LD;                          // (2, BK, LD)
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;                       // (2, BK, LD)
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * BK * LD);        // (2, BK)
  int* qr_s = kp_s + 2 * BK;                                    // (2,)

  const int g = H / Hkv;
  const int rows = g * T_;
  const int n_tiles = (rows + kBQ - 1) / kBQ;
  const int split = blockIdx.x % n_split;
  const int rest = blockIdx.x / n_split;
  const int tile = rest % n_tiles;
  const int nh = rest / n_tiles;
  const int n = nh / Hkv;
  const int h = nh - n * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = tile * kBQ;
  const int* qpos_n = q_pos != nullptr ? q_pos + static_cast<long long>(n) * T_
                                       : nullptr;
  const int* kpos_n = k_pos != nullptr ? k_pos + static_cast<long long>(n) * S
                                       : nullptr;

  for (int i = tid; i < kBQ * CH; i += kThreadsB) {
    const int r = i / CH;
    const int c = i - r * CH;
    const int R = r0 + r;
    const __nv_bfloat16* src =
        R < rows ? q + out_row(n, R, T_, H, h, g) * DH + c * 8 : q;
    cp_async16(q_s + r * LD + c * 8, src, R < rows ? 16 : 0);
  }
  cp_async_commit();
  const int2 qr = block_qrange(qpos_n, r0, rows, T_, tid, qr_s);

  int qp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int R = r0 + warp * 16 + (lane >> 2) + hf * 8;
    const int t = R < rows ? R % T_ : 0;
    qp[hf] = qpos_n != nullptr ? qpos_n[t] : t;
  }

  const int n_kt = (S + BK - 1) / BK;
  const int kt_hi = (split + 1) * n_kt / n_split;
  auto next_live = [&](int jt, int buf) {
    while (jt < kt_hi && !tile_live(kpos_n, jt * BK, BK, S, qr, causal,
                                    window, kp_s + buf * BK, tid))
      ++jt;
    return jt;
  };
  auto stage_kv = [&](int jt, int buf) {
    for (int i = tid; i < BK * CH; i += kThreadsB) {
      const int r = i / CH;
      const int c = i - r * CH;
      const int s = jt * BK + r;
      const long long off =
          s < S ? ((static_cast<long long>(n) * S + s) * Hkv + h) * DH + c * 8
                : 0;
      const int bytes = s < S ? 16 : 0;
      cp_async16(k_s + (buf * BK + r) * LD + c * 8, k + off, bytes);
      cp_async16(v_s + (buf * BK + r) * LD + c * 8, v + off, bytes);
    }
  };

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int buf = 0;
  int jt = next_live(split * n_kt / n_split, 0);
  if (jt < kt_hi) stage_kv(jt, 0);
  cp_async_commit();
  while (jt < kt_hi) {
    const int jn = next_live(jt + 1, buf ^ 1);
    if (jn < kt_hi) {  // the next live tile's copies go out first
      stage_kv(jn, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kb = k_s + buf * BK * LD;
    const __nv_bfloat16* vb = v_s + buf * BK * LD;
    const int* kpb = kp_s + buf * BK;

    // S = Q K^T for the warp's 16 rows x BK keys
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, kb + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * j], a, b[0], b[1]);
        mma_bf16(sc[2 * j + 1], a, b[2], b[3]);
      }
    }

    // mask and the online softmax, rows lo (c 0-1) and hi (c 2-3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = kpb[j * 8 + 2 * (lane & 3) + (c & 1)];
        sc[j][c] = masked(sc[j][c] * scale, kp, qp[c >> 1], causal, window);
        mx[c >> 1] = fmaxf(mx[c >> 1], sc[j][c]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
      alpha[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[j][c] = expf(sc[j][c] - m[c >> 1]);
        sum[c >> 1] += sc[j][c];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + quad_sum(sum[hf]);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * t][0], sc[2 * t][1]),
                              pack_bf16(sc[2 * t][2], sc[2 * t][3]),
                              pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]),
                              pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3])};
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             j * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * j], pa, b[0], b[1]);
        mma_bf16(o[2 * j + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled two live tiles on
    jt = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int R = r0 + warp * 16 + (lane >> 2) + hf * 8;
    if (R >= rows) continue;
    const long long orow = out_row(n, R, T_, H, h, g);
    const int col = 2 * (lane & 3);
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l[hf], 1e-30f);
      __nv_bfloat16* op = out + orow * DH + col;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + j * 8) = __floats2bfloat162_rn(
            o[j][2 * hf] * inv, o[j][2 * hf + 1] * inv);
    } else {
      float* pp = part + (orow * n_split + split) * (DH + 2);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        pp[j * 8 + col] = o[j][2 * hf];
        pp[j * 8 + col + 1] = o[j][2 * hf + 1];
      }
      if ((lane & 3) == 0) {
        pp[DH] = m[hf];
        pp[DH + 1] = l[hf];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(attn::kCombineThreads)
    flash_kernel_combine(const float* __restrict__ part, T* __restrict__ out,
                         int n_split, int dv) {
  attn::combine_row<T>(part, out, n_split, dv);
}

long long smem_f32(int dh) {
  return (static_cast<long long>(kBQ) * dh +
          static_cast<long long>(kBKF) * (dh + kKPad) +
          static_cast<long long>(kBKF) * dh +
          static_cast<long long>(kBQ) * (kBKF + kPPad)) * 4 +
         (kBKF + 2) * 4;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;
  float* part;
  int N, T, S, H, Hkv, causal, window, n_split;
  float scale;
};

template <int DH>
cudaError_t launch_dh(int dtype, const Args& a, cudaStream_t s) {
  const long long rows = static_cast<long long>(a.H / a.Hkv) * a.T;
  const long long blocks = static_cast<long long>(a.N) * a.Hkv *
                           ((rows + kBQ - 1) / kBQ) * a.n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long smem = dtype == kF32 ? smem_f32(DH) : smem_bf16<DH>();
  if (dtype == kF32) {
    auto kern = flash_kernel_f32<DH>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<static_cast<unsigned>(blocks), kThreadsF, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.q_pos, a.k_pos,
        static_cast<float*>(a.out), a.part, a.T, a.S, a.H, a.Hkv, a.causal,
        a.window, a.scale, a.n_split);
  } else {
    auto kern = flash_kernel_bf16<DH>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kern<<<static_cast<unsigned>(blocks), kThreadsB, smem, s>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), a.q_pos, a.k_pos,
        static_cast<__nv_bfloat16*>(a.out), a.part, a.T, a.S, a.H, a.Hkv,
        a.causal, a.window, a.scale, a.n_split);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  const long long out_rows = static_cast<long long>(a.N) * a.T * a.H;
  if (out_rows > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (dtype == kF32) {
    flash_kernel_combine<float><<<static_cast<unsigned>(out_rows),
                                  attn::kCombineThreads,
                                  a.n_split * sizeof(float), s>>>(
        a.part, static_cast<float*>(a.out), a.n_split, DH);
  } else {
    flash_kernel_combine<__nv_bfloat16><<<static_cast<unsigned>(out_rows),
                                          attn::kCombineThreads,
                                          a.n_split * sizeof(float), s>>>(
        a.part, static_cast<__nv_bfloat16*>(a.out), a.n_split, DH);
  }
  return cudaGetLastError();
}

}  // namespace

// Keys per tile of the kernel for this head width and dtype (the query
// tile is always 64 group-major rows).
extern "C" int flash_attention_key_tile(int dh, int dtype) {
  return dtype == kF32 ? kBKF : key_tile_bf16(dh);
}

// Launches on `stream` (the kernel, then the combine when n_split > 1;
// `part` holds N * T * H * n_split * (dh + 2) floats then); returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_pos,
                                      const int* k_pos, void* out,
                                      float* part, int N, int T, int S,
                                      int H, int Hkv, int dh, int causal,
                                      int window, int n_split, float scale,
                                      int dtype, void* stream) {
  if (n_split < 1 || n_split > attn::kCombineMaxSplit ||
      (n_split > 1 && part == nullptr) ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, q_pos, k_pos, out, part, N, T, S, H, Hkv, causal,
               window, n_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dh) {
    case 32: e = launch_dh<32>(dtype, a, s); break;
    case 64: e = launch_dh<64>(dtype, a, s); break;
    case 128: e = launch_dh<128>(dtype, a, s); break;
    case 256: e = launch_dh<256>(dtype, a, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
