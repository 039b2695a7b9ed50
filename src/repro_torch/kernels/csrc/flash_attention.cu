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
// kernel's top-left contract).  f32 and bf16 inputs; scores,
// probabilities and the accumulator stay in f32, as on the TPU.
//
// Fully masked query rows (a padded chunk row of a slot with no valid
// key): every score is NEG_INF, so the online softmax weighs all S keys
// alike and the row gets the plain average of the S values, finite, as
// the plain version (kernels/ref.attention) gives.  Keys past S (the
// ragged last tile) get probability exactly 0.
//
// What bounds it: at the prefill shapes, bytes.  One call reads q, k, v
// once and writes the output once: gemma3-1b's chunk (N 4, T 128, H 4,
// Hkv 1, dh 256, S 704, bf16) moves ~5 MB (1.5 us at 3.35 TB/s) for
// ~0.7 GFLOP of unmasked score and value products (0.7 us at 989
// TFLOP/s); deepseek-7b's (H = Hkv = 32, dh 128) ~54 MB (16 us) for ~2.7
// GFLOP (2.7 us).  This first kernel is far from that: it multiplies on
// the CUDA cores in f32 (the tensor cores would round p to bf16), walks
// every key tile including the causally masked ones, and with gemma3's
// Hkv = 1 a chunk gives only N * g*T / 64 = 32 blocks for 132 SMs.
//
// Design (simple and right first):
//   - one block of 256 threads per (row n, kv head h, tile of 64 of the
//     g*T group-major query rows); the block loops over the S keys in
//     tiles of 64 (the TPU kernel's sequential kv grid axis);
//   - the query tile and each K/V tile are staged in shared memory as
//     f32, loaded as 16-byte vectors (rows are dh contiguous elements);
//     K rows are padded by 4 floats so the score loop's vector reads hit
//     distinct banks; the positions of the tile's keys are staged too;
//   - each thread owns a 4 x 4 block of scores (rows ty*4 + i, keys
//     tx + 16*j) and a 4 x dh/16 block of the output accumulator in
//     registers; row max and row sum reduce over the 16 lanes that share
//     a row by shuffles; probabilities pass through shared memory to the
//     value product;
//   - (m, l) start at (NEG_INF, 0) and the output is acc / max(l, 1e-30),
//     as in the TPU kernel.
// Tensor-core products (wgmma), TMA and skipping masked tiles are the
// next steps for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the TPU kernel
constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kRM = 4;    // query rows per thread
constexpr int kCM = 4;    // keys per thread
constexpr int kKPad = 4;  // floats of padding after each staged K row
constexpr int kPPad = 4;  // ... after each probability row
constexpr int kNoKey = INT32_MIN;  // position of a key past S

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T, converted to f32 and stored at dst (16-byte aligned).
__device__ __forceinline__ void store16(const uint4& u, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&u);
}
__device__ __forceinline__ void store16(const uint4& u, float* dst,
                                        __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a0 = __bfloat1622float2(b[0]);
  const float2 a1 = __bfloat1622float2(b[1]);
  const float2 a2 = __bfloat1622float2(b[2]);
  const float2 a3 = __bfloat1622float2(b[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a0.x, a0.y, a1.x, a1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a2.x, a2.y, a3.x, a3.y);
}

// Stages 64 rows of DH elements into shared memory as f32 (row stride
// `ld` floats).  row_ptr(r) is the row's first element, or null for a
// row past the end (stored as zeros).  Every thread issues its loads of
// a group before it converts and stores any of them.
template <typename T, int DH, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int tid,
                                           RowPtr row_ptr) {
  constexpr int E = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int kChunks = DH / E;              // 16-byte chunks per row
  constexpr int kPer = 64 * kChunks / kThreads;  // chunks per thread
  constexpr int kGroup = kPer < 8 ? kPer : 8;
  static_assert(kPer * kThreads == 64 * kChunks, "tile / thread mismatch");
#pragma unroll
  for (int g0 = 0; g0 < kPer; g0 += kGroup) {
    uint4 buf[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = tid + (g0 + u) * kThreads;
      const int r = i / kChunks;
      const T* src = row_ptr(r);
      buf[u] = src != nullptr
                   ? *reinterpret_cast<const uint4*>(src + (i - r * kChunks) * E)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = tid + (g0 + u) * kThreads;
      const int r = i / kChunks;
      store16(buf[u], dst + r * ld + (i - r * kChunks) * E, T());
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
// null; out (N, T, H, DH).  Grid: N * Hkv * ceil(g*T / 64) blocks.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, T* __restrict__ out, int T_, int S,
    int H, int Hkv, int causal, int window, float scale) {
  constexpr int VW = DH >= 64 ? 4 : 2;   // output columns per chunk
  constexpr int NC = DH / (16 * VW);     // chunks per thread
  constexpr int KLD = DH + kKPad;
  constexpr int PLD = kBK + kPPad;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (kBQ, DH)
  float* k_s = q_s + kBQ * DH;                    // (kBK, KLD)
  float* v_s = k_s + kBK * KLD;                   // (kBK, DH)
  float* p_s = v_s + kBK * DH;                    // (kBQ, PLD)
  int* kp_s = reinterpret_cast<int*>(p_s + kBQ * PLD);  // (kBK,)

  const int g = H / Hkv;
  const int rows = g * T_;
  const int n_tiles = (rows + kBQ - 1) / kBQ;
  const int tile = blockIdx.x % n_tiles;
  const int nh = blockIdx.x / n_tiles;
  const int n = nh / Hkv;
  const int h = nh - n * Hkv;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = tile * kBQ;

  // the query tile: row r is head h*g + (r0+r) / T at time (r0+r) % T
  stage_rows<T, DH>(q_s, DH, tid, [=](int r) -> const T* {
    const int R = r0 + r;
    if (R >= rows) return nullptr;
    const int gi = R / T_;
    const int t = R - gi * T_;
    return q + ((static_cast<long long>(n) * T_ + t) * H + h * g + gi) * DH;
  });

  int qp[kRM];
  bool q_ok[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int R = r0 + ty * kRM + i;
    q_ok[i] = R < rows;
    const int t = q_ok[i] ? R % T_ : 0;
    qp[i] = q_pos != nullptr ? q_pos[static_cast<long long>(n) * T_ + t] : t;
  }
  float m[kRM], l[kRM], acc[kRM][NC * VW];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * VW; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < S; j0 += kBK) {
    __syncthreads();  // the previous tile's value product is done
    auto kv_row = [=](const T* base) {
      return [=](int r) -> const T* {
        const int s = j0 + r;
        if (s >= S) return nullptr;
        return base + ((static_cast<long long>(n) * S + s) * Hkv + h) * DH;
      };
    };
    stage_rows<T, DH>(k_s, KLD, tid, kv_row(k));
    stage_rows<T, DH>(v_s, DH, tid, kv_row(v));
    if (tid < kBK) {
      const int s = j0 + tid;
      kp_s[tid] = s >= S ? kNoKey
                  : k_pos != nullptr ? k_pos[static_cast<long long>(n) * S + s]
                                     : s;
    }
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
        const int kp = kp_s[tx + 16 * j];
        float s = sc[i][j] * scale;
        if (kp == kNoKey) {
          s = -INFINITY;
        } else {
          bool ok = kp >= 0;
          if (causal) ok = ok && kp <= qp[i];
          if (window > 0) ok = ok && kp > qp[i] - window;
          if (!ok) s = kNegInf;
        }
        sc[i][j] = s;
        mx = fmaxf(mx, s);
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
    for (int c = 0; c < kBK; c += 4) {
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
    const int R = r0 + ty * kRM + i;
    const int gi = R / T_;
    const int t = R - gi * T_;
    T* o = out + ((static_cast<long long>(n) * T_ + t) * H + h * g + gi) * DH;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
#pragma unroll
      for (int x = 0; x < VW; ++x)
        o[(tx + 16 * jj) * VW + x] = from_f<T>(acc[i][jj * VW + x] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* k_pos, void* out, int N,
                   int T_, int S, int H, int Hkv, int causal, int window,
                   float scale, size_t smem, cudaStream_t stream) {
  auto kern = flash_kernel<T, DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long rows = static_cast<long long>(H / Hkv) * T_;
  const long long blocks =
      static_cast<long long>(N) * Hkv * ((rows + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), T_, S, H,
      Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, void* out, int N,
                      int T_, int S, int H, int Hkv, int causal, int window,
                      float scale, size_t smem, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, k_pos, out, N, T_, S, H, Hkv,
                           causal, window, scale, smem, s);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, k_pos, out, N, T_, S, H, Hkv,
                           causal, window, scale, smem, s);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, k_pos, out, N, T_, S, H, Hkv,
                            causal, window, scale, smem, s);
    case 256:
      return launch<T, 256>(q, k, v, q_pos, k_pos, out, N, T_, S, H, Hkv,
                            causal, window, scale, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory the kernel needs at head width dh (bytes).
extern "C" long long flash_attention_smem(int dh) {
  const long long floats = static_cast<long long>(kBQ) * dh +
                           static_cast<long long>(kBK) * (dh + kKPad) +
                           static_cast<long long>(kBK) * dh +
                           static_cast<long long>(kBQ) * (kBK + kPPad);
  return floats * static_cast<long long>(sizeof(float)) +
         kBK * static_cast<long long>(sizeof(int));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* q_pos,
                                      const int* k_pos, void* out, int N,
                                      int T, int S, int H, int Hkv, int dh,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  const size_t smem = static_cast<size_t>(flash_attention_smem(dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kF32) {
    e = launch_dh<float>(dh, q, k, v, q_pos, k_pos, out, N, T, S, H, Hkv,
                         causal, window, scale, smem, s);
  } else if (dtype == kBF16) {
    e = launch_dh<__nv_bfloat16>(dh, q, k, v, q_pos, k_pos, out, N, T, S, H,
                                 Hkv, causal, window, scale, smem, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
