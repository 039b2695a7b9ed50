// Paged-attention decode for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention` / `_paged_kernel`): one query per slot attends over
// that slot's KV pages, found through a per-slot page table, with an
// online softmax.  Options carried over whole: sliding window, dk != dv,
// int8 / fp8 (e4m3) pages dequantized by per-token scales, and an
// unquantized `k_extra` key block whose dot adds to the score (absorbed
// MLA).  f32 and bf16 queries; f32 accumulation throughout.
//
// What bounds it: bytes.  A decode step reads every live page of every
// slot once (K and V, page x Hkv x (dk + dv) elements per page) and does
// about 2 x g x (dk + dv) flops per element read, far below the card's
// ~20 flop/byte f32 balance point, so the least time is live-page bytes
// over the 3.35 TB/s memory rate.
//
// Design (simple and right first):
//   - one block per (slot row, kv head); the block walks the row's live
//     pages [first, ceil(len/page)) in a loop, so pages past the length
//     (and pages wholly before a sliding window) are never read;
//   - each page's K and V rows are staged in shared memory as f32 (the
//     quantized variants dequantized on the way in) by all threads at
//     once, as 16-byte loads that are all issued before any is used, so
//     a page costs about one memory latency (rows whose byte width is
//     not a multiple of 16 take an element-wise path);
//   - the g query heads of the kv head share each staged page (GQA group
//     rows, as on the TPU); q, the (m, l) softmax state and the (g, dv)
//     accumulator sit in shared memory too;
//   - scores: one warp per (token, head) pair, lanes striding features;
//     values: threads stride the (head, feature) pairs;
//   - table entries >= n_pages (unallocated) are clamped to a real page
//     and masked by position, like the TPU kernel's index map.
// With gemma3's Hkv = 1 the grid is only (members x slots) blocks, so
// most of the 132 SMs idle at decode.  Splitting a row's pages across
// blocks and reducing (flash-decoding) is the next step for speed.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the TPU kernel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies n elements into shared memory, each thread keeping kUnroll
// independent loads in flight before it stores any of them: a page then
// costs about one memory latency, not one per element.
constexpr int kUnroll = 16;

template <typename Load, typename Store>
__device__ __forceinline__ void stage(int n, int tid, Load load, Store store) {
  for (int base = tid; base < n; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < n) store(i, v[u]);
    }
  }
}

// The fast staging path: a page's K and V rows as 16-byte chunks, every
// chunk of both planes loaded before any is converted and stored, so
// one page costs about one memory latency.  Needs rows whose byte width
// is a multiple of 16 on 16-byte aligned planes (the caller checks).
constexpr int kVec = 4;

template <typename KT>
__device__ __forceinline__ void stage_kv_vec(
    const KT* __restrict__ kp, const KT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, float* k_s,
    float* v_s, long long row0, int Hkv, int h, int dk, int dv, int dkq,
    int page, int tid) {
  constexpr int E = 16 / sizeof(KT);
  const int ck = dk / E, cv = dv / E;
  const int nk = page * ck, nv = page * cv;
  const int n = nk > nv ? nk : nv;
  for (int b0 = tid; b0 < n; b0 += kThreads * kVec) {
    uint4 kx[kVec], vx[kVec];
    float ksc[kVec], vsc[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = b0 + u * kThreads;
      if (i < nk) {
        const int t = i / ck;
        const long long r = (row0 + t) * Hkv + h;
        kx[u] = *reinterpret_cast<const uint4*>(kp + r * dk + (i - t * ck) * E);
        ksc[u] = ks != nullptr ? ks[r] : 1.f;
      }
      if (i < nv) {
        const int t = i / cv;
        const long long r = (row0 + t) * Hkv + h;
        vx[u] = *reinterpret_cast<const uint4*>(vp + r * dv + (i - t * cv) * E);
        vsc[u] = vs != nullptr ? vs[r] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = b0 + u * kThreads;
      if (i < nk) {
        const int t = i / ck;
        const KT* e = reinterpret_cast<const KT*>(&kx[u]);
        float* d = k_s + t * dkq + (i - t * ck) * E;
#pragma unroll
        for (int x = 0; x < E; ++x) d[x] = to_f(e[x]) * ksc[u];
      }
      if (i < nv) {
        const int t = i / cv;
        const KT* e = reinterpret_cast<const KT*>(&vx[u]);
        float* d = v_s + t * dv + (i - t * cv) * E;
#pragma unroll
        for (int x = 0; x < E; ++x) d[x] = to_f(e[x]) * vsc[u];
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q (B, H, dk + dr); k/v pages (n_pages, page, Hkv, dk | dv);
// table (B, P); lens (B,); ks/vs (n_pages, page, Hkv) or null;
// ke (n_pages, page, Hkv, dr) or null; out (B, H, dv).
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_kernel(
    const QT* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, const float* __restrict__ ks,
    const float* __restrict__ vs, const QT* __restrict__ ke,
    QT* __restrict__ out, int H, int Hkv, int dk, int dv, int dr,
    int n_pages, int page, int P, int window, float scale) {
  extern __shared__ float smem[];
  const int g = H / Hkv;
  const int dkq = dk + dr;
  float* q_s = smem;              // (g, dkq)
  float* acc = q_s + g * dkq;     // (g, dv)
  float* p_s = acc + g * dv;      // (g, page) scores, then probabilities
  float* m_s = p_s + g * page;    // (g,) running max
  float* l_s = m_s + g;           // (g,) running sum
  float* a_s = l_s + g;           // (g,) rescale of this page
  float* k_s = a_s + g;           // (page, dkq) staged keys
  float* v_s = k_s + page * dkq;  // (page, dv) staged values

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const QT* qb = q + (static_cast<long long>(b) * H + h * g) * dkq;
  for (int i = tid; i < g * dkq; i += kThreads) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < g * dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int len = lens[b];
  const int live = (len + page - 1) / page;
  int first = 0;
  if (window > 0 && len - window > 0) first = (len - window) / page;
  const bool vec = reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vp) % 16 == 0 &&
                   (dk * sizeof(KT)) % 16 == 0 && (dv * sizeof(KT)) % 16 == 0;

  for (int j = first; j < live; ++j) {
    int phys = table[static_cast<long long>(b) * P + j];
    phys = min(max(phys, 0), n_pages - 1);
    const long long row0 = static_cast<long long>(phys) * page;

    // stage the page: K rows (main block, then k_extra) and V rows,
    // dequantized (value * its token's scale) on the way in
    if (vec) {
      stage_kv_vec<KT>(kp, vp, ks, vs, k_s, v_s, row0, Hkv, h, dk, dv, dkq,
                       page, tid);
    } else {
      stage(page * dk, tid, [=](int i) {
        const int t = i / dk;
        const long long r = (row0 + t) * Hkv + h;  // (token, kv head) row
        return to_f(kp[r * dk + (i - t * dk)]) * (ks != nullptr ? ks[r] : 1.f);
      }, [=](int i, float x) { k_s[(i / dk) * dkq + i % dk] = x; });
      stage(page * dv, tid, [=](int i) {
        const int t = i / dv;
        const long long r = (row0 + t) * Hkv + h;
        return to_f(vp[r * dv + (i - t * dv)]) * (vs != nullptr ? vs[r] : 1.f);
      }, [=](int i, float x) { v_s[i] = x; });
    }
    stage(page * dr, tid, [=](int i) {
      const int t = i / dr;
      return to_f(ke[((row0 + t) * Hkv + h) * dr + (i - t * dr)]);
    }, [=](int i, float x) { k_s[(i / dr) * dkq + dk + i % dr] = x; });
    __syncthreads();

    for (int pair = warp; pair < page * g; pair += kWarps) {
      const int t = pair / g;
      const int gi = pair - t * g;
      const float* qr = q_s + gi * dkq;
      const float* kr = k_s + t * dkq;
      float s = 0.f;
      for (int d = lane; d < dkq; d += 32) s += qr[d] * kr[d];
      s = warp_sum(s);
      if (lane == 0) {
        s *= scale;
        const int pos = j * page + t;
        bool ok = pos < len;
        if (window > 0) ok = ok && (pos > len - 1 - window);
        p_s[gi * page + t] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    for (int gi = tid; gi < g; gi += kThreads) {
      float* sr = p_s + gi * page;
      const float m_old = m_s[gi];
      float m_new = m_old;
      for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, sr[t]);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float pv = expf(sr[t] - m_new);
        sr[t] = pv;
        sum += pv;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      m_s[gi] = m_new;
      a_s[gi] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < g * dv; i += kThreads) {
      const int gi = i / dv;
      const int e = i - gi * dv;
      const float* pr = p_s + gi * page;
      float a = acc[i] * a_s[gi];
      for (int t = 0; t < page; ++t) a += pr[t] * v_s[t * dv + e];
      acc[i] = a;
    }
    __syncthreads();
  }

  QT* ob = out + (static_cast<long long>(b) * H + h * g) * dv;
  for (int i = tid; i < g * dv; i += kThreads)
    ob[i] = from_f<QT>(acc[i] / fmaxf(l_s[i / dv], 1e-30f));
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lens, const float* ks,
                   const float* vs, const void* ke, void* out, int B, int H,
                   int Hkv, int dk, int dv, int dr, int n_pages, int page,
                   int P, int window, float scale, size_t smem,
                   cudaStream_t stream) {
  auto kern = paged_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), table, lens, ks, vs,
      static_cast<const QT*>(ke), static_cast<QT*>(out), H, Hkv, dk, dv, dr,
      n_pages, page, P, window, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* k,
                      const void* v, const int* table, const int* lens,
                      const float* ks, const float* vs, const void* ke,
                      void* out, int B, int H, int Hkv, int dk, int dv,
                      int dr, int n_pages, int page, int P, int window,
                      float scale, size_t smem, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float>(q, k, v, table, lens, ks, vs, ke, out, B, H,
                               Hkv, dk, dv, dr, n_pages, page, P, window,
                               scale, smem, s);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, k, v, table, lens, ks, vs, ke, out,
                                       B, H, Hkv, dk, dv, dr, n_pages, page,
                                       P, window, scale, smem, s);
    case kI8:
      return launch<QT, int8_t>(q, k, v, table, lens, ks, vs, ke, out, B, H,
                                Hkv, dk, dv, dr, n_pages, page, P, window,
                                scale, smem, s);
    case kFP8:
      return launch<QT, __nv_fp8_e4m3>(q, k, v, table, lens, ks, vs, ke, out,
                                       B, H, Hkv, dk, dv, dr, n_pages, page,
                                       P, window, scale, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory the kernel needs for these shapes (bytes).
extern "C" long long paged_attention_smem(int H, int Hkv, int dkq, int dv,
                                          int page) {
  const long long g = H / Hkv;
  const long long floats =
      g * (dkq + dv + page) + 3 * g + static_cast<long long>(page) * (dkq + dv);
  return floats * static_cast<long long>(sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* table,
    const int* lens, const float* k_scale, const float* v_scale,
    const void* k_extra, void* out, int B, int H, int Hkv, int dk, int dv,
    int dr, int n_pages, int page, int P, int window, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  const size_t smem =
      static_cast<size_t>(paged_attention_smem(H, Hkv, dk + dr, dv, page));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == kF32) {
    e = launch_kv<float>(kv_dtype, q, k, v, table, lens, k_scale, v_scale,
                         k_extra, out, B, H, Hkv, dk, dv, dr, n_pages, page, P,
                         window, scale, smem, s);
  } else if (q_dtype == kBF16) {
    e = launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, table, lens, k_scale,
                                 v_scale, k_extra, out, B, H, Hkv, dk, dv, dr,
                                 n_pages, page, P, window, scale, smem, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
