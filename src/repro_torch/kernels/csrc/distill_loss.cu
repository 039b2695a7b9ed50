// Fused Eqn-9 distillation loss for Hopper (sm_90a), forward and
// backward, plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel pair of src/repro/kernels/distill_loss.py
// (`fused_distill_loss`: `_fwd_kernel` and `_bwd_kernel`).  Per row i of
// (N, V) logits z, int labels y and pseudo-label probabilities p:
//   forward   lse_i = log sum_j exp(z_ij),  gold_i = z_i[y_i],
//             dot_i = <p_i, z_i>            (f32; the caller forms
//             loss = mean((1+lam)*lse - gold - lam*dot), as the JAX
//             package does outside its kernel)
//   backward  dz_ij = g/N * ((1+lam)*exp(z_ij - lse_i) - [j == y_i]
//                            - lam*p_ij)    (in the logits' type)
// A label outside [0, V) (-1 pads) hits no column.  g (the upstream
// gradient) and lam are read from device memory, so a training step
// never waits on the host for them.
//
// What bounds it: bytes.  The forward reads logits and pseudo once and
// does a few flops and one exp per element; the backward reads them once
// more and writes dz.  At V = 100 (NiN) a call is a few hundred KB and
// launch latency decides; at an LM vocab (V = 262144) it is the bytes
// over the 3.35 TB/s memory rate.
//
// Design (simple and right first):
//   - forward: one block per row, as many threads as the row has 4-wide
//     column groups (one warp for V <= 128, at most 256).  Each thread
//     streams its columns four at a time (16-byte f32 / 8-byte bf16
//     loads when rows are aligned, element loads otherwise) keeping an
//     online max and sum-exp, the gold logit by column compare, and the
//     pseudo dot in f32; the block reduces them with warp shuffles and
//     one shared-memory pass.  The TPU kernel's sequential vocab grid
//     axis becomes this loop inside the block.
//   - backward: elementwise; one block per (row, 4*threads columns).
//   - 64-bit element offsets throughout (row * V passes 2^31 on LM
//     batches).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the TPU kernel
constexpr int kMaxThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements at p[0..3] as f32.  kVec: one 16-byte (f32)
// or 8-byte (bf16) load, the caller guarantees alignment and n >= 4;
// otherwise element loads, elements at or past n read as `fill`.
template <bool kVec>
__device__ __forceinline__ void load4(const float* p, int n, float fill,
                                      float out[4]) {
  if (kVec) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? p[i] : fill;
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n,
                                      float fill, float out[4]) {
  if (kVec) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? to_f(p[i]) : fill;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int n, const float v[4]) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = v[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n,
                                       const float v[4]) {
  if (kVec) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned int*>(&a);
    u.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = from_f<__nv_bfloat16>(v[i]);
  }
}

// The column a label hits, or -1 (no column) outside [0, V).
__device__ __forceinline__ int label_col(int y, int V) {
  return y >= 0 && y < V ? y : -1;
}

// (m, s) pairs of a running logsumexp: sum exp(z) = s * exp(m).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// logits (N, V) ZT, pseudo (N, V) PT, labels (N,) -> lse, gold, dot (N,)
template <typename ZT, typename PT, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) distill_fwd_kernel(
    const ZT* __restrict__ logits, const PT* __restrict__ pseudo,
    const int* __restrict__ labels, float* __restrict__ lse_out,
    float* __restrict__ gold_out, float* __restrict__ dot_out, int V) {
  __shared__ float red[4][kMaxThreads / 32];
  const long long row = blockIdx.x;
  const ZT* z_row = logits + row * V;
  const PT* p_row = pseudo + row * V;
  const int y = label_col(labels[row], V);

  float m = kNegInf, s = 0.f, gold = 0.f, dot = 0.f;
  for (int c = threadIdx.x * 4; c < V; c += blockDim.x * 4) {
    float z[4], p[4];
    load4<kVec>(z_row + c, V - c, kNegInf, z);
    load4<kVec>(p_row + c, V - c, 0.f, p);
    const float mc = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
    if (mc > m) {
      s *= expf(m - mc);
      m = mc;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += expf(z[i] - m);
      dot += p[i] * z[i];
      if (c + i == y) gold += z[i];
    }
  }

  // warp, then block reduction
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
    gold += __shfl_xor_sync(0xffffffffu, gold, o);
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  if (n_warps > 1) {
    if (lane == 0) {
      red[0][warp] = m;
      red[1][warp] = s;
      red[2][warp] = gold;
      red[3][warp] = dot;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < n_warps ? red[0][lane] : kNegInf;
      s = lane < n_warps ? red[1][lane] : 0.f;
      gold = lane < n_warps ? red[2][lane] : 0.f;
      dot = lane < n_warps ? red[3][lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
        lse_merge(m, s, m2, s2);
        gold += __shfl_xor_sync(0xffffffffu, gold, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
    }
  }
  if (threadIdx.x == 0) {
    lse_out[row] = m + logf(fmaxf(s, 1e-30f));
    gold_out[row] = gold;
    dot_out[row] = dot;
  }
}

// dz (N, V) ZT = g/N * ((1+lam)*exp(z - lse) - onehot(y) - lam*p)
template <typename ZT, typename PT, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) distill_bwd_kernel(
    const ZT* __restrict__ logits, const PT* __restrict__ pseudo,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g, const float* __restrict__ lam_p,
    ZT* __restrict__ dz, long long N, int V) {
  const long long row = blockIdx.x;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (c >= V) return;
  const long long off = row * V + c;
  const float gc = g[0] / static_cast<float>(N);
  const float lam = lam_p[0];
  const float l = lse[row];
  const int y = label_col(labels[row], V);
  float z[4], p[4], d[4];
  load4<kVec>(logits + off, V - c, 0.f, z);
  load4<kVec>(pseudo + off, V - c, 0.f, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float soft = expf(z[i] - l);
    const float onehot = (c + i == y) ? 1.f : 0.f;
    d[i] = gc * ((1.f + lam) * soft - onehot - lam * p[i]);
  }
  store4<kVec>(dz + off, V - c, d);
}

int threads_for(int V) {
  const int groups = (V + 3) / 4;
  int t = ((groups + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Rows of 16-byte-aligned f32 / 8-byte-aligned bf16 four-element groups.
bool vec_ok(const void* p, int dtype, int V) {
  const uintptr_t align = dtype == kF32 ? 16 : 8;
  return V % 4 == 0 && reinterpret_cast<uintptr_t>(p) % align == 0;
}

template <typename ZT, typename PT>
cudaError_t fwd(const void* z, const void* p, const int* y, float* lse,
                float* gold, float* dot, long long N, int V, bool vec,
                cudaStream_t s) {
  const int t = threads_for(V);
  if (vec) {
    distill_fwd_kernel<ZT, PT, true><<<static_cast<unsigned>(N), t, 0, s>>>(
        static_cast<const ZT*>(z), static_cast<const PT*>(p), y, lse, gold,
        dot, V);
  } else {
    distill_fwd_kernel<ZT, PT, false><<<static_cast<unsigned>(N), t, 0, s>>>(
        static_cast<const ZT*>(z), static_cast<const PT*>(p), y, lse, gold,
        dot, V);
  }
  return cudaGetLastError();
}

template <typename ZT, typename PT>
cudaError_t bwd(const void* z, const void* p, const int* y, const float* lse,
                const float* g, const float* lam, void* dz, long long N,
                int V, bool vec, cudaStream_t s) {
  const int t = threads_for(V);
  const dim3 grid(static_cast<unsigned>(N), (V + 4 * t - 1) / (4 * t));
  if (vec) {
    distill_bwd_kernel<ZT, PT, true><<<grid, t, 0, s>>>(
        static_cast<const ZT*>(z), static_cast<const PT*>(p), y, lse, g, lam,
        static_cast<ZT*>(dz), N, V);
  } else {
    distill_bwd_kernel<ZT, PT, false><<<grid, t, 0, s>>>(
        static_cast<const ZT*>(z), static_cast<const PT*>(p), y, lse, g, lam,
        static_cast<ZT*>(dz), N, V);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// z_dtype / p_dtype: 0 f32, 1 bf16.
extern "C" int distill_fwd_launch(const void* logits, const void* pseudo,
                                  const int* labels, float* lse, float* gold,
                                  float* dot, long long N, int V,
                                  int z_dtype, int p_dtype, void* stream) {
  const bool vec = vec_ok(logits, z_dtype, V) && vec_ok(pseudo, p_dtype, V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (z_dtype == kF32 && p_dtype == kF32) {
    e = fwd<float, float>(logits, pseudo, labels, lse, gold, dot, N, V, vec,
                          s);
  } else if (z_dtype == kF32 && p_dtype == kBF16) {
    e = fwd<float, __nv_bfloat16>(logits, pseudo, labels, lse, gold, dot, N,
                                  V, vec, s);
  } else if (z_dtype == kBF16 && p_dtype == kF32) {
    e = fwd<__nv_bfloat16, float>(logits, pseudo, labels, lse, gold, dot, N,
                                  V, vec, s);
  } else if (z_dtype == kBF16 && p_dtype == kBF16) {
    e = fwd<__nv_bfloat16, __nv_bfloat16>(logits, pseudo, labels, lse, gold,
                                          dot, N, V, vec, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// dz has the logits' type; g and lam are f32 scalars in device memory.
extern "C" int distill_bwd_launch(const void* logits, const void* pseudo,
                                  const int* labels, const float* lse,
                                  const float* g, const float* lam, void* dz,
                                  long long N, int V, int z_dtype,
                                  int p_dtype, void* stream) {
  const bool vec = vec_ok(logits, z_dtype, V) &&
                   vec_ok(pseudo, p_dtype, V) && vec_ok(dz, z_dtype, V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (z_dtype == kF32 && p_dtype == kF32) {
    e = bwd<float, float>(logits, pseudo, labels, lse, g, lam, dz, N, V, vec,
                          s);
  } else if (z_dtype == kF32 && p_dtype == kBF16) {
    e = bwd<float, __nv_bfloat16>(logits, pseudo, labels, lse, g, lam, dz, N,
                                  V, vec, s);
  } else if (z_dtype == kBF16 && p_dtype == kF32) {
    e = bwd<__nv_bfloat16, float>(logits, pseudo, labels, lse, g, lam, dz, N,
                                  V, vec, s);
  } else if (z_dtype == kBF16 && p_dtype == kBF16) {
    e = bwd<__nv_bfloat16, __nv_bfloat16>(logits, pseudo, labels, lse, g, lam,
                                          dz, N, V, vec, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
