// The partial-result combine shared by the split attention kernels
// (paged_attention.cu over a row's live pages, flash_attention.cu over a
// chunk's key tiles).
//
// A split kernel that divides one output row's keys over n_split blocks
// writes, for every (row, split), dv unnormalised f32 accumulator
// values, then its running max m and its running sum l:
//     part[(row * n_split + split) * (dv + 2) + e]   e < dv: acc
//     part[... + dv] = m,  part[... + dv + 1] = l.
// A split that saw no key writes acc = 0, m = NEG_INF, l = 0.  The
// combine rescales every split to the largest m and divides by the
// rescaled sum of l:
//     out[row, e] = sum_s acc_s[e] e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
// with M = max_s m_s, as the kernels' own epilogue does for one split.
// Rows are the output's rows in memory order (out is (rows, dv)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

template <typename T>
__device__ __forceinline__ T out_cast(float x);
template <>
__device__ __forceinline__ float out_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 out_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kCombineThreads = 128;
// splits whose weights fit the 48 KB of shared memory a launch gets
constexpr int kCombineMaxSplit = 48 * 1024 / 4;

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // red is free (an earlier reduction has been read)
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kCombineThreads / 32; ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One block of kCombineThreads per output row, n_split floats of
// dynamic shared memory: the splits' weights e^(m_s - M) are formed once
// (a thread per split), then threads stride the dv columns, each column
// a sum of n_split independent loads.
template <typename OT>
__device__ __forceinline__ void combine_row(const float* __restrict__ part,
                                            OT* __restrict__ out,
                                            int n_split, int dv) {
  extern __shared__ float w_s[];  // (n_split,)
  __shared__ float red[kCombineThreads / 32];
  const long long row = blockIdx.x;
  const int ld = dv + 2;
  const float* pr = part + row * n_split * ld;
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_split; s += kCombineThreads) {
    w_s[s] = pr[s * ld + dv];
    mx = fmaxf(mx, w_s[s]);
  }
  const float M = block_reduce(mx, true, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < n_split; s += kCombineThreads) {
    const float w = expf(w_s[s] - M);
    w_s[s] = w;
    l += pr[s * ld + dv + 1] * w;
  }
  const float inv = 1.f / fmaxf(block_reduce(l, false, red), 1e-30f);
  for (int e = threadIdx.x; e < dv; e += kCombineThreads) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 4 <= n_split; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[u] = fmaf(pr[(s + u) * ld + e], w_s[s + u], o[u]);
    }
    for (; s < n_split; ++s) o[0] = fmaf(pr[s * ld + e], w_s[s], o[0]);
    out[row * dv + e] = out_cast<OT>(((o[0] + o[1]) + (o[2] + o[3])) * inv);
  }
}

}  // namespace attn
