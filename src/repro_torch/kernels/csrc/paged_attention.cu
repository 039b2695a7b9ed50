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
// balance point, so the least time is live-page bytes over the 3.35 TB/s
// memory rate.  What kept the first kernel (one block per (row, kv head)
// walking the row's pages one at a time, load -> sync -> scores -> sync
// -> a one-thread-per-head softmax -> sync -> values) at ~14% of that
// bound was latency: too few blocks (16 for gemma3-1b's Hkv = 1 on 132
// SMs) and one page's memory latency after another.
//
// Design (flash-decoding):
//   - the grid is (row, kv head, split): a row's live pages [first,
//     ceil(len/page)) (first honours the window) are divided evenly over
//     n_split blocks on the device, from lens[b], so ragged rows stay
//     balanced and the host never reads lens.  n_split comes from shapes
//     the host knows (rows, Hkv, P and the SM count: about two blocks
//     per SM, see kernels/paged_attention.n_splits);
//   - a block reads its row's page ids into shared memory once, then
//     stages `ppt` pages a step (32 tokens at page 16) in their stored
//     type with 16-byte cp.async (a warp copies whole rows, each lane a
//     fixed chunk, so the loop forms one address per row and divides
//     nothing; rows whose width is not a multiple of 16 bytes take an
//     element-wise path), double-buffered: the next tile's copies are
//     in flight while this one's scores and values are computed;
//   - quantized pages are dequantized in the products, not in the
//     staging: the key scale multiplies a token's dot product, the value
//     scale its probability;
//   - scores: four lanes per token, 8 tokens a warp at once, each lane a
//     quarter of the row in 16-byte chunks and the scores of up to four
//     query heads in registers, two shuffles to reduce; softmax: one
//     warp per head, the tile's max and sum by shuffles; values: threads
//     own (head, feature-pair) columns, four tokens a step;
//   - with one split the block writes the output itself; with several,
//     each writes its partial (m, l, acc) in f32 and a second kernel
//     (attention_combine.cuh) merges a row's partials.  A split with no
//     live page writes acc = 0, m = NEG_INF, l = 0;
//   - table entries >= n_pages (unallocated) are clamped to a real page
//     and masked by position, like the TPU kernel's index map.
// Decode scores stay on the CUDA cores in f32: at g <= 4 a tensor-core
// tile would be mostly padding, and the bytes bound the kernel anyway.
// Still left: at deepseek-7b's shape (g = 1, 512 blocks of ~14 tiles)
// the kernel reads at about 2 TB/s with no compute (copies alone) and
// the per-tile block barriers keep the products from hiding under the
// copies; warp-private tiles with a final merge, or TMA page copies
// into a persistent grid, are the next steps.  At gemma3-1b's shape
// (272 blocks of one tile) the launch, the first copy's latency and the
// combine launch are most of the time.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_combine.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the TPU kernel
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 4;  // query heads whose scores a lane holds at once
constexpr int kStages = 2;  // tiles in shared memory: one used, one copied

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// two adjacent stored values (2-element aligned) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return make_float2(to_f(p[0]), to_f(p[1]));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// q rows in shared memory: dk + dr floats padded to a multiple of 4
__host__ __device__ __forceinline__ int q_ld(int dk, int dr) {
  return (dk + dr + 3) & ~3;
}

// Byte offsets of the shared-memory regions: the block's own state
// first (its page ids, q as f32, the accumulator, the tile's
// probabilities, m, l and the rescale per head), then kStages tiles of
// `tt` tokens in their stored types (K rows, V rows, k_extra rows, K
// and V scales).
struct Layout {
  long long tab, q, acc, p, m, l, a, stage0, stage_bytes;
  long long k, v, ke, ks, vs;  // offsets within a stage
  long long total;
};

__host__ __device__ inline Layout layout(int g, int dk, int dv, int dr,
                                         int tt, int P, int kv_size,
                                         int q_size) {
  Layout L;
  long long at = 0;
  L.tab = at; at += align16(4LL * P);
  L.q = at; at += align16(4LL * g * q_ld(dk, dr));
  L.acc = at; at += align16(4LL * g * dv);
  L.p = at; at += align16(4LL * g * tt);
  L.m = at; at += align16(4LL * g);
  L.l = at; at += align16(4LL * g);
  L.a = at; at += align16(4LL * g);
  L.stage0 = at;
  long long s = 0;
  L.k = s; s += align16(static_cast<long long>(tt) * dk * kv_size);
  L.v = s; s += align16(static_cast<long long>(tt) * dv * kv_size);
  L.ke = s; s += align16(static_cast<long long>(tt) * dr * q_size);
  L.ks = s; s += align16(4LL * tt);
  L.vs = s; s += align16(4LL * tt);
  L.stage_bytes = s;
  L.total = at + kStages * s;
  return L;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lens;
  const float* ks;
  const float* vs;
  const void* ke;
  void* out;
  float* part;  // (B * H, n_split, dv + 2) partials, or null at one split
  int H, Hkv, dk, dv, dr, n_pages, page, P, window, ppt, n_split;
  int vec_kv, vec_ke;  // rows 16-byte copyable
  float scale;
};

// Copies the rows of kv head h of pages [p0, p1) of one plane (rows of
// `bytes`, a multiple of 16, 16-byte aligned) into dst, as 16-byte
// cp.async.  When a row is c <= 32 chunks and c divides 32, a warp copies
// 32 / c whole rows an instruction, each lane one fixed chunk; longer
// rows take the warp's lanes a row at a time.  No division in the loop.
__device__ __forceinline__ void stage_plane(char* dst, const char* src,
                                            int bytes, const int* tab,
                                            int p0, int p1, int page,
                                            int Hkv, int h, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = bytes >> 4;
  if (c <= 32 && 32 % c == 0) {
    const int per = 32 / c;  // rows a warp instruction copies
    const int u0 = warp * per + lane / c;
    const int off = (lane % c) * 16;
    for (int j = p0; j < p1; ++j) {
      const long long base = static_cast<long long>(tab[j]) * page;
      char* d = dst + static_cast<long long>(j - p0) * page * bytes + off;
      for (int u = u0; u < page; u += kWarps * per)
        cp_async16(d + u * bytes, src + ((base + u) * Hkv + h) * bytes + off);
    }
    return;
  }
  for (int j = p0; j < p1; ++j) {
    const long long base = static_cast<long long>(tab[j]) * page;
    char* d = dst + static_cast<long long>(j - p0) * page * bytes;
    for (int u = warp; u < page; u += kWarps) {
      const char* sr = src + ((base + u) * Hkv + h) * bytes;
      for (int o = lane * 16; o < bytes; o += 32 * 16)
        cp_async16(d + u * bytes + o, sr + o);
    }
  }
}

// Copies one row of `bytes` from src to dst (shared) with the lanes of
// a warp, one plain load and store per element of elem bytes: the path
// for rows whose width is not a multiple of 16 bytes.
__device__ __forceinline__ void copy_row(char* dst, const char* src,
                                         int bytes, int elem, int lane) {
  for (int c = lane * elem; c < bytes; c += 32 * elem) {
    if (elem == 4) {
      *reinterpret_cast<uint32_t*>(dst + c) =
          *reinterpret_cast<const uint32_t*>(src + c);
    } else if (elem == 2) {
      *reinterpret_cast<uint16_t*>(dst + c) =
          *reinterpret_cast<const uint16_t*>(src + c);
    } else {
      dst[c] = src[c];
    }
  }
}

// Stages pages [p0, p1) of kv head h ((p1 - p0) * page tokens) into the
// stage at `st`; tab[j] is page j's clamped id.
template <typename QT, typename KT>
__device__ __forceinline__ void stage_tile(const Params& a, const Layout& L,
                                           char* st, const int* tab, int h,
                                           int p0, int p1, int tid) {
  const int kb = a.dk * sizeof(KT), vb = a.dv * sizeof(KT);
  const int eb = a.dr * sizeof(QT);
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  const char* ep = static_cast<const char*>(a.ke);
  if (a.vec_kv) {
    stage_plane(st + L.k, kp, kb, tab, p0, p1, a.page, a.Hkv, h, tid);
    stage_plane(st + L.v, vp, vb, tab, p0, p1, a.page, a.Hkv, h, tid);
  }
  if (!a.vec_kv || a.dr > 0 || a.ks != nullptr || a.vs != nullptr) {
    // the rest a warp a token at a time: k_extra rows, the scales, and
    // K/V rows that are not 16-byte multiples
    const int lane = tid & 31;
    float* ks_s = reinterpret_cast<float*>(st + L.ks);
    float* vs_s = reinterpret_cast<float*>(st + L.vs);
    for (int j = p0; j < p1; ++j) {
      const long long base = static_cast<long long>(tab[j]) * a.page;
      const int t0 = (j - p0) * a.page;
      for (int u = tid >> 5; u < a.page; u += kWarps) {
        const long long r = (base + u) * a.Hkv + h;  // (token, kv head) row
        const int t = t0 + u;
        if (!a.vec_kv) {
          copy_row(st + L.k + t * kb, kp + r * kb, kb, sizeof(KT), lane);
          copy_row(st + L.v + t * vb, vp + r * vb, vb, sizeof(KT), lane);
        }
        if (a.dr > 0) {
          if (a.vec_ke) {
            for (int o = lane * 16; o < eb; o += 32 * 16)
              cp_async16(st + L.ke + t * eb + o, ep + r * eb + o);
          } else {
            copy_row(st + L.ke + t * eb, ep + r * eb, eb, sizeof(QT), lane);
          }
        }
        if (lane == 0 && a.ks != nullptr) cp_async4(ks_s + t, a.ks + r);
        if (lane == 1 && a.vs != nullptr) cp_async4(vs_s + t, a.vs + r);
      }
    }
  }
}

// q (B, H, dk + dr); k/v pages (n_pages, page, Hkv, dk | dv);
// table (B, P); lens (B,); ks/vs (n_pages, page, Hkv) or null; ke
// (n_pages, page, Hkv, dr) or null; out (B, H, dv).
// Grid: B * Hkv * n_split blocks, split fastest; four blocks an SM (at
// most 128 registers a thread).
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, 4) paged_kernel(Params a) {
  extern __shared__ __align__(16) char smem[];
  const int g = a.H / a.Hkv;
  const int dkq = a.dk + a.dr;
  const int qld = q_ld(a.dk, a.dr);
  const int tt = a.ppt * a.page;
  const Layout L =
      layout(g, a.dk, a.dv, a.dr, tt, a.P, sizeof(KT), sizeof(QT));
  int* tab_s = reinterpret_cast<int*>(smem + L.tab);      // (P,)
  float* q_s = reinterpret_cast<float*>(smem + L.q);      // (g, qld)
  float* acc = reinterpret_cast<float*>(smem + L.acc);    // (g, dv)
  float* p_s = reinterpret_cast<float*>(smem + L.p);      // (g, tt)
  float* m_s = reinterpret_cast<float*>(smem + L.m);      // (g,)
  float* l_s = reinterpret_cast<float*>(smem + L.l);      // (g,)
  float* a_s = reinterpret_cast<float*>(smem + L.a);      // (g,)
  char* stages = smem + L.stage0;

  const int split = blockIdx.x % a.n_split;
  const int bh = blockIdx.x / a.n_split;
  const int b = bh / a.Hkv;
  const int h = bh - b * a.Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this split's even share of the row's live pages
  const int len = a.lens[b];
  const int live = (len + a.page - 1) / a.page;
  int first = 0;
  if (a.window > 0 && len - a.window > 0) first = (len - a.window) / a.page;
  const int n_live = max(live - first, 0);
  const int lo = first + split * n_live / a.n_split;
  const int hi = first + (split + 1) * n_live / a.n_split;

  // the row's page ids, clamped to real pages, read once
  const int* trow = a.table + static_cast<long long>(b) * a.P;
  for (int j = tid; j < a.P; j += kThreads)
    tab_s[j] = min(max(trow[j], 0), a.n_pages - 1);
  __syncthreads();
  const int* tab = tab_s;
  // the first tile's copies go out before q is read; every tile is one
  // commit group (empty past the split's end), so the waits stay uniform
  if (lo < hi)
    stage_tile<QT, KT>(a, L, stages, tab, h, lo, min(lo + a.ppt, hi), tid);
  cp_async_commit();

  const QT* qb = static_cast<const QT*>(a.q) +
                 (static_cast<long long>(b) * a.H + h * g) * dkq;
  for (int i = tid; i < g * dkq; i += kThreads)
    q_s[(i / dkq) * qld + i % dkq] = to_f(qb[i]);
  for (int i = tid; i < g * a.dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int it = 0, p0 = lo; p0 < hi; ++it, p0 += a.ppt) {
    const int p1 = min(p0 + a.ppt, hi);
    // tile it + 1 goes out before tile it is used
    const int pn = p0 + a.ppt;
    if (pn < hi)
      stage_tile<QT, KT>(a, L, stages + (it + 1) % kStages * L.stage_bytes,
                         tab, h, pn, min(pn + a.ppt, hi), tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const char* st = stages + it % kStages * L.stage_bytes;
    const KT* k_s = reinterpret_cast<const KT*>(st + L.k);
    const KT* v_s = reinterpret_cast<const KT*>(st + L.v);
    const QT* ke_s = reinterpret_cast<const QT*>(st + L.ke);
    const float* ks_s = reinterpret_cast<const float*>(st + L.ks);
    const float* vs_s = reinterpret_cast<const float*>(st + L.vs);
    const int n = (p1 - p0) * a.page;

    // scores: four lanes per token (a warp takes 8 tokens at once), each
    // lane a quarter of the features in 16-byte chunks, the scores
    // of kG heads at a time in registers, two shuffles to reduce
    const int sub = lane & 3;
    for (int t0 = warp * 8; t0 < n; t0 += kWarps * 8) {
      const int t = t0 + (lane >> 2);
      const int tr = t < n ? t : 0;  // lanes past the tile read row 0
      const KT* kr = k_s + static_cast<long long>(tr) * a.dk;
      const QT* er = ke_s + static_cast<long long>(tr) * a.dr;
      const float ksc = a.ks != nullptr ? ks_s[tr] : 1.f;
      const int pos = p0 * a.page + t;
      bool ok = pos < len;
      if (a.window > 0) ok = ok && pos > len - 1 - a.window;
      for (int g0 = 0; g0 < g; g0 += kG) {
        const float* qg = q_s + g0 * qld;
        float s[kG];
#pragma unroll
        for (int j = 0; j < kG; ++j) s[j] = 0.f;
        if (a.vec_kv) {
          constexpr int E = 16 / sizeof(KT);
          for (int c = sub * E; c < a.dk; c += 4 * E) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
            const KT* kv = reinterpret_cast<const KT*>(&raw);
            // 8 values converted at a time: 16 one-byte values at once
            // spill at the 128-register cap
            constexpr int E8 = E < 8 ? E : 8;
#pragma unroll
            for (int x0 = 0; x0 < E; x0 += E8) {
              float kf[E8];
#pragma unroll
              for (int x = 0; x < E8; ++x) kf[x] = to_f(kv[x0 + x]);
#pragma unroll
              for (int j = 0; j < kG; ++j) {
                if (g0 + j >= g) break;
                const float* qr = qg + j * qld + c + x0;
#pragma unroll
                for (int x = 0; x < E8; ++x) s[j] = fmaf(qr[x], kf[x], s[j]);
              }
            }
          }
        } else {
          for (int d = sub; d < a.dk; d += 4) {
            const float kf = to_f(kr[d]);
#pragma unroll
            for (int j = 0; j < kG; ++j)
              if (g0 + j < g) s[j] = fmaf(qg[j * qld + d], kf, s[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kG; ++j) s[j] *= ksc;
        for (int d = sub; d < a.dr; d += 4) {
          const float ef = to_f(er[d]);
#pragma unroll
          for (int j = 0; j < kG; ++j)
            if (g0 + j < g) s[j] = fmaf(qg[j * qld + a.dk + d], ef, s[j]);
        }
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
        }
        if (sub == 0 && t < n) {
#pragma unroll
          for (int j = 0; j < kG; ++j)
            if (g0 + j < g)
              p_s[(g0 + j) * tt + t] = ok ? s[j] * a.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per head; the value scale joins p after
    // the sum is taken
    for (int gi = warp; gi < g; gi += kWarps) {
      float* sr = p_s + gi * tt;
      float mx = -INFINITY;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sr[t]);
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pv = expf(sr[t] - m_new);
        sum += pv;
        sr[t] = a.vs != nullptr ? pv * vs_s[t] : pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();

    // values: threads own (head, feature) columns, two adjacent ones
    // where dv is even, four tokens a step on four independent sums
    for (int i2 = tid; i2 < g * a.dv / 2 && a.dv % 2 == 0; i2 += kThreads) {
      const int gi = 2 * i2 / a.dv;
      const int e = 2 * i2 - gi * a.dv;
      const float* pr = p_s + gi * tt;
      const KT* vc = v_s + e;
      float2 o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = make_float2(0.f, 0.f);
      int t = 0;
      for (; t + 4 <= n; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = load2(vc + static_cast<long long>(t + u) * a.dv);
          o[u].x = fmaf(pr[t + u], x.x, o[u].x);
          o[u].y = fmaf(pr[t + u], x.y, o[u].y);
        }
      }
      for (; t < n; ++t) {
        const float2 x = load2(vc + static_cast<long long>(t) * a.dv);
        o[0].x = fmaf(pr[t], x.x, o[0].x);
        o[0].y = fmaf(pr[t], x.y, o[0].y);
      }
      float* ac = acc + gi * a.dv + e;
      ac[0] = ac[0] * a_s[gi] + ((o[0].x + o[1].x) + (o[2].x + o[3].x));
      ac[1] = ac[1] * a_s[gi] + ((o[0].y + o[1].y) + (o[2].y + o[3].y));
    }
    for (int i = tid; i < g * a.dv && a.dv % 2 != 0; i += kThreads) {
      const int gi = i / a.dv;
      const int e = i - gi * a.dv;
      const float* pr = p_s + gi * tt;
      const KT* vc = v_s + e;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      int t = 0;
      for (; t + 4 <= n; t += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          o[u] = fmaf(pr[t + u],
                      to_f(vc[static_cast<long long>(t + u) * a.dv]), o[u]);
      }
      for (; t < n; ++t)
        o[0] = fmaf(pr[t], to_f(vc[static_cast<long long>(t) * a.dv]), o[0]);
      acc[i] = acc[i] * a_s[gi] + ((o[0] + o[1]) + (o[2] + o[3]));
    }
    __syncthreads();  // this stage is refilled on the next tile
  }
  cp_async_wait<0>();
  __syncthreads();  // a split with no page: the initial state is written

  const long long row0 = static_cast<long long>(b) * a.H + h * g;
  if (a.n_split == 1) {
    QT* ob = static_cast<QT*>(a.out) + row0 * a.dv;
    for (int i = tid; i < g * a.dv; i += kThreads)
      ob[i] = attn::out_cast<QT>(acc[i] / fmaxf(l_s[i / a.dv], 1e-30f));
    return;
  }
  const int ld = a.dv + 2;
  for (int i = tid; i < g * (a.dv + 2); i += kThreads) {
    const int gi = i / ld;
    const int e = i - gi * ld;
    const float x = e < a.dv ? acc[gi * a.dv + e]
                             : e == a.dv ? m_s[gi] : l_s[gi];
    a.part[((row0 + gi) * a.n_split + split) * ld + e] = x;
  }
}

template <typename OT>
__global__ void __launch_bounds__(attn::kCombineThreads)
    paged_kernel_combine(const float* __restrict__ part, OT* __restrict__ out,
                         int n_split, int dv) {
  attn::combine_row<OT>(part, out, n_split, dv);
}

template <typename QT, typename KT>
cudaError_t launch(const Params& a, int B, size_t smem, cudaStream_t stream) {
  auto kern = paged_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = static_cast<long long>(B) * a.Hkv * a.n_split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  paged_kernel_combine<QT><<<B * a.H, attn::kCombineThreads,
                             a.n_split * sizeof(float), stream>>>(
      a.part, static_cast<QT*>(a.out), a.n_split, a.dv);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const Params& a, int B, size_t smem,
                      cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch<QT, float>(a, B, smem, s);
    case kBF16: return launch<QT, __nv_bfloat16>(a, B, smem, s);
    case kI8: return launch<QT, int8_t>(a, B, smem, s);
    case kFP8: return launch<QT, __nv_fp8_e4m3>(a, B, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

int elem_size(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1;
}

}  // namespace

// Shared memory the split kernel needs for these shapes (bytes), with
// `ppt` pages staged a step.
extern "C" long long paged_attention_smem(int H, int Hkv, int dk, int dv,
                                          int dr, int page, int P, int ppt,
                                          int q_dtype, int kv_dtype) {
  return layout(H / Hkv, dk, dv, dr, ppt * page, P, elem_size(kv_dtype),
                elem_size(q_dtype)).total;
}

// Launches on `stream` (the split kernel, then the combine when n_split
// > 1; `part` holds B * H * n_split * (dv + 2) floats then); returns
// cudaGetLastError() (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const int* table,
    const int* lens, const float* k_scale, const float* v_scale,
    const void* k_extra, void* out, float* part, int B, int H, int Hkv,
    int dk, int dv, int dr, int n_pages, int page, int P, int window,
    int ppt, int n_split, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (ppt < 1 || n_split < 1 ||
      n_split > attn::kCombineMaxSplit || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kvs = elem_size(kv_dtype), qs = elem_size(q_dtype);
  Params a{q, k, v, table, lens, k_scale, v_scale, k_extra, out, part,
           H, Hkv, dk, dv, dr, n_pages, page, P, window, ppt, n_split,
           0, 0, scale};
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_kv = al(k) && al(v) && (dk * kvs) % 16 == 0 && (dv * kvs) % 16 == 0;
  a.vec_ke = dr > 0 && al(k_extra) && (dr * qs) % 16 == 0;
  const size_t smem = static_cast<size_t>(paged_attention_smem(
      H, Hkv, dk, dv, dr, page, P, ppt, q_dtype, kv_dtype));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == kF32) {
    e = launch_kv<float>(kv_dtype, a, B, smem, s);
  } else if (q_dtype == kBF16) {
    e = launch_kv<__nv_bfloat16>(kv_dtype, a, B, smem, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
