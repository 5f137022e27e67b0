// Tile layout, reductions and the in-stream compressor shared by the port's
// client-matrix kernels (masked_aggregate.cu, norm_aggregate.cu,
// sharded_aggregate.cu).
//
// Layout: U is a contiguous client-major (C, D) matrix.  A CTA of kThreads
// threads covers kThreads * kCols adjacent columns (the tile); each thread owns
// kCols of them and reads one 16-byte (f32) or 8-byte (bf16) vector per
// client (norm_aggregate.cu's fused kernel: narrower vectors where the rows'
// alignment asks, and zeros past D).  The grid is 1-D over D.
//
// Reductions, both with a fixed order and no atomics on values:
// * aggregate (over C): the column's owning thread sums the clients in order
//   i = 0..C-1 with fmaf into an f32 register (agg_step), so every kernel
//   that uses it gives bitwise the same aggregate for the same tile values;
//   fold_clients runs that fold with the loads of kClientBlock clients in
//   registers before any of them is folded;
// * squared norm (over D, so across CTAs): each thread squares its kCols
//   values (col_sqnorm), a warp sums its 32 threads with a shuffle tree
//   (warp_sum), lane 0 writes one partial per (client, CTA, warp), and each
//   client's partials are summed in one fixed order: by a second kernel
//   (finish_sqnorms), or inside the same launch by the CTA that finishes
//   last (warp_finish_sqnorms, the same order in one warp).  Every
//   norm-emitting kernel uses these same stages, so the norms agree bitwise
//   between kernels for the same tile values.
//
// The compressor (compress4) is core/compression.py::apply_compression_flat
// op for op.  Its arithmetic is written with __fmul_rn / __fdiv_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA, and uses
// floorf / log2f / exp2f from the CUDA math library (built without
// --use_fast_math), the same functions torch's eager CUDA kernels call; a
// division by a Python scalar is, in torch's CUDA kernels, a multiplication
// by its float reciprocal, which the compressor repeats.  So C(U) in the
// kernel is bitwise what the eager torch version gives on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ocs {

constexpr int kThreads = 128;
constexpr int kCols = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kClientBlock = 32;   // clients whose loads fold_clients keeps in flight

// compressor kinds, as passed through the C interface
constexpr int kNone = 0;
constexpr int kRandK = 1;
constexpr int kQsgd = 2;
constexpr int kNatural = 3;

__device__ __forceinline__ float4 load_cols(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_cols(const __nv_bfloat16* p) {
  union {
    uint2 raw;
    __nv_bfloat162 pair[2];
  } v;
  v.raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(v.pair[0]);
  const float2 b = __bfloat1622float2(v.pair[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc += s * x, column by column, one fmaf each
__device__ __forceinline__ void agg_step(float4& acc, float s, const float4& x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// acc += scale[i] * U[i, cols] for i = 0..c-1 in order (agg_step), where p
// points at client 0's columns and `stride` is the client stride.  The loads
// of a block of kClientBlock clients are issued into registers before any of
// them is folded, so the block's memory latencies overlap (one latency for
// the main path's 32 clients, where an unroll of 8 waited four times).
template <typename T>
__device__ __forceinline__ void fold_clients(float4& acc, const T* p, long long stride,
                                             const float* scale, int c) {
  for (int i0 = 0; i0 < c; i0 += kClientBlock) {
    float4 x[kClientBlock];
#pragma unroll
    for (int j = 0; j < kClientBlock; ++j) {
      if (i0 + j < c) x[j] = load_cols(p + static_cast<long long>(i0 + j) * stride);
    }
#pragma unroll
    for (int j = 0; j < kClientBlock; ++j) {
      if (i0 + j < c) agg_step(acc, scale[i0 + j], x[j]);
    }
  }
}

// the thread's share of one client's squared norm
__device__ __forceinline__ float col_sqnorm(const float4& x) {
  float p = __fmul_rn(x.x, x.x);
  p = fmaf(x.y, x.y, p);
  p = fmaf(x.z, x.z, p);
  return fmaf(x.w, x.w, p);
}

// sum over the warp's 32 lanes by a fixed shuffle tree; every lane gets it
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// the round trip through the transport dtype
__device__ __forceinline__ float to_transport(float v, const float*) { return v; }
__device__ __forceinline__ float to_transport(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.sign: (0 < a) - (a < 0)
__device__ __forceinline__ float sign_of(float a) {
  return static_cast<float>((0.f < a) - (a < 0.f));
}

// apply_compression_flat for one element; m0/m1 are its material values
template <int Kind>
__device__ __forceinline__ float compress1(float x, float m0, float m1,
                                           float levels, float inv_levels) {
  if (Kind == kRandK) {
    return __fmul_rn(x, m0);                          // xf * gain
  } else if (Kind == kQsgd) {
    const float u = m0, nrm = m1;
    // where(nrm > 0, |x| / clamp(nrm, 1e-30) * levels, 0)
    const float scaled =
        nrm > 0.f ? __fmul_rn(__fdiv_rn(fabsf(x), fmaxf(nrm, 1e-30f)), levels)
                  : 0.f;
    const float low = floorf(scaled);
    const float q = __fadd_rn(low, u < __fsub_rn(scaled, low) ? 1.f : 0.f);
    // sign(x) * q * nrm / levels
    return __fmul_rn(__fmul_rn(__fmul_rn(sign_of(x), q), nrm), inv_levels);
  } else if (Kind == kNatural) {
    const float u = m0;
    const float tiny = 1.17549435082228750797e-38f;   // 2**-126
    const float mag = fabsf(x);
    const bool sub = mag < tiny;
    const float low = sub ? 0.f : exp2f(floorf(log2f(fmaxf(mag, tiny))));
    const float hi = sub ? tiny : __fmul_rn(2.f, low);
    // mag / tiny: torch multiplies by the exact reciprocal 2**126
    const float prob = sub ? __fmul_rn(mag, 8.50705917302346158658e+37f)
                           : __fsub_rn(__fdiv_rn(mag, fmaxf(low, tiny)), 1.f);
    return __fmul_rn(sign_of(x), u < prob ? hi : low);
  }
  return x;
}

template <int Kind, typename T>
__device__ __forceinline__ float4 compress4(const float4& x, const float4& m0,
                                            const float4& m1, float levels,
                                            float inv_levels, const T* tag) {
  if (Kind == kNone) return x;
  return make_float4(
      to_transport(compress1<Kind>(x.x, m0.x, m1.x, levels, inv_levels), tag),
      to_transport(compress1<Kind>(x.y, m0.y, m1.y, levels, inv_levels), tag),
      to_transport(compress1<Kind>(x.z, m0.z, m1.z, levels, inv_levels), tag),
      to_transport(compress1<Kind>(x.w, m0.w, m1.w, levels, inv_levels), tag));
}

// Sum each client's `parts` partials in a fixed order: one CTA per client;
// thread t sums partials t, t + kThreads, ... in turn, then a shared-memory
// tree of kThreads.  No atomics.
__global__ void __launch_bounds__(kThreads)
finish_sqnorms(const float* __restrict__ partials, float* __restrict__ out,
               int parts) {
  __shared__ float s[kThreads];
  const float* p = partials + static_cast<long long>(blockIdx.x) * parts;
  float v = 0.f;
  for (int j = threadIdx.x; j < parts; j += kThreads) v = __fadd_rn(v, p[j]);
  s[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

// One client's finish_sqnorms in one warp, for the in-launch finish.  Lane l
// stands for finish_sqnorms's threads l + 32 q (q = 0..3): it sums partials
// l + 32 q + kThreads j for j = 0, 1, ... in turn, as those threads do;
// (q0 + q2) + (q1 + q3) is that tree's steps 64 and 32, and warp_sum's
// steps 16..1 leave its s[0] in lane 0.  kClients clients (client k's
// partials at p + k * stride) at once, kRows rows of kThreads partials each,
// so that many loads are in flight; the loads go through L2 (__ldcg), since
// other CTAs of the launch wrote the partials.  Lane 0 holds the sums; the
// first `n` clients are live.
template <int kClients, int kRows>
__device__ __forceinline__ void warp_finish_sqnorms(float (&out)[kClients], const float* p,
                                                    long long stride, int parts, int n,
                                                    int lane) {
  float v[kClients][4];
#pragma unroll
  for (int k = 0; k < kClients; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[k][q] = 0.f;
  }
  for (int j0 = 0; j0 < parts; j0 += kRows * kThreads) {
    float w[kClients][kRows][4];
#pragma unroll
    for (int k = 0; k < kClients; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + r * kThreads + q * 32 + lane;
          w[k][r][q] = k < n && j < parts
                           ? __ldcg(p + k * stride + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kClients; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j0 + r * kThreads + q * 32 + lane < parts) v[k][q] = __fadd_rn(v[k][q], w[k][r][q]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kClients; ++k) {
    out[k] = __fadd_rn(__fadd_rn(v[k][0], v[k][2]), __fadd_rn(v[k][1], v[k][3]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kClients; ++k) {
      out[k] = __fadd_rn(out[k], __shfl_xor_sync(0xffffffffu, out[k], off));
    }
  }
}

// CTAs of a tile launch over d columns; the last one may be partly past d
inline int tile_blocks(int d) { return (d + kThreads * kCols - 1) / (kThreads * kCols); }

}  // namespace ocs
