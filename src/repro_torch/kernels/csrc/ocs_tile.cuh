// Tile layout, reductions and the in-stream compressor shared by the port's
// client-matrix kernels (masked_aggregate.cu, norm_aggregate.cu,
// sharded_aggregate.cu).
//
// Layout: U is a contiguous client-major (C, D) matrix.  A CTA of kThreads
// threads covers kThreads * kCols adjacent columns (the tile); each thread owns
// kCols of them and reads one 16-byte (f32) or 8-byte (bf16) vector per
// client (load_row: narrower vectors where the rows' alignment asks, and
// zeros past D).  The grid's x axis runs over D.
//
// Reductions, both with a fixed order and no atomics on values:
// * aggregate (over C): the column's owning thread sums the clients in order
//   i = 0..C-1 with fmaf into an f32 register (agg_step), so every kernel
//   that uses it gives bitwise the same aggregate for the same tile values;
//   fold_clients runs that fold with the loads of kClientBlock clients in
//   registers before any of them is folded, block_step with those of a
//   smaller block of clients, their material, and their norm partials;
// * squared norm (over D, so across CTAs): each thread squares its kCols
//   values (col_sqnorm), a warp sums its 32 threads with a shuffle tree
//   (warp_sum), lane 0 writes one partial per (client, CTA, warp), and each
//   client's partials are summed in one fixed order inside the same launch
//   by the CTA that draws the last ticket (last_ticket, cta_finish_sqnorms).
//   The order is that of the earlier second launch, which gave a client one
//   CTA of kThreads threads: thread t summed partials t, t + kThreads, ...
//   in turn, then a shared-memory tree over the kThreads threads
//   (warp_finish_sqnorms repeats it in one warp).  Every norm-emitting
//   kernel uses these same stages, so the norms agree bitwise between
//   kernels for the same tile values.
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

// One client's norm in one warp, in the order of the header's kThreads-thread
// finish.  Lane l stands for its threads l + 32 q (q = 0..3): it sums
// partials l + 32 q + kThreads j for j = 0, 1, ... in turn, as those threads
// did; (q0 + q2) + (q1 + q3) is that tree's steps 64 and 32, and warp_sum's
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

// The thread's 4 columns (col..col+3) of one row at p (the row's column
// col), zeros past d.  V (2 or 1) elements per load; V divides d, so a load
// lies wholly inside the row or wholly past it.  (16-byte loads of 4 f32
// elements ran slower in block_step's kernels on the H100 than two 8-byte
// ones, at 32 and at 1,024 clients; the wrappers do not offer them.)
template <int V>
__device__ __forceinline__ float4 load_row(const float* p, long long col, int d) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; k += V) {
    if constexpr (V == 2) {
      const float2 t = col + k < d ? *reinterpret_cast<const float2*>(p + k)
                                   : make_float2(0.f, 0.f);
      v[k] = t.x;
      v[k + 1] = t.y;
    } else {
      v[k] = col + k < d ? p[k] : 0.f;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int V>
__device__ __forceinline__ float4 load_row(const __nv_bfloat16* p, long long col, int d) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; k += V) {
    if constexpr (V == 2) {
      const float2 t =
          col + k < d ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + k))
                      : make_float2(0.f, 0.f);
      v[k] = t.x;
      v[k + 1] = t.y;
    } else {
      v[k] = col + k < d ? __bfloat162float(p[k]) : 0.f;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// out[col..col+3] = acc, cut at d (out is a 16-byte aligned (d,) vector)
__device__ __forceinline__ void store_row(float* out, const float4& acc, long long col, int d) {
  if (col + kCols <= d) {
    *reinterpret_cast<float4*>(out + col) = acc;
  } else {
    const float v[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int k = 0; col + k < d; ++k) out[col + k] = v[k];
  }
}

// One register block of the client axis: the loads of up to kBlock clients
// (rows j = 0..n-1 at element offset off + j * d of U and of the kind's
// material) are issued before any of them is compressed; then, client by
// client in order, compress4 and, with kFold, agg_step into acc with
// scale[j]; the kBlock warp_sum trees run interleaved, step by step, and
// lane 0 writes client j's partial to part[j * parts].  Lanes past d take
// zeros, so every lane joins the shuffles.
template <int Kind, int V, int kBlock, bool kFold, typename T>
__device__ __forceinline__ void block_step(float4& acc, const T* __restrict__ u,
                                           const float* __restrict__ m0,
                                           const float* __restrict__ m1, long long off,
                                           int n, long long col, int d, bool live,
                                           const float* scale, float* part, long long parts,
                                           int lane, float levels, float inv_levels) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x[kBlock], a[kBlock], b[kBlock];
#pragma unroll
  for (int j = 0; j < kBlock; ++j) {
    x[j] = zero;
    a[j] = zero;
    b[j] = zero;
    if (live && j < n) {
      const long long o = off + static_cast<long long>(j) * d;
      x[j] = load_row<V>(u + o, col, d);
      if constexpr (Kind != kNone) a[j] = load_row<V>(m0 + o, col, d);
      if constexpr (Kind == kQsgd) b[j] = load_row<V>(m1 + o, col, d);
    }
  }
  float p[kBlock];
#pragma unroll
  for (int j = 0; j < kBlock; ++j) {
    if (live && j < n) {
      x[j] = compress4<Kind>(x[j], a[j], b[j], levels, inv_levels, u);
      if constexpr (kFold) agg_step(acc, scale[j], x[j]);
    }
    p[j] = col_sqnorm(x[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      if (j < n) p[j] = __fadd_rn(p[j], __shfl_xor_sync(0xffffffffu, p[j], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      if (j < n) part[static_cast<long long>(j) * parts] = p[j];
    }
  }
}

// After the CTA's writes, a ticket on *counter (the only atomic, and on a
// counter, not a value): true in every thread of the CTA that draws the
// last of `total`, which may then read, through L2 (__ldcg), what the other
// CTAs of the count wrote before theirs.  Called by every thread.
__device__ __forceinline__ bool last_ticket(unsigned int* counter, unsigned int total) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == total - 1;
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  return last;
}

// Clients 0..c-1's norms from their partials (client i's `parts` partials
// at p + i * parts) into sq: warp w finishes clients w, w + kWarps, ...,
// kFinishClients at a time (warp_finish_sqnorms, kFinishRows rows of
// kThreads partials per load round); lane 0 writes.
__device__ __forceinline__ void cta_finish_sqnorms(const float* p, float* sq, int c, int parts,
                                                   int warp, int lane) {
  constexpr int kFinishClients = 4;
  constexpr int kFinishRows = 4;
  for (int i0 = warp; i0 < c; i0 += kWarps * kFinishClients) {
    float s[kFinishClients];
    warp_finish_sqnorms<kFinishClients, kFinishRows>(
        s, p + static_cast<long long>(i0) * parts, static_cast<long long>(kWarps) * parts,
        parts, (c - i0 + kWarps - 1) / kWarps, lane);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kFinishClients; ++k) {
        if (i0 + k * kWarps < c) sq[i0 + k * kWarps] = s[k];
      }
    }
  }
}

// CTAs of a tile launch over d columns; the last one may be partly past d
inline int tile_blocks(int d) { return (d + kThreads * kCols - 1) / (kThreads * kCols); }

}  // namespace ocs
