// Per-client squared norms, and the fused norm + Eq. 2 aggregate, with and
// without in-stream compression, on Hopper.
//
// Replaces three TPU kernels:
// * repro/kernels/client_norm.py::client_sqnorms_pallas — (C, D) -> (C,)
//   sum_d U[i, d]^2 (client_sqnorms_*);
// * repro/kernels/norm_aggregate.py::norm_scale_aggregate_pallas — both the
//   (C,) squared norms and the (D,) aggregate sum_i scale[i] U[i, :] from one
//   read of U (norm_scale_aggregate_*);
// * repro/kernels/norm_aggregate.py::compress_norm_scale_aggregate_pallas —
//   the same, on C(U): apply_compression_flat runs on each tile from the raw
//   values and their material, casts through the transport dtype, and both
//   reductions take the compressed tile; C(U) is never written
//   (compress_norm_scale_aggregate_*).
// The TPU kernels walk D in order on one core and carry the norm in VMEM
// across grid steps; here CTAs run in parallel, so the norm is a two-stage
// reduction (see ocs_tile.cuh) and the aggregate has one owning thread per
// column, as in masked_aggregate.cu.
//
// Bound on an H100 SXM: device memory.  Each kernel reads U once (plus its
// material) and writes (C,) and (D,) floats, against 2-5 flops per element:
// at the scan engine's (4, 58430) f32 group that is ~1.2 MB (0.35 us at
// 3.35 TB/s), below a launch's latency, so what counts is the number of
// launches and of memory latencies in series.  Hence the fused kernel:
// * one launch: each CTA writes its norm partials, takes a ticket on a
//   counter, and the CTA that draws the last ticket sums every client's
//   partials in finish_sqnorms's order (ocs::warp_finish_sqnorms) and resets
//   the counter to 0 for the next launch; atomics touch the counter only;
// * a client register block: a thread issues the loads of kBlock = 8
//   clients (U and material) before it compresses or folds any of them, so
//   their memory latencies overlap; their warp shuffle trees are
//   interleaved.  On the H100, 8 was the best of 4, 8 and 16 at the paths'
//   shapes or within 0.6 us of it (tools/bench_norm_kernels.py --blocks),
//   and kernel 1's 32 was slower at the scan engine's 4 clients;
// * the caller's unpadded (C, D) matrices: a thread owns 4 adjacent columns
//   and reads them with the widest load (V elements) that every matrix's
//   base address and row stride allow; columns past D count as 0.0, as
//   zero padding did (zero values with zero material compress to +0 for
//   every kind).
// The fold (clients i = 0..C-1 in order, ocs::agg_step) and the partial
// layout (one per client per 128 columns) are those of the padded launch, so
// the aggregate is bitwise masked_aggregate.cu's and the norms bitwise
// client_sqnorms's and sharded_aggregate.cu's.
//
// client_sqnorms keeps its two launches (tile_kernel, finish_sqnorms) on a
// padded matrix.
//
// Contract (checked by the Python wrapper): every matrix is contiguous
// (C, D); for the fused kernel any D >= 1 and element-aligned rows, with
// V | D and V-element-aligned bases; for client_sqnorms D % kCols == 0 and
// rows aligned to the vector load.  scale is (C,) f32, partials is
// (C, tile_blocks(D) * kWarps) f32 scratch, the ticket one int32 that is 0
// before the launch (and after it), owned by the launch's stream,
// C <= 12288.

#include "ocs_tile.cuh"

namespace {

using namespace ocs;

// The thread's 4 columns (col..col+3) of one row at p (the row's column
// col), zeros past d.  V elements per load; V divides d, so a load lies
// wholly inside the row or wholly past it.
template <int V>
__device__ __forceinline__ float4 load_row(const float* p, long long col, int d) {
  if constexpr (V == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
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
}

template <int V>
__device__ __forceinline__ float4 load_row(const __nv_bfloat16* p, long long col, int d) {
  if constexpr (V == 4) {
    return load_cols(p);
  } else {
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
}

// client_sqnorms's pass: one CTA per tile of kThreads * kCols columns; for
// each client in order, the thread's squared columns, the warp's partial.
// Out-of-range threads take zeros, so every lane joins the shuffle.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ u, float* __restrict__ partials, int c, int d) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool live = col < d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  for (int i = 0; i < c; ++i) {
    const float4 x = live ? load_cols(u + static_cast<long long>(i) * d + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float p = warp_sum(col_sqnorm(x));
    if (lane == 0) {
      partials[static_cast<long long>(i) * parts + blockIdx.x * kWarps + warp] = p;
    }
  }
}

// The fused kernel: one CTA per tile of kThreads * kCols columns, the last
// one partly past d.  Per block of clients: load (U and material), compress,
// fold into the aggregate and emit each client's warp partial; then the
// ticket, and the last CTA's finish of every client's norm.
template <typename T, int Kind, int V>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ u, const float* __restrict__ scale,
             const float* __restrict__ m0, const float* __restrict__ m1,
             float* __restrict__ partials, float* __restrict__ sq,
             float* __restrict__ agg, unsigned int* __restrict__ ticket, int c,
             int d, float levels, float inv_levels) {
  constexpr int kBlock = 8;           // clients whose loads a thread keeps in flight
  constexpr int kFinishClients = 4;   // clients a warp finishes at once
  constexpr int kFinishRows = 4;      // rows of kThreads partials per load round
  extern __shared__ float s_scale[];
  __shared__ bool s_last;
  for (int i = threadIdx.x; i < c; i += kThreads) s_scale[i] = scale[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool live = col < d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  for (int i0 = 0; i0 < c; i0 += kBlock) {
    float4 x[kBlock], a[kBlock], b[kBlock];
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      x[j] = zero;
      a[j] = zero;
      b[j] = zero;
      if (live && i0 + j < c) {
        const long long off = static_cast<long long>(i0 + j) * d + col;
        x[j] = load_row<V>(u + off, col, d);
        if (Kind != kNone) a[j] = load_row<V>(m0 + off, col, d);
        if (Kind == kQsgd) b[j] = load_row<V>(m1 + off, col, d);
      }
    }
    float p[kBlock];
#pragma unroll
    for (int j = 0; j < kBlock; ++j) {
      if (live && i0 + j < c) {
        x[j] = compress4<Kind>(x[j], a[j], b[j], levels, inv_levels, u);
        agg_step(acc, s_scale[i0 + j], x[j]);
      }
      p[j] = col_sqnorm(x[j]);
    }
    // kBlock independent warp_sum trees, step by step
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        if (i0 + j < c) p[j] = __fadd_rn(p[j], __shfl_xor_sync(0xffffffffu, p[j], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kBlock; ++j) {
        if (i0 + j < c) {
          partials[static_cast<long long>(i0 + j) * parts + blockIdx.x * kWarps + warp] = p[j];
        }
      }
    }
  }
  if (live) {
    if (col + kCols <= d) {
      *reinterpret_cast<float4*>(agg + col) = acc;
    } else {
      const float v[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int k = 0; col + k < d; ++k) agg[col + k] = v[k];
    }
  }

  // the partials out, then a ticket; the CTA that draws the last one sums
  // them (reading through L2) and leaves the counter at 0
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // warp w finishes clients w, w + kWarps, ..., kFinishClients at a time
  for (int i0 = warp; i0 < c; i0 += kWarps * kFinishClients) {
    float s[kFinishClients];
    warp_finish_sqnorms<kFinishClients, kFinishRows>(
        s, partials + static_cast<long long>(i0) * parts,
        static_cast<long long>(kWarps) * parts, parts, (c - i0 + kWarps - 1) / kWarps, lane);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kFinishClients; ++k) {
        if (i0 + k * kWarps < c) sq[i0 + k * kWarps] = s[k];
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
int launch_sqnorms(const void* u, void* partials, void* sq, int c, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = tile_blocks(d);
  tile_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(u),
                                            static_cast<float*>(partials), c, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_sqnorms<<<c, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                        static_cast<float*>(sq), blocks * kWarps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Kind, int V>
int launch_fused(const void* u, const void* scale, const void* m0, const void* m1,
                 void* partials, void* sq, void* agg, void* ticket, int c, int d,
                 float levels, float inv_levels, cudaStream_t s) {
  fused_kernel<T, Kind, V><<<tile_blocks(d), kThreads, c * sizeof(float), s>>>(
      static_cast<const T*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(m0), static_cast<const float*>(m1),
      static_cast<float*>(partials), static_cast<float*>(sq), static_cast<float*>(agg),
      static_cast<unsigned int*>(ticket), c, d, levels, inv_levels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Kind>
int launch_vec(const void* u, const void* scale, const void* m0, const void* m1,
               void* partials, void* sq, void* agg, void* ticket, int c, int d,
               int vec, float levels, float inv_levels, cudaStream_t s) {
  switch (vec) {
    case 4:
      return launch_fused<T, Kind, 4>(u, scale, m0, m1, partials, sq, agg, ticket, c, d,
                                      levels, inv_levels, s);
    case 2:
      return launch_fused<T, Kind, 2>(u, scale, m0, m1, partials, sq, agg, ticket, c, d,
                                      levels, inv_levels, s);
    case 1:
      return launch_fused<T, Kind, 1>(u, scale, m0, m1, partials, sq, agg, ticket, c, d,
                                      levels, inv_levels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_kind(const void* u, const void* scale, const void* m0, const void* m1,
                void* partials, void* sq, void* agg, void* ticket, int c, int d,
                int vec, int kind, float levels, float inv_levels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kNone:
      return launch_vec<T, kNone>(u, scale, m0, m1, partials, sq, agg, ticket, c, d, vec,
                                  levels, inv_levels, s);
    case kRandK:
      return launch_vec<T, kRandK>(u, scale, m0, m1, partials, sq, agg, ticket, c, d, vec,
                                   levels, inv_levels, s);
    case kQsgd:
      return launch_vec<T, kQsgd>(u, scale, m0, m1, partials, sq, agg, ticket, c, d, vec,
                                  levels, inv_levels, s);
    case kNatural:
      return launch_vec<T, kNatural>(u, scale, m0, m1, partials, sq, agg, ticket, c, d,
                                     vec, levels, inv_levels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int client_sqnorms_f32(const void* u, void* partials, void* sq,
                                  int c, int d, void* stream) {
  return launch_sqnorms<float>(u, partials, sq, c, d, stream);
}

extern "C" int client_sqnorms_bf16(const void* u, void* partials, void* sq,
                                   int c, int d, void* stream) {
  return launch_sqnorms<__nv_bfloat16>(u, partials, sq, c, d, stream);
}

extern "C" int norm_scale_aggregate_f32(const void* u, const void* scale,
                                        void* partials, void* sq, void* agg,
                                        void* ticket, int c, int d, int vec,
                                        void* stream) {
  return launch_kind<float>(u, scale, nullptr, nullptr, partials, sq, agg, ticket, c, d,
                            vec, ocs::kNone, 0.f, 0.f, stream);
}

extern "C" int norm_scale_aggregate_bf16(const void* u, const void* scale,
                                         void* partials, void* sq, void* agg,
                                         void* ticket, int c, int d, int vec,
                                         void* stream) {
  return launch_kind<__nv_bfloat16>(u, scale, nullptr, nullptr, partials, sq, agg, ticket,
                                    c, d, vec, ocs::kNone, 0.f, 0.f, stream);
}

extern "C" int compress_norm_scale_aggregate_f32(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* agg, void* ticket, int c, int d, int vec,
    int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<float>(u, scale, m0, m1, partials, sq, agg, ticket, c, d, vec, kind,
                            levels, inv_levels, stream);
}

extern "C" int compress_norm_scale_aggregate_bf16(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* agg, void* ticket, int c, int d, int vec,
    int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<__nv_bfloat16>(u, scale, m0, m1, partials, sq, agg, ticket, c, d,
                                    vec, kind, levels, inv_levels, stream);
}
