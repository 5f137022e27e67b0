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
// material) and writes (C,) and (D,) floats, against 2-4 flops per element:
// at the scan engine's (4, 58880) f32 group that is ~1.2 MB (0.35 us at
// 3.35 TB/s), below a launch's latency, so a launch costs what launching
// costs.  The design keeps one read of each input, no intermediate in device
// memory, and no atomics on values, and stays simple.
//
// Contract (checked by the Python wrapper): every matrix is contiguous
// (C, D) with D % kCols == 0 and 16-byte-aligned rows of material (8-byte for
// bf16 U), scale is (C,) f32, partials is (C, tile_blocks(D) * kWarps) f32
// scratch, C <= 12288.  ops.py pads D with zeros to a multiple of the tile.

#include "ocs_tile.cuh"

namespace {

using namespace ocs;

// One CTA per tile of kThreads * kCols columns.  For each client in order: load (and compress)
// the thread's columns, fold them into the aggregate (if kAgg), and emit the
// warp's squared-norm partial.  Out-of-range threads take zeros, so every
// lane joins the shuffle.
template <typename T, int Kind, bool kAgg>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ u, const float* __restrict__ scale,
            const float* __restrict__ m0, const float* __restrict__ m1,
            float* __restrict__ partials, float* __restrict__ agg, int c, int d,
            float levels, float inv_levels) {
  extern __shared__ float s_scale[];
  if (kAgg) {
    for (int i = threadIdx.x; i < c; i += kThreads) s_scale[i] = scale[i];
    __syncthreads();
  }
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool live = col < d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  for (int i = 0; i < c; ++i) {
    const long long off = static_cast<long long>(i) * d + col;
    float4 x = zero;
    if (live) {
      x = load_cols(u + off);
      if (Kind != kNone) {
        const float4 a = load_cols(m0 + off);
        const float4 b = Kind == kQsgd ? load_cols(m1 + off) : zero;
        x = compress4<Kind>(x, a, b, levels, inv_levels, u);
      }
      if (kAgg) agg_step(acc, s_scale[i], x);
    }
    const float p = warp_sum(col_sqnorm(x));
    if (lane == 0) {
      partials[static_cast<long long>(i) * parts + blockIdx.x * kWarps + warp] = p;
    }
  }
  if (kAgg && live) *reinterpret_cast<float4*>(agg + col) = acc;
}

template <typename T, int Kind, bool kAgg>
int launch(const void* u, const void* scale, const void* m0, const void* m1,
           void* partials, void* sq, void* agg, int c, int d, float levels,
           float inv_levels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = tile_blocks(d);
  tile_kernel<T, Kind, kAgg><<<blocks, kThreads, kAgg ? c * sizeof(float) : 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(m0), static_cast<const float*>(m1),
      static_cast<float*>(partials), static_cast<float*>(agg), c, d, levels,
      inv_levels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_sqnorms<<<c, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                        static_cast<float*>(sq), blocks * kWarps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(const void* u, const void* scale, const void* m0,
                const void* m1, void* partials, void* sq, void* agg, int c,
                int d, int kind, float levels, float inv_levels, void* stream) {
  switch (kind) {
    case kNone:
      return launch<T, kNone, true>(u, scale, m0, m1, partials, sq, agg, c, d,
                                    levels, inv_levels, stream);
    case kRandK:
      return launch<T, kRandK, true>(u, scale, m0, m1, partials, sq, agg, c, d,
                                     levels, inv_levels, stream);
    case kQsgd:
      return launch<T, kQsgd, true>(u, scale, m0, m1, partials, sq, agg, c, d,
                                    levels, inv_levels, stream);
    case kNatural:
      return launch<T, kNatural, true>(u, scale, m0, m1, partials, sq, agg, c,
                                       d, levels, inv_levels, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int client_sqnorms_f32(const void* u, void* partials, void* sq,
                                  int c, int d, void* stream) {
  return launch<float, ocs::kNone, false>(u, nullptr, nullptr, nullptr, partials,
                                     sq, nullptr, c, d, 0.f, 0.f, stream);
}

extern "C" int client_sqnorms_bf16(const void* u, void* partials, void* sq,
                                   int c, int d, void* stream) {
  return launch<__nv_bfloat16, ocs::kNone, false>(u, nullptr, nullptr, nullptr,
                                             partials, sq, nullptr, c, d, 0.f,
                                             0.f, stream);
}

extern "C" int norm_scale_aggregate_f32(const void* u, const void* scale,
                                        void* partials, void* sq, void* agg,
                                        int c, int d, void* stream) {
  return launch<float, ocs::kNone, true>(u, scale, nullptr, nullptr, partials, sq,
                                    agg, c, d, 0.f, 0.f, stream);
}

extern "C" int norm_scale_aggregate_bf16(const void* u, const void* scale,
                                         void* partials, void* sq, void* agg,
                                         int c, int d, void* stream) {
  return launch<__nv_bfloat16, ocs::kNone, true>(u, scale, nullptr, nullptr,
                                            partials, sq, agg, c, d, 0.f, 0.f,
                                            stream);
}

extern "C" int compress_norm_scale_aggregate_f32(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* agg, int c, int d, int kind, float levels,
    float inv_levels, void* stream) {
  return launch_kind<float>(u, scale, m0, m1, partials, sq, agg, c, d, kind,
                            levels, inv_levels, stream);
}

extern "C" int compress_norm_scale_aggregate_bf16(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* agg, int c, int d, int kind, float levels,
    float inv_levels, void* stream) {
  return launch_kind<__nv_bfloat16>(u, scale, m0, m1, partials, sq, agg, c, d,
                                    kind, levels, inv_levels, stream);
}
