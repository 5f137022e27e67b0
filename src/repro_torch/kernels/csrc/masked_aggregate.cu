// Eq. 2 masked aggregate on Hopper: out[d] = sum_i scale[i] * U[i, d].
//
// Replaces the TPU kernel repro/kernels/masked_aggregate.py::
// masked_scale_aggregate_pallas (a grid over 4096-wide chunks, each a
// (C,) x (C, chunk) dot_general on the MXU).  `scale` already folds the
// Bernoulli mask and the w_i / p_i reweighting (zero for unsampled clients),
// so this one contraction is the whole unbiased OCS aggregate.
//
// Bound on an H100 SXM: device memory.  The kernel reads C*D elements of U
// and C + D floats more, and does 2*C*D flops: at the main path's
// (32, 58430) f32 that is 7.7 MB, 2.3 us at 3.35 TB/s, against 0.06 us of
// f32 arithmetic at 67 TFLOP/s.  At that size a launch costs more than the
// bytes, so the kernel's time is launch latency; the design keeps one read of
// U and no scaled (C, D) intermediate, and stays simple.
//
// Design: a 1-D grid over D, in the tile layout of ocs_tile.cuh.  Each thread
// owns kCols adjacent columns (one 16-byte load of f32, or 8 bytes of bf16,
// per client), loops over the clients i = 0..C-1 in order and accumulates in
// f32 registers (ocs::agg_step, shared with norm_aggregate.cu, whose
// aggregate is therefore bitwise this one); scale is staged once per block in
// shared memory.  Every output element is written by
// exactly one thread, with no atomics and a fixed summation order, so the
// result is deterministic run to run — the reference's bitwise contracts
// (resume, cross-mode parity) need that from every kernel feeding params.
//
// Contract (checked by the Python wrapper): U is contiguous (C, D) with
// D % kCols == 0 and a row start aligned to the vector load, scale is (C,)
// f32, out is (D,) f32, C <= 12288 (48 KB of shared memory).  The wrapper in
// ops.py pads D with zero columns to a multiple of the block's tile.

#include "ocs_tile.cuh"

namespace {

using ocs::kCols;
using ocs::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_scale_aggregate_kernel(const T* __restrict__ u,
                              const float* __restrict__ scale,
                              float* __restrict__ out, int c, int d) {
  extern __shared__ float s_scale[];
  for (int i = threadIdx.x; i < c; i += kThreads) s_scale[i] = scale[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (col >= d) return;
  const T* p = u + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < c; ++i) {
    const float s = s_scale[i];
    ocs::agg_step(acc, s, ocs::load_cols(p + static_cast<long long>(i) * d));
  }
  *reinterpret_cast<float4*>(out + col) = acc;
}

template <typename T>
int launch(const void* u, const void* scale, void* out, int c, int d,
           void* stream) {
  const int blocks = ocs::tile_blocks(d);
  masked_scale_aggregate_kernel<T>
      <<<blocks, kThreads, c * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const float*>(scale),
          static_cast<float*>(out), c, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_scale_aggregate_f32(const void* u, const void* scale,
                                          void* out, int c, int d,
                                          void* stream) {
  return launch<float>(u, scale, out, c, d, stream);
}

extern "C" int masked_scale_aggregate_bf16(const void* u, const void* scale,
                                           void* out, int c, int d,
                                           void* stream) {
  return launch<__nv_bfloat16>(u, scale, out, c, d, stream);
}
