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
// (32, 58880) f32 that is 7.8 MB, 2.32 us at 3.35 TB/s, against 0.06 us of
// f32 arithmetic at 67 TFLOP/s.  So its time is how many bytes are in
// flight: one read of U, no scaled (C, D) intermediate, and enough loads
// outstanding to cover the memory's latency.
//
// Design: a 1-D grid over D, in the tile layout of ocs_tile.cuh.  Each
// thread owns kCols adjacent columns (one 16-byte load of f32, or 8 bytes of
// bf16, per client).  A thread issues the loads of a block of kClientBlock =
// 32 clients into registers before it folds any of them (ocs::fold_clients,
// shared with sharded_aggregate.cu), so the whole client axis of the main
// path is in flight at once (one memory latency, where the earlier loop's
// unroll of 8 waited four), and folds the blocks in order.
// The CTA keeps the tile's 128 threads: at D = 58,880 that is 115 CTAs on
// 132 SMs; 32- and 64-thread CTAs (460 and 230 CTAs, the same fold)
// measured slower on the H100 with the L2 flushed.  The fold is
// unchanged: each column sums the clients i = 0..C-1 in order with
// ocs::agg_step into f32 registers, the step shared with norm_aggregate.cu
// and sharded_aggregate.cu, so this aggregate is bitwise theirs.  scale is
// staged once per CTA in shared memory.  Every output element is written by
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
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  ocs::fold_clients(acc, u + col, d, s_scale, c);
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
