// A rank's half of Eq. 2 on Hopper, with and without in-stream compression.
//
// Replaces two TPU kernels:
// * repro/kernels/sharded_aggregate.py::sharded_masked_aggregate_pallas — the
//   rank's (k, D) client block and its (k,) scale -> the (D,) f32 partial
//   sum_i scale[i] U[i, :] (sharded_masked_aggregate_*);
// * repro/kernels/sharded_aggregate.py::sharded_compress_aggregate_pallas —
//   the same on C(U), compressed in the tile stream from the raw block and
//   its material, plus the (k,) squared norms of C(U)
//   (sharded_compress_aggregate_*).
// The caller all-reduces the partial over the ranks.
//
// The TPU kernels give the grid a client-block axis (blocks of 128 clients)
// for large local blocks and accumulate each output chunk in VMEM across the
// sequential client-block steps.  Here CTAs run in parallel and in no order,
// so the grid is (D tiles, client blocks of kBlockClients): each CTA folds
// its block's clients in order into f32 registers (ocs::agg_step).  With one
// client block the CTA writes the output, so at k <= kBlockClients the
// aggregate is bitwise masked_aggregate.cu's (and norm_aggregate.cu's) for
// the same tile values; with more, each CTA writes its block's (D,) partial
// and sum_blocks adds the partials in block order.  No atomics on values.
//
// Norms, as in norm_aggregate.cu: one partial per (client, D tile, warp)
// through ocs::col_sqnorm and ocs::warp_sum, summed per client by
// ocs::finish_sqnorms in a fixed order.  Each client lies in exactly one
// client block, so its norm is a sum over D only, taken in the order of
// compress_norm_scale_aggregate: the norms are that kernel's, bitwise, at
// every k.
//
// Loads: the plain aggregate (sharded_masked_aggregate) folds its block
// through ocs::fold_clients, kernel 1's register block: the loads of 32
// clients are in flight before any is folded.  The compressed instances
// issue the loads of kUnroll clients (updates and material) before they
// fold any of them.  Every fold keeps the client order.
//
// Bound on an H100 SXM: device memory.  The kernels read the block (and its
// material) once and write (D,) floats (and (k,) norms), against 2-5 flops
// per element: at a rank's (32, 58880) f32 block that is 7.8 MB (2.3 us at
// 3.35 TB/s) for the masked aggregate and 15.3 MB (4.6 us) for rand-k.
//
// Contract (checked by the Python wrapper): every matrix is contiguous
// (k, D) with D % kCols == 0 and rows aligned to the vector load, scale is
// (k,) f32, partials is (k, tile_blocks(D) * kWarps) f32 scratch, blockpart
// is (ceil(k / kBlockClients), D) f32 scratch when k > kBlockClients (else
// unused), 1 <= k <= 65535 * kBlockClients.  ops.py pads D with zeros to a
// multiple of the tile.

#include "ocs_tile.cuh"

namespace {

using namespace ocs;

constexpr int kBlockClients = 128;

// One CTA per (tile of kThreads * kCols columns, block of kBlockClients
// clients).  Out-of-range threads take zeros, so every lane joins the
// norms' shuffle.
template <typename T, int Kind, bool kNorms>
__global__ void __launch_bounds__(kThreads)
shard_tile_kernel(const T* __restrict__ u, const float* __restrict__ scale,
                  const float* __restrict__ m0, const float* __restrict__ m1,
                  float* __restrict__ partials, float* __restrict__ out, int c,
                  int d, float levels, float inv_levels) {
  constexpr int kUnroll = Kind == kNone ? 8 : 4;   // the compressed instances
  __shared__ float s_scale[kBlockClients];
  const int lo = blockIdx.y * kBlockClients;
  const int nc = min(kBlockClients, c - lo);
  for (int i = threadIdx.x; i < nc; i += kThreads) s_scale[i] = scale[lo + i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool live = col < d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = zero;
  if constexpr (Kind == kNone && !kNorms) {
    if (live) fold_clients(acc, u + static_cast<long long>(lo) * d + col, d, s_scale, nc);
  } else {
    for (int i0 = 0; i0 < nc; i0 += kUnroll) {
      float4 x[kUnroll], a[kUnroll], b[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        x[j] = zero;
        a[j] = zero;
        b[j] = zero;
        if (live && i0 + j < nc) {
          const long long off = static_cast<long long>(lo + i0 + j) * d + col;
          x[j] = load_cols(u + off);
          if (Kind != kNone) a[j] = load_cols(m0 + off);
          if (Kind == kQsgd) b[j] = load_cols(m1 + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (i0 + j >= nc) break;               // the same for every thread
        float4 xc = zero;
        if (live) {
          xc = compress4<Kind>(x[j], a[j], b[j], levels, inv_levels, u);
          agg_step(acc, s_scale[i0 + j], xc);
        }
        if (kNorms) {
          const float p = warp_sum(col_sqnorm(xc));
          if (lane == 0) {
            partials[static_cast<long long>(lo + i0 + j) * parts +
                     blockIdx.x * kWarps + warp] = p;
          }
        }
      }
    }
  }
  if (live) {
    *reinterpret_cast<float4*>(out + static_cast<long long>(blockIdx.y) * d + col) = acc;
  }
}

// out[col] = sum over client blocks j = 0..nblk-1 of part[j, col], in order
__global__ void __launch_bounds__(kThreads)
sum_blocks(const float* __restrict__ part, float* __restrict__ out, int nblk,
           int d) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (col >= d) return;
  float4 acc = load_cols(part + col);
  for (int j = 1; j < nblk; ++j) {
    const float4 v = load_cols(part + static_cast<long long>(j) * d + col);
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  *reinterpret_cast<float4*>(out + col) = acc;
}

template <typename T, int Kind, bool kNorms>
int launch(const void* u, const void* scale, const void* m0, const void* m1,
           void* partials, void* sq, void* blockpart, void* out, int c, int d,
           float levels, float inv_levels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dblocks = tile_blocks(d);
  const int cblocks = (c + kBlockClients - 1) / kBlockClients;
  float* dst = static_cast<float*>(cblocks == 1 ? out : blockpart);
  shard_tile_kernel<T, Kind, kNorms><<<dim3(dblocks, cblocks), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(m0), static_cast<const float*>(m1),
      static_cast<float*>(partials), dst, c, d, levels, inv_levels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kNorms) {
    finish_sqnorms<<<c, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                          static_cast<float*>(sq), dblocks * kWarps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (cblocks > 1) {
    sum_blocks<<<dblocks, kThreads, 0, s>>>(static_cast<const float*>(blockpart),
                                            static_cast<float*>(out), cblocks, d);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int launch_kind(const void* u, const void* scale, const void* m0,
                const void* m1, void* partials, void* sq, void* blockpart,
                void* out, int c, int d, int kind, float levels,
                float inv_levels, void* stream) {
  switch (kind) {
    case kNone:
      return launch<T, kNone, true>(u, scale, m0, m1, partials, sq, blockpart,
                                    out, c, d, levels, inv_levels, stream);
    case kRandK:
      return launch<T, kRandK, true>(u, scale, m0, m1, partials, sq, blockpart,
                                     out, c, d, levels, inv_levels, stream);
    case kQsgd:
      return launch<T, kQsgd, true>(u, scale, m0, m1, partials, sq, blockpart,
                                    out, c, d, levels, inv_levels, stream);
    case kNatural:
      return launch<T, kNatural, true>(u, scale, m0, m1, partials, sq,
                                       blockpart, out, c, d, levels,
                                       inv_levels, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sharded_masked_aggregate_f32(const void* u, const void* scale,
                                            void* blockpart, void* out, int c,
                                            int d, void* stream) {
  return launch<float, ocs::kNone, false>(u, scale, nullptr, nullptr, nullptr,
                                          nullptr, blockpart, out, c, d, 0.f,
                                          0.f, stream);
}

extern "C" int sharded_masked_aggregate_bf16(const void* u, const void* scale,
                                             void* blockpart, void* out, int c,
                                             int d, void* stream) {
  return launch<__nv_bfloat16, ocs::kNone, false>(u, scale, nullptr, nullptr,
                                                  nullptr, nullptr, blockpart,
                                                  out, c, d, 0.f, 0.f, stream);
}

extern "C" int sharded_compress_aggregate_f32(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* blockpart, void* out, int c, int d,
    int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<float>(u, scale, m0, m1, partials, sq, blockpart, out, c,
                            d, kind, levels, inv_levels, stream);
}

extern "C" int sharded_compress_aggregate_bf16(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* blockpart, void* out, int c, int d,
    int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<__nv_bfloat16>(u, scale, m0, m1, partials, sq, blockpart,
                                    out, c, d, kind, levels, inv_levels,
                                    stream);
}
