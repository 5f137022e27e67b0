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
// its block's clients in order into f32 registers (ocs::agg_step).  The
// client fold is never split across CTAs, so with one client block the CTA
// writes the output and the aggregate is bitwise masked_aggregate.cu's (and
// norm_aggregate.cu's) for the same tile values; with more, each CTA writes
// its block's partial of its tile, and the blockpart partials are added in
// block order (acc = part[0], then __fadd_rn of part[1], part[2], ...).  No
// atomics on values.
//
// Norms, as in norm_aggregate.cu: one partial per (client, D tile, warp)
// through ocs::col_sqnorm and ocs::warp_sum, summed per client in the fixed
// order of ocs::cta_finish_sqnorms.  Each client lies in exactly one client
// block, so its norm is a sum over D only, taken in the order of
// compress_norm_scale_aggregate: the norms are that kernel's, bitwise, at
// every k.
//
// sharded_masked_aggregate (kernel 5) folds its block through
// ocs::fold_clients, kernel 1's register block of 32 clients, on a padded
// matrix, and adds the blocks' partials in a second launch (sum_blocks).
//
// sharded_compress_aggregate is one launch on the caller's unpadded
// matrices, as norm_aggregate.cu's fused kernel: the block body is that
// kernel's (ocs::block_step, 8 clients' loads of U and material in flight
// through load_row<V>, zeros past D), and two kinds of ticket counter finish
// inside the launch:
// * one per client block, counting its D tiles: the CTA that draws the
//   block's last ticket sums its <= 128 clients' norm partials
//   (ocs::cta_finish_sqnorms) and sets the counter back to 0;
// * at k > kBlockClients, one per D tile, counting the client blocks: the
//   tile's last CTA adds the blocks' partials of its columns in block order,
//   writes the output and sets the counter back to 0.
//
// Bound on an H100 SXM: device memory.  The kernels read the block (and its
// material) once and write (D,) floats (and (k,) norms), against 2-5 flops
// per element: at a rank's (32, 58430) f32 block that is 7.5 MB (2.2 us at
// 3.35 TB/s) for the masked aggregate and 15.0 MB (4.5 us) for rand-k.
//
// Contract (checked by the Python wrapper): every matrix is contiguous
// (k, D); scale is (k,) f32; 1 <= k <= 65535 * kBlockClients.
// sharded_masked_aggregate: D % kCols == 0 and rows aligned to the vector
// load (ops.py pads D with zeros to a multiple of the tile); blockpart is
// (ceil(k / kBlockClients), D) f32 scratch when k > kBlockClients (else
// unused).  sharded_compress_aggregate: any D >= 1 and element-aligned rows,
// with V (2 or 1) | D and V-element-aligned bases; partials is
// (k, tile_blocks(D) * kWarps) f32 scratch; blockpart is
// (ceil(k / kBlockClients), tile_blocks(D) * kThreads * kCols) f32 scratch
// when k > kBlockClients (else unused); counters holds
// ceil(k / kBlockClients) + tile_blocks(D) int32 that are 0 before the
// launch (and after it), owned by the launch's stream.

#include "ocs_tile.cuh"

namespace {

using namespace ocs;

constexpr int kBlockClients = 128;
constexpr int kMinCtas = 1;   // shard_compress_kernel's CTAs per SM (launch bounds)

// sharded_masked_aggregate: one CTA per (tile of kThreads * kCols columns,
// block of kBlockClients clients).
template <typename T>
__global__ void __launch_bounds__(kThreads)
shard_tile_kernel(const T* __restrict__ u, const float* __restrict__ scale,
                  float* __restrict__ out, int c, int d) {
  __shared__ float s_scale[kBlockClients];
  const int lo = blockIdx.y * kBlockClients;
  const int nc = min(kBlockClients, c - lo);
  for (int i = threadIdx.x; i < nc; i += kThreads) s_scale[i] = scale[lo + i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  if (col >= d) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  fold_clients(acc, u + static_cast<long long>(lo) * d + col, d, s_scale, nc);
  *reinterpret_cast<float4*>(out + static_cast<long long>(blockIdx.y) * d + col) = acc;
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

// sharded_compress_aggregate: one CTA per (tile of kThreads * kCols columns,
// the last one partly past d; block of kBlockClients clients).  counters[y]
// counts client block y's D tiles, counters[gridDim.y + x] D tile x's
// client blocks (used at gridDim.y > 1 only).
template <typename T, int Kind, int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
shard_compress_kernel(const T* __restrict__ u, const float* __restrict__ scale,
                      const float* __restrict__ m0, const float* __restrict__ m1,
                      float* __restrict__ partials, float* __restrict__ sq,
                      float* __restrict__ blockpart, float* __restrict__ out,
                      unsigned int* __restrict__ counters, int c, int d, float levels,
                      float inv_levels) {
  constexpr int kBlock = 8;           // clients whose loads a thread keeps in flight
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
  float* part = partials + static_cast<long long>(lo) * parts + blockIdx.x * kWarps + warp;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < nc; i0 += kBlock) {
    block_step<Kind, V, kBlock, true>(acc, u, m0, m1,
                                      static_cast<long long>(lo + i0) * d + col, nc - i0,
                                      col, d, live, s_scale + i0,
                                      part + static_cast<long long>(i0) * parts, parts, lane,
                                      levels, inv_levels);
  }
  if (gridDim.y == 1) {
    if (live) store_row(out, acc, col, d);
  } else {
    // the block's partial of the tile, rows at the tile-padded width; the
    // tile's last CTA adds the blocks' partials in block order
    const long long width = static_cast<long long>(gridDim.x) * kThreads * kCols;
    *reinterpret_cast<float4*>(blockpart + blockIdx.y * width + col) = acc;
    unsigned int* tile_count = counters + gridDim.y + blockIdx.x;
    if (last_ticket(tile_count, gridDim.y)) {
      if (live) {
        float4 sum = __ldcg(reinterpret_cast<const float4*>(blockpart + col));
        for (int j = 1; j < static_cast<int>(gridDim.y); ++j) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(blockpart + j * width + col));
          sum.x = __fadd_rn(sum.x, v.x);
          sum.y = __fadd_rn(sum.y, v.y);
          sum.z = __fadd_rn(sum.z, v.z);
          sum.w = __fadd_rn(sum.w, v.w);
        }
        store_row(out, sum, col, d);
      }
      if (threadIdx.x == 0) *tile_count = 0u;
    }
  }
  // the block's norms: its last CTA sums its clients' partials
  if (last_ticket(counters + blockIdx.y, gridDim.x)) {
    cta_finish_sqnorms(partials + static_cast<long long>(lo) * parts, sq + lo, nc, parts,
                       warp, lane);
    if (threadIdx.x == 0) counters[blockIdx.y] = 0u;
  }
}

template <typename T>
int launch_masked(const void* u, const void* scale, void* blockpart, void* out, int c, int d,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dblocks = tile_blocks(d);
  const int cblocks = (c + kBlockClients - 1) / kBlockClients;
  float* dst = static_cast<float*>(cblocks == 1 ? out : blockpart);
  shard_tile_kernel<T><<<dim3(dblocks, cblocks), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(scale), dst, c, d);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && cblocks > 1) {
    sum_blocks<<<dblocks, kThreads, 0, s>>>(static_cast<const float*>(blockpart),
                                            static_cast<float*>(out), cblocks, d);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T, int Kind, int V>
int launch_compress(const void* u, const void* scale, const void* m0, const void* m1,
                    void* partials, void* sq, void* blockpart, void* out, void* counters,
                    int c, int d, float levels, float inv_levels, cudaStream_t s) {
  const int cblocks = (c + kBlockClients - 1) / kBlockClients;
  shard_compress_kernel<T, Kind, V><<<dim3(tile_blocks(d), cblocks), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(m0), static_cast<const float*>(m1),
      static_cast<float*>(partials), static_cast<float*>(sq), static_cast<float*>(blockpart),
      static_cast<float*>(out), static_cast<unsigned int*>(counters), c, d, levels,
      inv_levels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Kind>
int launch_vec(const void* u, const void* scale, const void* m0, const void* m1,
               void* partials, void* sq, void* blockpart, void* out, void* counters, int c,
               int d, int vec, float levels, float inv_levels, cudaStream_t s) {
  switch (vec) {
    case 2:
      return launch_compress<T, Kind, 2>(u, scale, m0, m1, partials, sq, blockpart, out,
                                         counters, c, d, levels, inv_levels, s);
    case 1:
      return launch_compress<T, Kind, 1>(u, scale, m0, m1, partials, sq, blockpart, out,
                                         counters, c, d, levels, inv_levels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_kind(const void* u, const void* scale, const void* m0, const void* m1,
                void* partials, void* sq, void* blockpart, void* out, void* counters, int c,
                int d, int vec, int kind, float levels, float inv_levels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kNone:
      return launch_vec<T, kNone>(u, scale, m0, m1, partials, sq, blockpart, out, counters,
                                  c, d, vec, levels, inv_levels, s);
    case kRandK:
      return launch_vec<T, kRandK>(u, scale, m0, m1, partials, sq, blockpart, out, counters,
                                   c, d, vec, levels, inv_levels, s);
    case kQsgd:
      return launch_vec<T, kQsgd>(u, scale, m0, m1, partials, sq, blockpart, out, counters,
                                  c, d, vec, levels, inv_levels, s);
    case kNatural:
      return launch_vec<T, kNatural>(u, scale, m0, m1, partials, sq, blockpart, out,
                                     counters, c, d, vec, levels, inv_levels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int sharded_masked_aggregate_f32(const void* u, const void* scale,
                                            void* blockpart, void* out, int c,
                                            int d, void* stream) {
  return launch_masked<float>(u, scale, blockpart, out, c, d, stream);
}

extern "C" int sharded_masked_aggregate_bf16(const void* u, const void* scale,
                                             void* blockpart, void* out, int c,
                                             int d, void* stream) {
  return launch_masked<__nv_bfloat16>(u, scale, blockpart, out, c, d, stream);
}

extern "C" int sharded_compress_aggregate_f32(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* blockpart, void* out, void* counters, int c, int d,
    int vec, int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<float>(u, scale, m0, m1, partials, sq, blockpart, out, counters, c, d,
                            vec, kind, levels, inv_levels, stream);
}

extern "C" int sharded_compress_aggregate_bf16(
    const void* u, const void* scale, const void* m0, const void* m1,
    void* partials, void* sq, void* blockpart, void* out, void* counters, int c, int d,
    int vec, int kind, float levels, float inv_levels, void* stream) {
  return launch_kind<__nv_bfloat16>(u, scale, m0, m1, partials, sq, blockpart, out,
                                    counters, c, d, vec, kind, levels, inv_levels, stream);
}
