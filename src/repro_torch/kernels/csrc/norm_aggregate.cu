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
// launches and of memory latencies in series.  Hence, in every kernel here:
// * one launch: each CTA writes its norm partials, takes a ticket on a
//   counter, and the CTA that draws the last ticket sums every client's
//   partials in the fixed order (ocs::cta_finish_sqnorms) and resets the
//   counter to 0 for the next launch; atomics touch the counter only;
// * a client register block (ocs::block_step): a thread issues the loads of
//   a block of clients (U and material) before it compresses, folds or
//   squares any of them, so their memory latencies overlap; their warp
//   shuffle trees are interleaved.  The fused kernel takes kBlock = 8
//   clients at a time: on the H100, 8 was the best of 4, 8 and 16 at the
//   paths' shapes or within 0.6 us of it (tools/bench_norm_kernels.py
//   --variant norm_aggregate.cu:kBlock=N), and kernel 1's 32 was slower at
//   the scan engine's 4 clients;
// * the caller's unpadded (C, D) matrices: a thread owns 4 adjacent columns
//   and reads them with 8-byte (f32) loads of V = 2 elements where every
//   matrix's base address and row stride allow, else V = 1 (ocs::load_row;
//   16-byte loads were slower); columns past D count as 0.0, as
//   zero padding did (zero values with zero material compress to +0 for
//   every kind).
// The fold (clients i = 0..C-1 in order, ocs::agg_step) and the partial
// layout (one per client per 128 columns) are those of the padded launches,
// so the aggregate is bitwise masked_aggregate.cu's and the norms bitwise
// the same in all three kernels and in sharded_aggregate.cu.
//
// client_sqnorms writes no aggregate, so its client axis is free to split:
// its grid is (D tiles, groups of kSqGroup clients), each CTA loads its
// group's clients in one register block before it squares any of them, and
// each group has a ticket counter of its own, whose last CTA finishes the
// group's norms (so the finish, too, runs in parallel over the groups).
// At the cohort's 32 clients a group of 8 gives 4 x 115 CTAs where one
// CTA per tile, a client at a time, left 115 CTAs waiting on 32 memory
// latencies in series (kSqGroup = 0 keeps one group of all the clients, in
// register blocks of 8; tools/bench_norm_kernels.py --variant times the
// choices).
//
// Contract (checked by the Python wrapper): every matrix is contiguous
// (C, D), any D >= 1, element-aligned rows, with V (2 or 1) | D and
// V-element-aligned bases; scale is (C,) f32, partials is (C, tile_blocks(D) * kWarps) f32
// scratch, the ticket int32 counters (one for the fused kernel, one per
// client group for client_sqnorms) that are 0 before the launch (and after
// it), owned by the launch's stream, C <= 12288.

#include "ocs_tile.cuh"

namespace {

using namespace ocs;

constexpr int kSqGroup = 8;     // client_sqnorms' clients per CTA (0: all of them)
constexpr int kSqMinCtas = 4;   // its CTAs per SM (launch bounds): 4 x 132 >= 4 x 115

// client_sqnorms: one CTA per (tile of kThreads * kCols columns, the last
// one partly past d; group of clients).  The group's warp partials, then a
// ticket on the group's counter (ticket[blockIdx.y], counting its D tiles);
// the group's last CTA finishes its clients' norms.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kSqMinCtas)
sqnorms_kernel(const T* __restrict__ u, float* __restrict__ partials, float* __restrict__ sq,
               unsigned int* __restrict__ ticket, int c, int d) {
  constexpr int kBlock = kSqGroup > 0 ? kSqGroup : 8;
  const int group = kSqGroup > 0 ? kSqGroup : c;
  const int lo = blockIdx.y * group;
  const int nc = min(group, c - lo);
  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  float* part = partials + static_cast<long long>(lo) * parts + blockIdx.x * kWarps + warp;
  float4 unused = make_float4(0.f, 0.f, 0.f, 0.f);   // no aggregate here
  for (int i0 = 0; i0 < nc; i0 += kBlock) {
    block_step<kNone, V, kBlock, false>(
        unused, u, nullptr, nullptr, static_cast<long long>(lo + i0) * d + col, nc - i0, col,
        d, col < d, nullptr, part + static_cast<long long>(i0) * parts, parts, lane, 0.f, 0.f);
  }
  if (last_ticket(ticket + blockIdx.y, gridDim.x)) {
    cta_finish_sqnorms(partials + static_cast<long long>(lo) * parts, sq + lo, nc, parts, warp,
                       lane);
    if (threadIdx.x == 0) ticket[blockIdx.y] = 0u;
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
  extern __shared__ float s_scale[];
  for (int i = threadIdx.x; i < c; i += kThreads) s_scale[i] = scale[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kCols;
  const bool live = col < d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int parts = gridDim.x * kWarps;
  float* part = partials + blockIdx.x * kWarps + warp;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < c; i0 += kBlock) {
    block_step<Kind, V, kBlock, true>(acc, u, m0, m1, static_cast<long long>(i0) * d + col,
                                      c - i0, col, d, live, s_scale + i0,
                                      part + static_cast<long long>(i0) * parts, parts, lane,
                                      levels, inv_levels);
  }
  if (live) store_row(agg, acc, col, d);
  // the partials out, then a ticket; the CTA that draws the last one sums
  // them (reading through L2) and leaves the counter at 0
  if (last_ticket(ticket, gridDim.x)) {
    cta_finish_sqnorms(partials, sq, c, parts, warp, lane);
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

template <typename T, int V>
int launch_sqnorms(const void* u, void* partials, void* sq, void* ticket, int c, int d,
                   cudaStream_t s) {
  const int groups = kSqGroup > 0 ? (c + kSqGroup - 1) / kSqGroup : 1;
  sqnorms_kernel<T, V><<<dim3(tile_blocks(d), groups), kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<float*>(partials), static_cast<float*>(sq),
      static_cast<unsigned int*>(ticket), c, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sqnorms_vec(const void* u, void* partials, void* sq, void* ticket, int c, int d,
                       int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 2:
      return launch_sqnorms<T, 2>(u, partials, sq, ticket, c, d, s);
    case 1:
      return launch_sqnorms<T, 1>(u, partials, sq, ticket, c, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" int client_sqnorms_f32(const void* u, void* partials, void* sq, void* ticket,
                                  int c, int d, int vec, void* stream) {
  return launch_sqnorms_vec<float>(u, partials, sq, ticket, c, d, vec, stream);
}

extern "C" int client_sqnorms_bf16(const void* u, void* partials, void* sq, void* ticket,
                                   int c, int d, int vec, void* stream) {
  return launch_sqnorms_vec<__nv_bfloat16>(u, partials, sq, ticket, c, d, vec, stream);
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
