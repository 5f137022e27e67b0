// The chunked SSD scan of Mamba2 on Hopper: for each (batch x head) row,
// a decayed causal attention inside each chunk of Q steps plus the (P, N)
// state carried from chunk to chunk.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (a
// (BH, chunks) grid whose innermost, sequential chunk axis carries the state
// in VMEM).  On the GPU blocks run in parallel and in no order, so the chunk
// axis becomes a loop inside the block: one CTA owns one bh row, walks its
// chunks in order and keeps the f32 state in shared memory throughout.
// Per chunk, with a_cs the in-chunk cumsum of da:
//   att[s, t] = (C_s . B_t) exp(a_cs[s] - a_cs[t]) dt[t]    for t <= s, else 0
//   y[s]      = sum_t att[s, t] x[t] + exp(a_cs[s]) (C_s . state^T)
//   state     = state exp(a_tot) + sum_t exp(a_tot - a_cs[t]) dt[t] x[t]^T B_t
// y is written once per chunk, the final state once at the end.
//
// Bound on an H100 SXM: at the hybrid model's shape (160 rows, S = 4096,
// P = N = 64, Q = 128, bf16 inputs) one launch does about
// 2 * 4096 * (Q/2 (N + P) + 2 N P) = 1.3e8 flops per row, 2.2e10 in all,
// against 0.43 GB of inputs and f32 outputs: the bytes bound it (0.13 ms)
// at the bf16 tensor-core rate (0.02 ms), the operations (0.32 ms) at the
// f32 rate of the FMAs this kernel does (it computes in f32, as the reference
// does).  One CTA per row runs only 160 CTAs (48 at mamba2-130m's 24 heads x
// batch 2) on 132 SMs, one per SM for its shared memory: the
// card is under-filled, and the chunk loop is serial.  What the design does:
// each chunk's x, B, C tiles are read from device memory once and kept as
// f32 in shared memory (B and C transposed, the attention too, so that every
// operand of the three products is a 16-byte load of 4 consecutive values);
// each thread computes 4 x 4 register tiles, so two such loads feed 16 FMAs
// (with one output per thread, a vector and a scalar load fed 4 FMAs and the
// kernel, bound by shared-memory bandwidth, ran no faster than the eager
// chunked core; chip_smoke.py times both); only the tiles at or below the
// diagonal of the intra-chunk attention are computed, and exp(seg) is never
// evaluated above it (it overflows there; the reference selects with
// `where`, and a 0/1 mask would give inf * 0 = NaN); the attention is built
// in row blocks of 64 so that Q = 128 with N = 128 fits in 227 KB.
// Splitting the heads' chunks across CTAs (a second pass for the carried
// state) and the tensor cores are later work.
//
// B and C are one group shared by every head in the model; this kernel keeps
// the reference's per-row (BH, S, N) interface, so the model's wrapper
// materializes the broadcast.
//
// Contract (checked by the Python wrapper): x (BH, S, P), b and c (BH, S, N)
// contiguous of one dtype (f32 or bf16); dt and da (BH, S) contiguous f32;
// S a multiple of Q; P, N and Q multiples of 4; the shared memory
// (smem_floats, and ssd_scan.py::smem_bytes) at most 227 KB.
// y (BH, S, P) f32, state (BH, P, N) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 64;   // rows of the intra-chunk attention built at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += u[i] * v[j]: one 4 x 4 register tile from two 16-byte loads
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float (&u)[4],
                                       const float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
}

inline long long smem_floats(int p, int n, int q) {
  const int rb = q < kRowBlock ? q : kRowBlock;
  // state^T (n, p), B^T (n, q), C^T (n, q), x (q, p), att^T (q, rb), 4 vectors of q
  return static_cast<long long>(n) * p + 2LL * n * q + static_cast<long long>(q) * p +
         static_cast<long long>(rb) * q + 4LL * q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ dt,
                const float* __restrict__ da, float* __restrict__ y,
                float* __restrict__ state_out, int s, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];
  const int rb = min(q, kRowBlock);
  float* st = smem;             // state^T: st[k * p + j] = state[j][k]
  float* bt = st + n * p;       // B^T:     bt[k * q + t] = B[t][k]
  float* ct = bt + n * q;       // C^T:     ct[k * q + t] = C[t][k]
  float* xs = ct + n * q;       // x:       xs[t * p + j]
  float* att = xs + q * p;      // att^T:   att[t * rb + i] for row r0 + i
  float* acs = att + q * rb;    // a_cs
  float* eacs = acs + q;        // exp(a_cs)
  float* dts = eacs + q;        // dt
  float* dout = dts + q;        // exp(a_tot - a_cs) dt

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  x += row * s * p;
  b += row * s * n;
  c += row * s * n;
  dt += row * s;
  da += row * s;
  y += row * s * p;
  const int p4 = p / 4;
  const int q4 = q / 4;
  const int r4 = rb / 4;

  for (int i = tid; i < n * p; i += kThreads) st[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += q) {
    __syncthreads();   // the previous chunk is done with the tiles
    const long long g0 = c0;
    for (int i = tid; i < q * p; i += kThreads) xs[i] = to_f32(x[g0 * p + i]);
    for (int i = tid; i < q * n; i += kThreads) {
      const int t = i / n;
      const int k = i - t * n;
      bt[k * q + t] = to_f32(b[g0 * n + i]);
      ct[k * q + t] = to_f32(c[g0 * n + i]);
    }
    for (int i = tid; i < q; i += kThreads) {
      dts[i] = dt[g0 + i];
      acs[i] = da[g0 + i];
    }
    __syncthreads();
    if (tid < 32) {   // the in-chunk cumsum: each lane sums its run, then a warp scan
      const int per = (q + 31) / 32;
      const int lo = min(q, tid * per);
      const int hi = min(q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += acs[i];
      float incl = run;
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float carry = incl - run;
      for (int i = lo; i < hi; ++i) {
        carry += acs[i];
        acs[i] = carry;
      }
    }
    __syncthreads();
    const float a_tot = acs[q - 1];
    for (int i = tid; i < q; i += kThreads) {
      eacs[i] = expf(acs[i]);
      dout[i] = expf(a_tot - acs[i]) * dts[i];
    }

    for (int r0 = 0; r0 < q; r0 += rb) {
      __syncthreads();   // att is free; eacs and dout are written
      // att tiles: rows s0..s0+3 x columns t0..t0+3, C B^T over k, then the
      // decay where t <= s (exp(seg) is never taken above the diagonal)
      for (int g = tid; g < r4 * q4; g += kThreads) {
        const int i0 = (g / q4) * 4;
        const int t0 = (g - (g / q4) * q4) * 4;
        const int s0 = r0 + i0;
        float acc[4][4] = {};
        if (t0 <= s0 + 3) {
          float cv[4], bv[4];
          for (int k = 0; k < n; ++k) {
            load4(&ct[k * q + s0], cv);
            load4(&bt[k * q + t0], bv);
            outer4(acc, cv, bv);
          }
        }
        float w[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int sr = s0 + ii;
            const int t = t0 + jj;
            w[ii][jj] = t <= sr ? acc[ii][jj] * expf(acs[sr] - acs[t]) * dts[t] : 0.f;
          }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          store4(&att[(t0 + jj) * rb + i0], w[0][jj], w[1][jj], w[2][jj], w[3][jj]);
      }
      __syncthreads();
      // y tiles: rows s0..s0+3 x columns j0..j0+3
      for (int g = tid; g < r4 * p4; g += kThreads) {
        const int i0 = (g / p4) * 4;
        const int j0 = (g - (g / p4) * p4) * 4;
        const int s0 = r0 + i0;
        float diag[4][4] = {};
        float off[4][4] = {};
        float u[4], v[4];
        for (int t = 0; t <= s0 + 3; ++t) {   // att is 0 for t > s
          load4(&att[t * rb + i0], u);
          load4(&xs[t * p + j0], v);
          outer4(diag, u, v);
        }
        for (int k = 0; k < n; ++k) {
          load4(&ct[k * q + s0], u);
          load4(&st[k * p + j0], v);
          outer4(off, u, v);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float e = eacs[s0 + ii];
          store4(&y[(g0 + s0 + ii) * p + j0], diag[ii][0] + e * off[ii][0],
                 diag[ii][1] + e * off[ii][1], diag[ii][2] + e * off[ii][2],
                 diag[ii][3] + e * off[ii][3]);
        }
      }
    }
    __syncthreads();   // every row of y has read the incoming state
    // state tiles: k0..k0+3 x j0..j0+3
    const float decay = expf(a_tot);
    for (int g = tid; g < (n / 4) * p4; g += kThreads) {
      const int k0 = (g / p4) * 4;
      const int j0 = (g - (g / p4) * p4) * 4;
      float upd[4][4] = {};
      float u[4], v[4];
      for (int t = 0; t < q; ++t) {
        const float d = dout[t];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) u[kk] = d * bt[(k0 + kk) * q + t];
        load4(&xs[t * p + j0], v);
        outer4(upd, u, v);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float* sp = &st[(k0 + kk) * p + j0];
        float old[4];
        load4(sp, old);
        store4(sp, fmaf(old[0], decay, upd[kk][0]), fmaf(old[1], decay, upd[kk][1]),
               fmaf(old[2], decay, upd[kk][2]), fmaf(old[3], decay, upd[kk][3]));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < p * n; i += kThreads) {
    const int j = i / n;
    const int k = i - j * n;
    state_out[row * p * n + i] = st[k * p + j];
  }
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dt,
           const void* da, void* y, void* state, int bh, int s, int p, int n,
           int q, void* stream) {
  const size_t bytes = static_cast<size_t>(smem_floats(p, n, q)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<bh, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(dt), static_cast<const float*>(da),
      static_cast<float*>(y), static_cast<float*>(state), s, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* b, const void* c, const void* dt,
                            const void* da, void* y, void* state, int bh, int s, int p,
                            int n, int q, void* stream) {
  return launch<float>(x, b, c, dt, da, y, state, bh, s, p, n, q, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* b, const void* c, const void* dt,
                             const void* da, void* y, void* state, int bh, int s, int p,
                             int n, int q, void* stream) {
  return launch<__nv_bfloat16>(x, b, c, dt, da, y, state, bh, s, p, n, q, stream);
}
