// The chunked SSD scan of Mamba2 on Hopper, as three chunk-parallel passes
// over the model's strided views: a decayed causal attention inside each
// chunk of Q steps plus the (P, N) state carried from chunk to chunk.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (a
// (BH, chunks) grid whose innermost, sequential chunk axis carries the state
// in VMEM).  On the GPU blocks run in parallel and in no order, so the work
// follows the reference's batched form of the same core
// (repro/models/ssm.py, the nc <= 64 branch), with a_cs the in-chunk
// cumsum of da and a_tot its last value:
//   pass 1 (ssd_chunk_state_*), grid (head group, chunk, batch):
//     s_chunk = sum_t exp(a_tot - a_cs[t]) dt[t] x[t]^T B_t    (P, N)
//     written with a_tot to scratch;
//   pass 2 (ssd_state_pass), grid (batch x head, 4-element slices of the
//     state): state <- state exp(a_tot) + s_chunk, chunk by chunk in f32,
//     overwriting each chunk's scratch with the state that enters it and
//     writing the final state;
//   pass 3 (ssd_chunk_out_*), grid (head group, chunk, batch):
//     att[s, t] = (C_s . B_t) exp(a_cs[s] - a_cs[t]) dt[t]     t <= s, else 0
//     y[s]      = sum_t att[s, t] x[t] + exp(a_cs[s]) (C_s . state_in^T)
//     written straight into y (B, S, H, P) f32.
// exp(seg) is never used above the diagonal: it overflows there, and a
// select (not a 0/1 factor, which would give inf * 0 = NaN) zeroes it.
// No atomics; every sum runs in a fixed order, so results are bitwise equal
// run to run, and a head's results do not depend on the head group it lies
// in (the per-row (BH, S, P) interface is the case H = 1).
//
// Layout: x (B, S, H, P), B and C (B, S, G, N) with G = 1 (head stride 0)
// or G = H, dt and da (B, S, H), all with element strides (P and N
// contiguous), so the model hands over its projection views with no copies.
//
// Bound on an H100 SXM: device memory.  At the hybrid model's shape (batch
// 2, 80 heads, S = 4096, P = N = 64, Q = 128, bf16) the function reads x
// (84 MB), B and C once per batch, dt and da, and writes y (168 MB f32) and
// the state: 262 MB, 78 us at 3.35 TB/s, against about 5e10 tensor-core
// flops (0.05 ms).  The passes add the scratch: (B, NC, H, P, N) f32, 84 MB
// written by pass 1, read and written by pass 2, read by pass 3, and x read
// twice: 681 MB, 0.20 ms.  chip_smoke.py prints both bounds.  At these
// sizes the products are not the limit, but the instructions around them
// are: with one CTA of 8 warps on an SM (the 16 x Q strip of C B^T lives in
// registers), the SM issues the exp, the split and the fragment loads of
// each head with few warps to hide their latency.
//
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, f32
// accumulation), one warp per 16 rows of the chunk (Q / 16 warps):
// * pass 3 computes C B^T (Q x Q) once per CTA into registers, each warp
//   its 16-row strip up to the diagonal, and reuses it for every head of the
//   group (B and C are one group shared by all heads at G = 1; G = H runs
//   one head per CTA).  Each head's att is built from that strip in
//   registers and becomes the A fragment of att x, as a flash-attention
//   kernel reuses P.  y is accumulated as exp(a_cs) (C state_in^T) first,
//   scaled per row, then att x on top, in one accumulator.  The strips are
//   paired so that the two warps of an SM sub-partition hold the same
//   causal work; the exponentials are exp2f of a_cs log2(e);
// * products of bf16 x, B, C with each other are exact in f32.  The three
//   with an f32 operand -- att, state_in, and x scaled by
//   exp(a_tot - a_cs) dt -- split it into a bf16 high part and a bf16
//   low part and add both products into one accumulator (residual
//   2^-18 relative, where one bf16 rounding, 2^-9, would break the 1e-4
//   bound).  Pass 2 stores state_in already split, in the bytes of its f32
//   slot, so pass 3 loads both parts as they are;
// * pass 1 computes every head's a_cs, w and a_tot up front, one warp per
//   head, and stores a_cs log2(e) and dt per (batch, chunk, head) for
//   pass 3 (aux), which so loads them contiguous and runs no cumsum;
// * each head's tiles come in by cp.async into a second buffer while the
//   previous head computes.
// float32 keeps scalar f32 FMAs on shared-memory tiles (4 x 4 register
// tiles from 16-byte loads) inside the same three passes, one head per CTA
// (C B^T per head), as flash_attention.cu keeps a scalar f32 kernel.
//
// Contract (checked by the Python wrapper): x, B, C of one dtype (f32 or
// bf16), dt and da f32; last axes contiguous; x, B, C on 16-byte aligned
// pointers with 16-byte strides (cp.async); S a multiple of Q; Q, P
// multiples of 16, N of 8; bf16: Q <= 128, P <= 64, at most 8 heads per
// CTA; shared memory (the smem_* functions below, and
// ssd_scan.py::smem_bytes) at most 227 KB; G = H runs one head per CTA.
// y (B, S, H, P) f32 contiguous, state (B, H, P, N) f32; scratch
// (B, NC, H, P, N) f32, a_tot (B, NC, H) f32 and aux (B, NC, H, 2, Q) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 128;   // bf16: a warp keeps its 16 x Q strip of C B^T in registers
constexpr int kMaxP = 64;    // bf16: a warp's y accumulator is 16 x P
constexpr int kPad = 8;      // row padding of the bf16 instance's tiles (conflict-free ldmatrix)
constexpr int kScalarThreads = 256;
constexpr int kRowBlock = 64;   // f32: rows of the intra-chunk attention built at once
constexpr int kStateThreads = 256;
constexpr int kStateDepth = 8;  // pass 2: chunks whose loads are in flight at once
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {   // element strides of the views
  long long xb, xs, xh;   // x (B, S, H, P)
  long long bb, bs, bh;   // B (B, S, G, N); bh = 0 at G = 1
  long long cb, cs, ch;   // C
  long long tb, ts, th;   // dt (B, S, H)
  long long ab, as, ah;   // da
};

static_assert(sizeof(Strides) == 15 * sizeof(long long), "strides[15] of the C interface");

struct Dims {
  int nb, s, h, p, n, q, nc, hg, ngroups;
};

// The CTA's (chunk, batch, first head, heads) from a 1-D grid, head group
// fastest.
struct Unit {
  int c, b, h0, nh;
  long long t0;
};

__device__ __forceinline__ Unit unit_of(const Dims& d) {
  Unit u;
  const int blk = blockIdx.x;
  u.h0 = (blk % d.ngroups) * d.hg;
  const int rest = blk / d.ngroups;
  u.c = rest % d.nc;
  u.b = rest / d.nc;
  u.nh = min(d.hg, d.h - u.h0);
  u.t0 = static_cast<long long>(u.c) * d.q;
  return u;
}

__device__ __forceinline__ long long scratch_row(const Dims& d, int b, int c, int h) {
  return (static_cast<long long>(b) * d.nc + c) * d.h + h;
}

// the in-chunk inclusive cumsum of v[0..q), in place, by one warp in a fixed
// order: each lane sums its run of consecutive values, a shuffle scan adds
// the runs before it
__device__ void warp_cumsum(float* v, int q, int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per);
  const int hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += v[i];
  float incl = run;
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float carry = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) carry = 0.f;
  __syncwarp();
  for (int i = lo; i < hi; ++i) {
    carry += v[i];
    v[i] = carry;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), f32 accumulators.  Fragments
// (g = lane / 4, k = lane % 4): a0 (row g, cols 2k, 2k+1), a1 (row g+8),
// a2 (row g, cols 2k+8, 2k+9), a3 (row g+8, those cols); b0 (rows 2k, 2k+1,
// col g), b1 (rows 2k+8, 2k+9); d0, d1 (row g, cols 2k, 2k+1), d2, d3 (row g+8).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// (a, b) as a bf16 pair hi = bf16(a, b) and the pair of residuals lo =
// bf16((a, b) - hi); hi + lo is within 2^-18 relative of (a, b)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
}

// a bf16 pair scaled by (w.x, w.y) in f32, then split
__device__ __forceinline__ void scale_split(uint32_t a, float2 w, uint32_t& hi, uint32_t& lo) {
  const float2 v = unpack(a);
  split2(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y), hi, lo);
}

inline long long smem_state_bf16(int p, int n, int q, int hg) {
  // B (q, n + pad) bf16; x (q, p + pad) bf16 x 2; dt (then w) and da (then a_cs) (hg, q) f32
  return 2LL * q * (n + kPad) + 2LL * 2 * q * (p + kPad) + 4LL * 2 * hg * q;
}

inline long long smem_out_bf16(int p, int n, int q) {
  // C, B (q, n + pad) bf16; per buffer state_in's high and low parts (p, n + pad) bf16,
  // x (q, p + pad) bf16, a_cs log2(e) and dt (q) f32
  return 2LL * 2 * q * (n + kPad) +
         2 * (2LL * 2 * p * (n + kPad) + 2LL * q * (p + kPad) + 4LL * 2 * q);
}

// Pass 1, bf16: s_chunk (P, N) = sum_t (x[t] w[t])^T B[t] with w = exp(a_tot -
// a_cs) dt, as M = P, N = N, K = Q products.  Warp tiles of 16 rows x 32 columns.
__global__ void __launch_bounds__(kMaxQ * 2)
ssd_chunk_state_bf16(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                     const float* __restrict__ dt, const float* __restrict__ da,
                     float* __restrict__ states, float* __restrict__ atot,
                     float* __restrict__ aux, Strides st, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = d.q, p = d.p, n = d.n;
  const int xp = p + kPad, np8 = n + kPad;
  bf16* sbs = reinterpret_cast<bf16*>(smem_raw);   // B (q, np8)
  bf16* sxs = sbs + q * np8;                        // x (q, xp) x 2
  float* sdt = reinterpret_cast<float*>(sxs + 2 * q * xp);   // dt (hg, q), then w in place
  float* sda = sdt + d.hg * q;                      // da (hg, q), then a_cs in place

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const Unit u = unit_of(d);

  for (int i = tid; i < q * kPad; i += nthr) sbs[(i / kPad) * np8 + n + i % kPad] = __float2bfloat16(0.f);
  {
    const bf16* src = bm + u.b * st.bb + u.t0 * st.bs + u.h0 * st.bh;
    const int nv = n / 8;
    for (int i = tid; i < q * nv; i += nthr) {
      const int r = i / nv, v = i - r * nv;
      cp_async16(sbs + r * np8 + 8 * v, src + r * st.bs + 8 * v);
    }
    for (int i = tid; i < q * u.nh; i += nthr) {   // dt and da of every head of the group
      const int t = i / u.nh, hh = i - t * u.nh;
      cp_async4(sdt + hh * q + t, dt + u.b * st.tb + (u.t0 + t) * st.ts + (u.h0 + hh) * st.th);
      cp_async4(sda + hh * q + t, da + u.b * st.ab + (u.t0 + t) * st.as + (u.h0 + hh) * st.ah);
    }
  }
  auto load_head = [&](int hh, int buf) {
    const int h = u.h0 + hh;
    const bf16* src = x + u.b * st.xb + u.t0 * st.xs + h * st.xh;
    bf16* dst = sxs + buf * q * xp;
    const int pv = p / 8;
    for (int i = tid; i < q * pv; i += nthr) {
      const int r = i / pv, v = i - r * pv;
      cp_async16(dst + r * xp + 8 * v, src + r * st.xs + 8 * v);
    }
  };
  load_head(0, 0);
  cp_async_commit();

  const int ncb = (n + 31) / 32;
  const int ntiles = (p / 16) * ncb;
  for (int hh = 0; hh < u.nh; ++hh) {
    const int buf = hh & 1;
    if (hh + 1 < u.nh) {
      load_head(hh + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (hh == 0) {   // per head, one warp each: w, a_tot, and a_cs log2(e) and dt for pass 3
      for (int hw = warp; hw < u.nh; hw += nwarps) {
        float* acs = sda + hw * q;
        float* dts = sdt + hw * q;
        warp_cumsum(acs, q, lane);
        const float a_tot = acs[q - 1];
        const long long row = scratch_row(d, u.b, u.c, u.h0 + hw);
        float* ax = aux + row * 2 * q;
        for (int t = lane; t < q; t += 32) {
          const float dtt = dts[t];
          ax[t] = __fmul_rn(acs[t], kLog2e);
          ax[q + t] = dtt;
          dts[t] = __fmul_rn(expf(a_tot - acs[t]), dtt);   // w
        }
        if (lane == 0) atot[row] = a_tot;
      }
      __syncthreads();
    }
    const int h = u.h0 + hh;
    const float* sw = sdt + hh * q;
    const bf16* xb = sxs + buf * q * xp;
    float* dst = states + scratch_row(d, u.b, u.c, h) * p * n;
    for (int tile = warp; tile < ntiles; tile += nwarps) {
      const int p0 = 16 * (tile / ncb), n0 = 32 * (tile % ncb);
      float acc[4][4] = {};
      for (int kk = 0; kk < q / 16; ++kk) {
        uint32_t a[4], ahi[4], alo[4];
        // A (p, t) = x[t][p]: x is stored (t, p), so the transposing load
        ldsm_x4_t(a, xb + (16 * kk + mr + 8 * (mi >> 1)) * xp + p0 + 8 * (mi & 1));
        const float2 w0 = *reinterpret_cast<const float2*>(sw + 16 * kk + 2 * tq);
        const float2 w1 = *reinterpret_cast<const float2*>(sw + 16 * kk + 8 + 2 * tq);
        scale_split(a[0], w0, ahi[0], alo[0]);
        scale_split(a[1], w0, ahi[1], alo[1]);
        scale_split(a[2], w1, ahi[2], alo[2]);
        scale_split(a[3], w1, ahi[3], alo[3]);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int c0 = n0 + 16 * jp;
          if (c0 < n) {
            uint32_t bb[4];   // B (t, n), stored (t, n): transposing load, two n-tiles
            ldsm_x4_t(bb, sbs + (16 * kk + mr + 8 * (mi & 1)) * np8 + c0 + 8 * (mi >> 1));
            mma(acc[2 * jp], ahi, bb[0], bb[1]);
            mma(acc[2 * jp], alo, bb[0], bb[1]);
            if (c0 + 8 < n) {
              mma(acc[2 * jp + 1], ahi, bb[2], bb[3]);
              mma(acc[2 * jp + 1], alo, bb[2], bb[3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col < n) {
          *reinterpret_cast<float2*>(dst + (p0 + g) * n + col) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(dst + (p0 + g + 8) * n + col) =
              make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();   // this buffer is free for the head after next
  }
}

// Pass 3, bf16: y for each head of the group from C B^T (once), the head's
// att, x and state_in.  Each warp owns a strip of 16 rows of the chunk; the
// strips are paired so that warps w and w + nw/2, which share an SM
// sub-partition, hold strips w and nw - 1 - w and so the same causal work.
// The heads' tiles are double-buffered: the next head's loads are in flight
// while one head computes.  A head's
// state_in comes split into its bf16 high and low parts (pass 2), and its
// a_cs log2(e) and dt contiguous (pass 1).
__global__ void __launch_bounds__(kMaxQ * 2)
ssd_chunk_out_bf16(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, const float* __restrict__ states,
                   const float* __restrict__ aux, float* __restrict__ y, Strides st, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = d.q, p = d.p, n = d.n;
  const int xp = p + kPad, np8 = n + kPad;
  bf16* scs = reinterpret_cast<bf16*>(smem_raw);   // C (q, np8)
  bf16* sbs = scs + q * np8;                        // B (q, np8)
  bf16* sst = sbs + q * np8;   // state_in high, then low (p, np8) each, x 2
  bf16* sxs = sst + 2 * 2 * p * np8;                          // x (q, xp) x 2
  float* sax = reinterpret_cast<float*>(sxs + 2 * q * xp);    // a_cs log2(e), dt (2q) x 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nw = nthr >> 5;
  const int strip = warp < nw / 2 ? warp : 3 * nw / 2 - 1 - warp;
  const int g = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const Unit u = unit_of(d);

  // zero the pad columns: at N % 16 == 8 the last k-step of C B^T and of
  // C state^T reads them (C, B, and both buffers' state_in parts, rows of np8)
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < 2 * (q + 2 * p) * kPad; i += nthr) {
    scs[(i / kPad) * np8 + n + i % kPad] = zero;
  }
  {
    const bf16* bsrc = bm + u.b * st.bb + u.t0 * st.bs + u.h0 * st.bh;
    const bf16* csrc = cm + u.b * st.cb + u.t0 * st.cs + u.h0 * st.ch;
    const int nv = n / 8;
    for (int i = tid; i < q * nv; i += nthr) {
      const int r = i / nv, v = i - r * nv;
      cp_async16(scs + r * np8 + 8 * v, csrc + r * st.cs + 8 * v);
      cp_async16(sbs + r * np8 + 8 * v, bsrc + r * st.bs + 8 * v);
    }
    cp_async_commit();
  }
  auto load_head = [&](int hh, int buf) {
    const int h = u.h0 + hh;
    const bf16* xsrc = x + u.b * st.xb + u.t0 * st.xs + h * st.xh;
    bf16* xdst = sxs + buf * q * xp;
    const int pv = p / 8;
    for (int i = tid; i < q * pv; i += nthr) {
      const int r = i / pv, v = i - r * pv;
      cp_async16(xdst + r * xp + 8 * v, xsrc + r * st.xs + 8 * v);
    }
    // state_in: 16 bytes per 4 elements, their high parts then their low parts
    const float* ssrc = states + scratch_row(d, u.b, u.c, h) * p * n;
    bf16* hdst = sst + buf * 2 * p * np8;
    for (int i = tid; i < p * n / 4; i += nthr) {
      const int r = (4 * i) / n, k = 4 * i - r * n;
      cp_async8(hdst + r * np8 + k, ssrc + 4 * i);
      cp_async8(hdst + (p + r) * np8 + k, ssrc + 4 * i + 2);
    }
    const float* asrc = aux + scratch_row(d, u.b, u.c, h) * 2 * q;
    for (int i = tid; i < q / 2; i += nthr) cp_async16(sax + buf * 2 * q + 4 * i, asrc + 4 * i);
  };
  load_head(0, 0);
  cp_async_commit();
  cp_async_wait<1>();   // C and B
  __syncthreads();

  // C B^T for this warp's strip, column tiles of 8 up to the diagonal:
  // cb[j] holds rows 16 strip + {g, g+8}, columns 8j + 2k + {0, 1}
  const int srow = 16 * strip;
  const int kn = (n + 15) / 16;
  float cb[kMaxQ / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxQ / 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
  for (int kk = 0; kk < kn; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, scs + (srow + mr + 8 * (mi & 1)) * np8 + 16 * kk + 8 * (mi >> 1));
#pragma unroll
    for (int jp = 0; jp < kMaxQ / 16; ++jp) {
      if (jp <= strip) {
        uint32_t bb[4];   // B^T (k, t) from B stored (t, k): two t-tiles
        ldsm_x4(bb, sbs + (16 * jp + mr + 8 * (mi >> 1)) * np8 + 16 * kk + 8 * (mi & 1));
        mma(cb[2 * jp], a, bb[0], bb[1]);
        mma(cb[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
  }

  const int s0 = srow + g, s1 = s0 + 8;
  for (int hh = 0; hh < u.nh; ++hh) {
    const int buf = hh & 1;
    if (hh + 1 < u.nh) {
      load_head(hh + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* acs = sax + buf * 2 * q;   // a_cs log2(e), for exp2f
    const float* dts = acs + q;
    const bf16* xb = sxs + buf * q * xp;
    const bf16* shi = sst + buf * 2 * p * np8;
    const bf16* slo = shi + p * np8;

    // y = exp(a_cs) (C state_in^T): A = C (exact), B = state_in^T's two parts
    float acc[kMaxP / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kk = 0; kk < kn; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, scs + (srow + mr + 8 * (mi & 1)) * np8 + 16 * kk + 8 * (mi >> 1));
#pragma unroll
      for (int jp = 0; jp < kMaxP / 16; ++jp) {
        if (16 * jp < p) {
          // state_in^T (k, p) from state_in stored (p, k): two p-tiles
          const int off = (16 * jp + mr + 8 * (mi >> 1)) * np8 + 16 * kk + 8 * (mi & 1);
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, shi + off);
          ldsm_x4(bl, slo + off);
          mma(acc[2 * jp], a, bh[0], bh[1]);
          mma(acc[2 * jp], a, bl[0], bl[1]);
          mma(acc[2 * jp + 1], a, bh[2], bh[3]);
          mma(acc[2 * jp + 1], a, bl[2], bl[3]);
        }
      }
    }
    const float as0 = acs[s0], as1 = acs[s1];
    const float e0 = exp2f(as0), e1 = exp2f(as1);
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      acc[j][0] = __fmul_rn(acc[j][0], e0);
      acc[j][1] = __fmul_rn(acc[j][1], e0);
      acc[j][2] = __fmul_rn(acc[j][2], e1);
      acc[j][3] = __fmul_rn(acc[j][3], e1);
    }

    // y += att x over the t-tiles up to the diagonal: A = att split, B = x
#pragma unroll
    for (int kk = 0; kk < kMaxQ / 16; ++kk) {
      if (kk <= strip) {
        float v[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int jt = 2 * kk + hf;
          const int ta = 8 * jt + 2 * tq, tb = ta + 1;
          const float2 at = *reinterpret_cast<const float2*>(acs + ta);
          const float2 dv = *reinterpret_cast<const float2*>(dts + ta);
          v[hf][0] = ta <= s0 ? cb[jt][0] * exp2f(as0 - at.x) * dv.x : 0.f;
          v[hf][1] = tb <= s0 ? cb[jt][1] * exp2f(as0 - at.y) * dv.y : 0.f;
          v[hf][2] = ta <= s1 ? cb[jt][2] * exp2f(as1 - at.x) * dv.x : 0.f;
          v[hf][3] = tb <= s1 ? cb[jt][3] * exp2f(as1 - at.y) * dv.y : 0.f;
        }
        uint32_t ahi[4], alo[4];
        split2(v[0][0], v[0][1], ahi[0], alo[0]);
        split2(v[0][2], v[0][3], ahi[1], alo[1]);
        split2(v[1][0], v[1][1], ahi[2], alo[2]);
        split2(v[1][2], v[1][3], ahi[3], alo[3]);
#pragma unroll
        for (int jp = 0; jp < kMaxP / 16; ++jp) {
          if (16 * jp < p) {
            uint32_t bb[4];   // x (t, p), stored (t, p): transposing load, two p-tiles
            ldsm_x4_t(bb, xb + (16 * kk + mr + 8 * (mi & 1)) * xp + 16 * jp + 8 * (mi >> 1));
            mma(acc[2 * jp], ahi, bb[0], bb[1]);
            mma(acc[2 * jp], alo, bb[0], bb[1]);
            mma(acc[2 * jp + 1], ahi, bb[2], bb[3]);
            mma(acc[2 * jp + 1], alo, bb[2], bb[3]);
          }
        }
      }
    }

    const int h = u.h0 + hh;
    float* y0 = y + ((u.b * static_cast<long long>(d.s) + u.t0 + s0) * d.h + h) * p;
    float* y1 = y0 + 8LL * d.h * p;
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      if (8 * j < p) {
        *reinterpret_cast<float2*>(y0 + 8 * j + 2 * tq) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(y1 + 8 * j + 2 * tq) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();   // this buffer is free for the head after next
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs, one head per CTA

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

inline long long smem_state_f32(int p, int n, int q) {
  // B^T (n, q), x (q, p), dt, a_cs, w (q)
  return 4LL * (static_cast<long long>(n) * q + static_cast<long long>(q) * p + 3LL * q);
}

inline long long smem_out_f32(int p, int n, int q) {
  const int rb = q < kRowBlock ? q : kRowBlock;
  // state^T (n, p), B^T (n, q), C^T (n, q), x (q, p), att^T (q, rb), a_cs, exp(a_cs), dt (q)
  return 4LL * (static_cast<long long>(n) * p + 2LL * n * q + static_cast<long long>(q) * p +
                static_cast<long long>(rb) * q + 3LL * q);
}

// the head's x (q, p), B^T or C^T (n, q), dt and da of one chunk into shared memory
__device__ __forceinline__ void load_chunk_f32(const float* x, const float* bm, const float* dt,
                                               const float* da, const Strides& st, const Unit& u,
                                               int q, int p, int n, float* xs, float* bt,
                                               float* dts, float* acs) {
  const float* xsrc = x + u.b * st.xb + u.t0 * st.xs + u.h0 * st.xh;
  for (int i = threadIdx.x; i < q * p; i += blockDim.x) {
    const int t = i / p, j = i - t * p;
    xs[i] = xsrc[t * st.xs + j];
  }
  const float* bsrc = bm + u.b * st.bb + u.t0 * st.bs + u.h0 * st.bh;
  for (int i = threadIdx.x; i < q * n; i += blockDim.x) {
    const int t = i / n, k = i - t * n;
    bt[k * q + t] = bsrc[t * st.bs + k];
  }
  for (int i = threadIdx.x; i < q; i += blockDim.x) {
    dts[i] = dt[u.b * st.tb + (u.t0 + i) * st.ts + u.h0 * st.th];
    acs[i] = da[u.b * st.ab + (u.t0 + i) * st.as + u.h0 * st.ah];
  }
}

// Pass 1, f32: state tiles k0..k0+3 x j0..j0+3 of sum_t w[t] B[t]^T x[t]
__global__ void __launch_bounds__(kScalarThreads)
ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ bm,
                    const float* __restrict__ dt, const float* __restrict__ da,
                    float* __restrict__ states, float* __restrict__ atot, Strides st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int q = d.q, p = d.p, n = d.n;
  float* bt = smem;          // B^T: bt[k * q + t] = B[t][k]
  float* xs = bt + n * q;    // x:   xs[t * p + j]
  float* dts = xs + q * p;
  float* acs = dts + q;
  float* w = acs + q;        // exp(a_tot - a_cs) dt
  const int tid = threadIdx.x;
  const Unit u = unit_of(d);   // hg = 1: the head is h0
  load_chunk_f32(x, bm, dt, da, st, u, q, p, n, xs, bt, dts, acs);
  __syncthreads();
  if (tid < 32) warp_cumsum(acs, q, tid);
  __syncthreads();
  const float a_tot = acs[q - 1];
  for (int i = tid; i < q; i += kScalarThreads) w[i] = __fmul_rn(expf(a_tot - acs[i]), dts[i]);
  if (tid == 0) atot[scratch_row(d, u.b, u.c, u.h0)] = a_tot;
  __syncthreads();
  float* dst = states + scratch_row(d, u.b, u.c, u.h0) * p * n;
  const int p4 = p / 4;
  for (int gi = tid; gi < (n / 4) * p4; gi += kScalarThreads) {
    const int k0 = (gi / p4) * 4;
    const int j0 = (gi - (gi / p4) * p4) * 4;
    float upd[4][4] = {};
    float uu[4], vv[4];
    for (int t = 0; t < q; ++t) {
      const float wt = w[t];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) uu[kk] = wt * bt[(k0 + kk) * q + t];
      load4(&xs[t * p + j0], vv);
      outer4(upd, uu, vv);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      store4(&dst[(j0 + jj) * n + k0], upd[0][jj], upd[1][jj], upd[2][jj], upd[3][jj]);
  }
}

// Pass 3, f32: att in row blocks of kRowBlock, then y tiles s0..s0+3 x j0..j0+3
__global__ void __launch_bounds__(kScalarThreads)
ssd_chunk_out_f32(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ dt,
                  const float* __restrict__ da, const float* __restrict__ states,
                  float* __restrict__ y, Strides st, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int q = d.q, p = d.p, n = d.n;
  const int rb = min(q, kRowBlock);
  float* stt = smem;            // state_in^T: stt[k * p + j] = state[j][k]
  float* bt = stt + n * p;      // B^T
  float* ct = bt + n * q;       // C^T
  float* xs = ct + n * q;       // x
  float* att = xs + q * p;      // att^T: att[t * rb + i] for row r0 + i
  float* acs = att + q * rb;
  float* eacs = acs + q;
  float* dts = eacs + q;
  const int tid = threadIdx.x;
  const Unit u = unit_of(d);
  load_chunk_f32(x, bm, dt, da, st, u, q, p, n, xs, bt, dts, acs);
  {
    const float* csrc = cm + u.b * st.cb + u.t0 * st.cs + u.h0 * st.ch;
    for (int i = tid; i < q * n; i += kScalarThreads) {
      const int t = i / n, k = i - t * n;
      ct[k * q + t] = csrc[t * st.cs + k];
    }
    const float* ssrc = states + scratch_row(d, u.b, u.c, u.h0) * p * n;
    for (int i = tid; i < p * n; i += kScalarThreads) {
      const int j = i / n, k = i - j * n;
      stt[k * p + j] = ssrc[i];
    }
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(acs, q, tid);
  __syncthreads();
  for (int i = tid; i < q; i += kScalarThreads) eacs[i] = expf(acs[i]);

  const int p4 = p / 4, q4 = q / 4, r4 = rb / 4;
  float* yb = y + (u.b * static_cast<long long>(d.s) + u.t0) * d.h * p + u.h0 * p;
  const long long ys = static_cast<long long>(d.h) * p;   // y's row stride
  for (int r0 = 0; r0 < q; r0 += rb) {
    __syncthreads();   // att is free; eacs is written
    for (int gi = tid; gi < r4 * q4; gi += kScalarThreads) {
      const int i0 = (gi / q4) * 4;
      const int t0 = (gi - (gi / q4) * q4) * 4;
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
      float wv[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int sr = s0 + ii;
          const int t = t0 + jj;
          wv[ii][jj] = t <= sr ? acc[ii][jj] * expf(acs[sr] - acs[t]) * dts[t] : 0.f;
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        store4(&att[(t0 + jj) * rb + i0], wv[0][jj], wv[1][jj], wv[2][jj], wv[3][jj]);
    }
    __syncthreads();
    for (int gi = tid; gi < r4 * p4; gi += kScalarThreads) {
      const int i0 = (gi / p4) * 4;
      const int j0 = (gi - (gi / p4) * p4) * 4;
      const int s0 = r0 + i0;
      float diag[4][4] = {};
      float off[4][4] = {};
      float uu[4], vv[4];
      for (int t = 0; t <= s0 + 3; ++t) {   // att is 0 for t > s
        load4(&att[t * rb + i0], uu);
        load4(&xs[t * p + j0], vv);
        outer4(diag, uu, vv);
      }
      for (int k = 0; k < n; ++k) {
        load4(&ct[k * q + s0], uu);
        load4(&stt[k * p + j0], vv);
        outer4(off, uu, vv);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = eacs[s0 + ii];
        store4(&yb[(s0 + ii) * ys + j0], diag[ii][0] + e * off[ii][0],
               diag[ii][1] + e * off[ii][1], diag[ii][2] + e * off[ii][2],
               diag[ii][3] + e * off[ii][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2, both dtypes: the state entering each chunk, in chunk order.  Each
// thread owns 4 adjacent elements of one (batch, head)'s (P, N) state and
// keeps kStateDepth chunks' loads in flight.  For the bf16 pass 3 (kSplit)
// it stores each entering state in the same 16 bytes as its 4 elements'
// bf16 high parts, then their low parts (split2), so pass 3 loads the two
// operands of its products as they are.
template <bool kSplit>
__global__ void __launch_bounds__(kStateThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ atot,
               float* __restrict__ final_state, Dims d) {
  const long long pn4 = static_cast<long long>(d.p) * d.n / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * kStateThreads + threadIdx.x;
  if (idx >= static_cast<long long>(d.nb) * d.h * pn4) return;
  const int bh = static_cast<int>(idx / pn4);
  const long long e = (idx - bh * pn4) * 4;
  const int b = bh / d.h, h = bh - b * d.h;
  const long long pn = pn4 * 4;
  float4 state = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < d.nc; c0 += kStateDepth) {
    float4 s[kStateDepth];
    float decay[kStateDepth];
#pragma unroll
    for (int i = 0; i < kStateDepth; ++i) {
      if (c0 + i < d.nc) {
        const long long row = scratch_row(d, b, c0 + i, h);
        s[i] = *reinterpret_cast<const float4*>(states + row * pn + e);
        decay[i] = expf(atot[row]);
      }
    }
#pragma unroll
    for (int i = 0; i < kStateDepth; ++i) {
      if (c0 + i < d.nc) {
        float* slot = states + scratch_row(d, b, c0 + i, h) * pn + e;
        if (kSplit) {
          uint4 v;
          split2(state.x, state.y, v.x, v.z);
          split2(state.z, state.w, v.y, v.w);
          *reinterpret_cast<uint4*>(slot) = v;
        } else {
          *reinterpret_cast<float4*>(slot) = state;
        }
        state = make_float4(fmaf(state.x, decay[i], s[i].x), fmaf(state.y, decay[i], s[i].y),
                            fmaf(state.z, decay[i], s[i].z), fmaf(state.w, decay[i], s[i].w));
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + static_cast<long long>(bh) * pn + e) = state;
}

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared memory limit on the current device to
// `bytes` when a launch needs more than it was last given there (`allowed`,
// one table per kernel), so a steady caller pays no attribute call per launch.
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes, long long (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* dt, const void* da,
           void* y, void* state, void* scratch, void* atot, void* aux, const long long* strides,
           int nb, int s, int h, int p, int n, int q, int hg, void* stream) {
  constexpr bool kTensor = sizeof(T) == 2;
  if (!kTensor) hg = 1;
  const Dims d{nb, s, h, p, n, q, s / q, hg, (h + hg - 1) / hg};
  Strides st;
  memcpy(&st, strides, sizeof st);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int units = d.nc * nb * d.ngroups;
  const long long s1 = kTensor ? smem_state_bf16(p, n, q, hg) : smem_state_f32(p, n, q);
  const long long s3 = kTensor ? smem_out_bf16(p, n, q) : smem_out_f32(p, n, q);
  const int threads = kTensor ? 2 * q : kScalarThreads;
  static long long allowed1[kMaxDevices] = {}, allowed3[kMaxDevices] = {};   // per instance
  cudaError_t err;
  if constexpr (kTensor) {
    err = allow_smem(ssd_chunk_state_bf16, s1, allowed1);
    if (err == cudaSuccess) err = allow_smem(ssd_chunk_out_bf16, s3, allowed3);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_state_bf16<<<units, threads, s1, cs>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(b), static_cast<const float*>(dt),
        static_cast<const float*>(da), static_cast<float*>(scratch), static_cast<float*>(atot),
        static_cast<float*>(aux), st, d);
  } else {
    err = allow_smem(ssd_chunk_state_f32, s1, allowed1);
    if (err == cudaSuccess) err = allow_smem(ssd_chunk_out_f32, s3, allowed3);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_state_f32<<<units, threads, s1, cs>>>(
        static_cast<const float*>(x), static_cast<const float*>(b),
        static_cast<const float*>(dt), static_cast<const float*>(da),
        static_cast<float*>(scratch), static_cast<float*>(atot), st, d);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems4 = static_cast<long long>(nb) * h * p * n / 4;
  ssd_state_pass<kTensor><<<static_cast<int>((elems4 + kStateThreads - 1) / kStateThreads),
                             kStateThreads, 0, cs>>>(static_cast<float*>(scratch),
                                                     static_cast<const float*>(atot),
                                                     static_cast<float*>(state), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kTensor) {
    ssd_chunk_out_bf16<<<units, threads, s3, cs>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(b), static_cast<const bf16*>(c),
        static_cast<const float*>(scratch), static_cast<const float*>(aux),
        static_cast<float*>(y), st, d);
  } else {
    ssd_chunk_out_f32<<<units, threads, s3, cs>>>(
        static_cast<const float*>(x), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const float*>(dt),
        static_cast<const float*>(da), static_cast<const float*>(scratch),
        static_cast<float*>(y), st, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides[15]: the (batch, sequence, head) element strides of x, B, C, dt
// and da in turn (B's and C's head stride 0 at G = 1); hg heads per CTA of
// passes 1 and 3 (the f32 instance takes one).
extern "C" int ssd_scan_f32(const void* x, const void* b, const void* c, const void* dt,
                            const void* da, void* y, void* state, void* scratch, void* atot,
                            void* aux, const long long* strides, int nb, int s, int h, int p,
                            int n, int q, int hg, void* stream) {
  return launch<float>(x, b, c, dt, da, y, state, scratch, atot, aux, strides, nb, s, h, p, n,
                       q, hg, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* b, const void* c, const void* dt,
                             const void* da, void* y, void* state, void* scratch, void* atot,
                             void* aux, const long long* strides, int nb, int s, int h, int p,
                             int n, int q, int hg, void* stream) {
  return launch<__nv_bfloat16>(x, b, c, dt, da, y, state, scratch, atot, aux, strides, nb, s, h,
                               p, n, q, hg, stream);
}
