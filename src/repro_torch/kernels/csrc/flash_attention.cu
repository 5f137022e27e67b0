// Causal flash attention on Hopper, with an optional sliding window and an
// optional bidirectional prefix: out = softmax(mask(q k^T / sqrt(d))) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (a (BH, q blocks, k blocks) grid whose innermost,
// sequential K axis carries the online-softmax state (m, l, acc) in VMEM).
// On the GPU the blocks run in parallel and in no order, so the K axis
// becomes a loop inside the block: one CTA owns one (bh, 64-row query tile),
// walks the key tiles itself, carries (m, l, acc) in registers and writes its
// output tile once, with no atomics.
//
// Bound on an H100 SXM: operations.  At the hybrid model's prefill shape
// (64 heads x batch, S = 4096, d = 80, bf16) the two products take
// 2 * 2 * BH * S^2 * d / 2 = 1.7e11 flops (causal half) against 168 MB of
// q, k, v and out, so the bytes (0.05 ms) are far below the work (0.17 ms
// at the bf16 tensor-core rate).  This first kernel does its products with
// scalar f32 FMAs, not the tensor cores: it is right and simple first.  What
// the design does about the work: it skips every key tile that the mask
// hides wholly (above the diagonal, before the window), so a causal tile
// does half the products; it stages each key/value tile once in shared
// memory as f32 for the 64 query rows that use it; and each thread reads
// them as 16-byte vectors that the warp's eight rows share (broadcast).
//
// Layout: 256 threads, four per query row (a quad).  Thread t of a quad
// owns the head dims 16*i + 4*t + {0..3}: its slice of the scaled q row and
// of the accumulator live in registers.  For each key, the quad's four
// partial dot products are summed with two xor-shuffles, so every thread
// of the quad holds the row's logits and runs the online softmax itself.
//
// Masking follows the reference exactly, in its order: causal & window,
// then | prefix, then & (k < S) & (q < S); a hidden logit is
// -FLT_MAX (jnp.finfo(float32).min), not -inf.  A row whose first tile is
// wholly hidden gathers exp(0) = 1 junk there, which its first real logit
// wipes with corr = exp(-FLT_MAX - m) = 0, as in the reference; -inf would
// give NaN.  Every row < S sees its diagonal key, so it always gets a real
// logit; rows >= S are not written.
//
// Contract (checked by the Python wrapper): q, k, v contiguous (BH, S, d) of
// one dtype (f32 or bf16), d in {32, 64, 80, 128, 256}, BH <= 65535,
// window >= 1 or -1 for none, prefix >= 0; out (BH, S, d) in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kBlockQ = 64;                 // query rows per CTA
constexpr int kQuad = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kQuad;   // 256

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// D: head dim; BK: keys per shared-memory tile (K and V tiles, f32, take
// 2 * BK * D * 4 bytes: at most 40 KB, inside the static 48 KB).
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int window, int prefix, float scale) {
  constexpr int kSlices = D / 16;
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int nq = (s + kBlockQ - 1) / kBlockQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);   // long tiles first
  const long long base = static_cast<long long>(blockIdx.y) * s * D;
  const int row = threadIdx.x / kQuad;
  const int lane4 = threadIdx.x % kQuad;
  const int qpos = qi * kBlockQ + row;

  float qr[kSlices][4];
  float acc[kSlices][4];
#pragma unroll
  for (int i = 0; i < kSlices; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qpos < s) x = load4(q + base + static_cast<long long>(qpos) * D + 16 * i + 4 * lane4);
    qr[i][0] = x.x * scale;
    qr[i][1] = x.y * scale;
    qr[i][2] = x.z * scale;
    qr[i][3] = x.w * scale;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m = -FLT_MAX;
  float l = 0.f;

  // The key range any row of this tile can see; tiles outside it are
  // wholly hidden and skipped.
  const int q_lo = qi * kBlockQ;
  const int q_hi = min(s - 1, q_lo + kBlockQ - 1);
  int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  int k_hi = q_hi;
  if (prefix > 0 && q_lo < prefix) {
    k_lo = 0;
    k_hi = max(k_hi, min(prefix, s) - 1);
  }

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    __syncthreads();   // the previous tile is no longer read
    for (int g = threadIdx.x; g < BK * D / 4; g += kThreads) {
      const int r = g / (D / 4);
      const int col = (g % (D / 4)) * 4;
      const int kp = kt * BK + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kp < s) {
        const long long off = base + static_cast<long long>(kp) * D + col;
        kv = load4(k + off);
        vv = load4(v + off);
      }
      *reinterpret_cast<float4*>(&ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&vs[r][col]) = vv;
    }
    __syncthreads();

    float sc[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kSlices; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][16 * i + 4 * lane4]);
        part = fmaf(qr[i][0], kk.x, part);
        part = fmaf(qr[i][1], kk.y, part);
        part = fmaf(qr[i][2], kk.z, part);
        part = fmaf(qr[i][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = kt * BK + j;
      bool seen = kp <= qpos;
      if (window > 0) seen = seen && (qpos - kp) < window;
      if (prefix > 0) seen = seen || (qpos < prefix && kp < prefix);
      seen = seen && kp < s && qpos < s;
      sc[j] = seen ? part : -FLT_MAX;
      m_new = fmaxf(m_new, sc[j]);
    }
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kSlices; ++i) {
      acc[i][0] *= corr;
      acc[i][1] *= corr;
      acc[i][2] *= corr;
      acc[i][3] *= corr;
    }
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sc[j] - m_new);
      lsum += p;
#pragma unroll
      for (int i = 0; i < kSlices; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][16 * i + 4 * lane4]);
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
    l = l * corr + lsum;
    m = m_new;
  }

  if (qpos < s) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kSlices; ++i) {
      store4(out + base + static_cast<long long>(qpos) * D + 16 * i + 4 * lane4,
             make_float4(acc[i][0] / denom, acc[i][1] / denom, acc[i][2] / denom,
                         acc[i][3] / denom));
    }
  }
}

template <typename T, int D, int BK>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int window, int prefix, float scale, void* stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_kernel<T, D, BK><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, window, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
           int d, int window, int prefix, float scale, void* stream) {
  switch (d) {
    case 32: return launch_d<T, 32, 64>(q, k, v, out, bh, s, window, prefix, scale, stream);
    case 64: return launch_d<T, 64, 64>(q, k, v, out, bh, s, window, prefix, scale, stream);
    case 80: return launch_d<T, 80, 64>(q, k, v, out, bh, s, window, prefix, scale, stream);
    case 128: return launch_d<T, 128, 32>(q, k, v, out, bh, s, window, prefix, scale, stream);
    case 256: return launch_d<T, 256, 16>(q, k, v, out, bh, s, window, prefix, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int bh, int s, int d, int window,
                                   int prefix, float scale, void* stream) {
  return launch<float>(q, k, v, out, bh, s, d, window, prefix, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int bh, int s, int d, int window,
                                    int prefix, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, d, window, prefix, scale, stream);
}
