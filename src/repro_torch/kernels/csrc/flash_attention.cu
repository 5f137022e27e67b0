// Causal flash attention on Hopper, with an optional sliding window and an
// optional bidirectional prefix: out = softmax(mask(q k^T / sqrt(d))) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (a (BH, q blocks, k blocks) grid whose innermost,
// sequential K axis carries the online-softmax state (m, l, acc) in VMEM).
// On the GPU the blocks run in parallel and in no order, so the K axis
// becomes a loop inside the block: one CTA owns one (batch, head, query
// tile), walks the key tiles itself, carries (m, l, acc) in registers and
// writes its output tile once, with no split over keys and no atomics, so
// the output is bitwise the same from launch to launch.
//
// Bound on an H100 SXM: operations.  At the hybrid model's prefill shape
// (batch 2 x 32 heads, S = 4096, d = 80, bf16) the two products take
// 2 * 2 * BH * S^2 * d / 2 = 1.7e11 flops (causal half): 0.174 ms at the
// bf16 tensor-core rate, against 168 MB of q, k, v and out (0.05 ms).
//
// Layout: q, k, v and out are (B, S, H, hd) with element strides for batch,
// sequence and head (hd contiguous), so the model hands over its projection
// views with no (B*H, S, hd) copies; a (BH, S, d) tensor is the case H = 1.
//
// bf16 runs on the tensor cores (flash_attention_wgmma_kernel):
// * CTA: two consumer warpgroups of 64 query rows each and one producer
//   warpgroup, of which one thread issues TMA loads; setmaxnreg moves the
//   producer's registers to the consumers.  At hd 256 the output
//   accumulator alone is 128 f32 per thread, so one consumer warpgroup
//   (64 rows) runs there and keeps the launch's 255 registers.
// * Loads: the Q tile once; K and V tiles of 64 keys into a ring of
//   kStages slots, with mbarriers for full and empty slots, so the next
//   tile's copy overlaps the current tile's products.  A 4-D tensor map
//   (hd, H, S, B) per tensor takes the strides directly and fills rows past
//   S with zeros.
// * Head dim 80: a row is 160 bytes, which no 64- or 128-byte swizzle atom
//   divides.  Every tile is stored as hd/16 boxes of 64 rows x 32 bytes
//   with the 32-byte swizzle, one box per 16 head dims = one wgmma k-step
//   for Q K^T (K-major) and one 16-wide column block for P V (V as the
//   MN-major B operand, N = hd).  So every registry head dim (32, 64, 80,
//   128, 256) is the same layout.
// * S = Q K^T: wgmma.m64n64k16, f32 accumulators, hd/16 k-steps; the
//   logits are scaled by scale * log2(e) and exponentiated with exp2f.
// * The online softmax runs on the accumulator fragment in registers: each
//   thread holds 16 logits of two rows, and the row max and sum join the
//   four threads of a quad with two xor-shuffles.  Key tiles the mask hides
//   wholly are skipped, per warpgroup; tiles it shows wholly skip the mask.
// * P V: wgmma.m64nHDk16 with P from registers (the accumulator fragment is
//   the A fragment) and V from shared memory.  P is split as
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both products go into the
//   same f32 accumulator: 1.5x the one-pass tensor work, and an error near
//   f32's where one bf16 P (2^-9 relative) would break the elementwise
//   bound on outputs that cancel toward zero.  Q K^T on bf16 inputs with f32
//   accumulation rounds no product.
//
// float32 keeps the scalar kernel (flash_attention_f32_kernel): 256
// threads, four per query row, each owning 16-byte slices of the row's q and
// accumulator, K and V tiles staged in shared memory as f32, f32 FMAs.  TF32
// products would miss its 3e-5 bound.
//
// Masking follows the reference exactly, in its order: causal & window,
// then | prefix, then & (k < S) & (q < S); a hidden logit is -FLT_MAX
// (jnp.finfo(float32).min), not -inf.  A row whose first tile is wholly
// hidden gathers exp(0) = 1 junk there, which its first real logit wipes
// with corr = exp(-FLT_MAX - m) = 0, as in the reference; -inf would give
// NaN.  Every row < S sees its diagonal key, so it always gets a real
// logit; rows >= S are not written.
//
// Contract (checked by the Python wrapper): q, k, v and out of one shape
// (B, S, H, d) and one dtype (f32 or bf16), hd stride 1, the other strides
// multiples of 16 bytes, 16-byte aligned pointers; d in {32, 64, 80, 128,
// 256}; B, H <= 65535; window >= 1 or -1 for none, prefix >= 0.
// strides[12] holds the (batch, sequence, head) element strides of q, k, v
// and out in turn.

#include <cuda.h>   // CUtensorMap and its enums; the driver call is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

struct Strides {   // element strides of a (B, S, H, d) tensor
  long long b, s, h;
};

// The key positions [lo, hi] that any of the query rows [qa, qb] sees;
// keys outside are hidden for every row.  Empty (lo > hi) when qa >= s.
__device__ __forceinline__ void key_range(int qa, int qb, int s, int window, int prefix,
                                          int& lo, int& hi) {
  lo = window > 0 ? max(0, qa - window + 1) : 0;
  hi = qb;
  if (prefix > 0 && qa < prefix) {
    lo = 0;
    hi = max(hi, min(prefix, s) - 1);
  }
  if (qa >= s) {
    lo = 0;
    hi = -1;
  }
}

__device__ __forceinline__ bool seen(int qp, int kp, int s, int window, int prefix) {
  bool ok = kp <= qp;
  if (window > 0) ok = ok && (qp - kp) < window;
  if (prefix > 0) ok = ok || (qp < prefix && kp < prefix);
  return ok && kp < s && qp < s;
}

// ---------------------------------------------------------------------------
// float32: the scalar kernel

constexpr int kBlockQ = 64;                 // query rows per CTA
constexpr int kQuad = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kQuad;   // 256

// D: head dim; BK: keys per shared-memory tile (K and V tiles take
// 2 * BK * D * 4 bytes: at most 40 KB, inside the static 48 KB).
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, Strides sq,
                           Strides sk, Strides sv, Strides so, int s, int window, int prefix,
                           float scale) {
  constexpr int kSlices = D / 16;
  __shared__ __align__(16) float k_tile[BK][D];
  __shared__ __align__(16) float v_tile[BK][D];

  const int nq = (s + kBlockQ - 1) / kBlockQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);   // long tiles first
  const long long h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int row = threadIdx.x / kQuad;
  const int lane4 = threadIdx.x % kQuad;
  const int qpos = qi * kBlockQ + row;

  float qr[kSlices][4];
  float acc[kSlices][4];
#pragma unroll
  for (int i = 0; i < kSlices; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qpos < s) x = *reinterpret_cast<const float4*>(qb + qpos * sq.s + 16 * i + 4 * lane4);
    qr[i][0] = x.x * scale;
    qr[i][1] = x.y * scale;
    qr[i][2] = x.z * scale;
    qr[i][3] = x.w * scale;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m = -FLT_MAX;
  float l = 0.f;

  const int q_lo = qi * kBlockQ;
  int k_lo, k_hi;
  key_range(q_lo, min(s - 1, q_lo + kBlockQ - 1), s, window, prefix, k_lo, k_hi);

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    __syncthreads();   // the previous tile is no longer read
    for (int g = threadIdx.x; g < BK * D / 4; g += kThreads) {
      const int r = g / (D / 4);
      const int col = (g % (D / 4)) * 4;
      const long long kp = kt * BK + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kp < s) {
        kv = *reinterpret_cast<const float4*>(kb + kp * sk.s + col);
        vv = *reinterpret_cast<const float4*>(vb + kp * sv.s + col);
      }
      *reinterpret_cast<float4*>(&k_tile[r][col]) = kv;
      *reinterpret_cast<float4*>(&v_tile[r][col]) = vv;
    }
    __syncthreads();

    float sc[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kSlices; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][16 * i + 4 * lane4]);
        part = fmaf(qr[i][0], kk.x, part);
        part = fmaf(qr[i][1], kk.y, part);
        part = fmaf(qr[i][2], kk.z, part);
        part = fmaf(qr[i][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      sc[j] = seen(qpos, kt * BK + j, s, window, prefix) ? part : -FLT_MAX;
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
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][16 * i + 4 * lane4]);
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
    float* ob = out + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int i = 0; i < kSlices; ++i) {
      *reinterpret_cast<float4*>(ob + 16 * i + 4 * lane4) =
          make_float4(acc[i][0] / denom, acc[i][1] / denom, acc[i][2] / denom,
                      acc[i][3] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kRows = 64;                       // wgmma M; query rows per consumer; keys per tile
constexpr int kChunk = 16;                      // head dims per 32-byte swizzle row = one k-step
constexpr int kChunkBytes = kRows * kChunk * 2; // one TMA box: 64 rows x 32 bytes
constexpr int kStages = 2;                      // K/V ring slots
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kConsumers = D <= 128 ? 2 : 1;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kChunks = D / kChunk;
  static constexpr int kTile = kChunks * kChunkBytes;   // 64 rows of q, k or v
  static constexpr int kBars = 2 * kStages + 1;         // full[], empty[], q
  // + 1 KB to align the tiles to 1,024 bytes (the swizzle repeats every 256)
  static constexpr int kSmem = (kConsumers + 2 * kStages) * kTile + 8 * kBars + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A wait
// longer than ten seconds traps, so a broken pipeline faults the launch
// instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 10000000000ull) {
      __trap();
    }
  }
}

// One (16 x 1 x 64 x 1) box of a (d, H, S, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor for a 32-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B32.
__device__ __forceinline__ uint64_t desc_b32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma with both operands in shared memory (S = Q K^T: A and B K-major),
// or with A from registers (O += P V: B MN-major).  The accumulator
// fragment of an m64nN wgmma: warp w of the warpgroup holds rows
// 16w + lane/4 (registers 4j, 4j+1) and that + 8 (4j+2, 4j+3), columns
// 8j + 2 (lane % 4) + {0, 1}.  `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, Strides so, int s, int window,
                             int prefix, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kCtaRows = C::kConsumers * kRows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_sm = q_sm + C::kConsumers * C::kTile;
  const uint32_t v_sm = k_sm + kStages * C::kTile;
  const uint32_t full_bar = v_sm + kStages * C::kTile;   // kStages barriers of 8 bytes
  const uint32_t empty_bar = full_bar + 8 * kStages;
  const uint32_t q_bar = empty_bar + 8 * kStages;

  const int nq = (s + kCtaRows - 1) / kCtaRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kCtaRows;   // long tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  int k_lo, k_hi;   // the key tiles any row of the CTA sees
  key_range(q0, min(s - 1, q0 + kCtaRows - 1), s, window, prefix, k_lo, k_hi);
  const int kt_lo = k_lo / kRows, kt_hi = k_hi / kRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(full_bar + 8 * i, 1);
      bar_init(empty_bar + 8 * i, C::kConsumers * 128);
    }
    bar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kConsumers) {
    // producer warpgroup: one thread issues every load
    if constexpr (C::kConsumers > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      bar_expect_tx(q_bar, C::kConsumers * C::kTile);
      for (int g = 0; g < C::kConsumers; ++g) {
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(q_sm + g * C::kTile + c * kChunkBytes, &tq, q_bar, c * kChunk, h,
                   q0 + g * kRows, b);
        }
      }
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int st = i % kStages;
        bar_wait(empty_bar + 8 * st, ((i / kStages) & 1) ^ 1);   // round 0 passes at once
        bar_expect_tx(full_bar + 8 * st, 2 * C::kTile);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(k_sm + st * C::kTile + c * kChunkBytes, &tk, full_bar + 8 * st, c * kChunk,
                   h, kt * kRows, b);
          tma_load(v_sm + st * C::kTile + c * kChunkBytes, &tv, full_bar + 8 * st, c * kChunk,
                   h, kt * kRows, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows qa .. qa + 63
    if constexpr (C::kConsumers > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int qa = q0 + wg * kRows;
    const int r0 = qa + 16 * (tid / 32) + lane / 4;   // this thread's rows: r0, r0 + 8
    const int cq = 2 * (lane % 4);                    // and columns 8j + cq + {0, 1}
    int my_lo, my_hi;
    key_range(qa, min(s - 1, qa + kRows - 1), s, window, prefix, my_lo, my_hi);
    my_lo /= kRows;
    my_hi = my_hi < 0 ? -1 : my_hi / kRows;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-FLT_MAX, -FLT_MAX};   // running row max, in log2 units
    float l[2] = {0.f, 0.f};             // this thread's share of the row sums
    const uint32_t q_tile = q_sm + wg * C::kTile;
    bar_wait(q_bar, 0);

    for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
      const int st = i % kStages;
      bar_wait(full_bar + 8 * st, (i / kStages) & 1);
      if (kt >= my_lo && kt <= my_hi) {
        const uint32_t k_tile = k_sm + st * C::kTile;
        const uint32_t v_tile = v_sm + st * C::kTile;
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {   // K-major: 32-byte rows, 8-row groups 256 apart
          wgmma_ss(sc, desc_b32(q_tile + c * kChunkBytes, 16, 256),
                   desc_b32(k_tile + c * kChunkBytes, 16, 256), c > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // the tile is shown wholly to every row of the warpgroup: no mask
        const int k0 = kt * kRows;
        const bool whole = k0 + kRows - 1 <= qa &&
                           (window <= 0 || qa + kRows - 1 - k0 < window) &&
                           k0 + kRows - 1 < s && qa + kRows - 1 < s;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int half = (j >> 1) & 1;
          float t = sc[j] * scale_log2;
          const int kp = k0 + 8 * (j >> 2) + cq + (j & 1);
          if (!whole && !seen(r0 + 8 * half, kp, s, window, prefix)) t = -FLT_MAX;
          sc[j] = t;
          mx[half] = fmaxf(mx[half], t);
        }
        float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
          corr[half] = exp2f(m[half] - mx[half]);
          m[half] = mx[half];
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int half = (j >> 1) & 1;
          sc[j] = exp2f(sc[j] - m[half]);
          ls[half] += sc[j];
        }
        l[0] = l[0] * corr[0] + ls[0];
        l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];

        // P as the A fragments of four k-steps of 16 keys, high and low halves
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = sc[8 * t + 2 * r], c = sc[8 * t + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
            p_hi[t][r] = bf16x2_bits(hi);
            p_lo[t][r] = bf16x2_bits(
                __floats2bfloat162_rn(a - __low2float(hi), c - __high2float(hi)));
          }
        }
        // V is the MN-major B operand: 16 keys x 32 bytes per k-step, the next
        // 16 head dims one box (2,048 bytes) on, 8-key groups 256 bytes apart
        const auto v_desc = [&](int t) {
          return desc_b32(v_tile + t * kChunk * 32, kChunkBytes, 256);
        };
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          wgmma_rs(o, p_hi[t], v_desc(t), 1);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          wgmma_rs(o, p_lo[t], v_desc(t), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      bar_arrive(empty_bar + 8 * st);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sum = l[half];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int qp = r0 + 8 * half;
      if (qp < s) {
        const float denom = fmaxf(sum, 1e-30f);
        __nv_bfloat16* row = out + b * so.b + h * so.h + qp * so.s + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
              o[4 * j + 2 * half] / denom, o[4 * j + 2 * half + 1] / denom);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; the runtime finds it,
// so the build needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (d, H, S, B) map of one bf16 tensor, boxes of 16 head dims x 64 rows,
// 32-byte swizzle, rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int h, int d,
             const long long* st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kChunk, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

Strides strides_of(const long long* st) { return Strides{st[0], st[1], st[2]}; }

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
                 const long long* st, int window, int prefix, float scale,
                 cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = make_map(&maps[i], ptrs[i], b, s, h, D, st + 3 * i);
    if (rc != 0) return rc;
  }
  cudaError_t rc = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int rows = C::kConsumers * kRows;
  const dim3 grid((s + rows - 1) / rows, h, b);
  flash_attention_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), strides_of(st + 9), s, window,
      prefix, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b, int s, int h,
               const long long* st, int window, int prefix, float scale, cudaStream_t stream) {
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  flash_attention_f32_kernel<D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), strides_of(st), strides_of(st + 3), strides_of(st + 6),
      strides_of(st + 9), s, window, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int b, int s, int h, int d, const long long* strides,
                                   int window, int prefix, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_f32<32, 64>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 64: return launch_f32<64, 64>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 80: return launch_f32<80, 64>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 128: return launch_f32<128, 32>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 256: return launch_f32<256, 16>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int s, int h, int d, const long long* strides,
                                    int window, int prefix, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_wgmma<32>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 64: return launch_wgmma<64>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 80: return launch_wgmma<80>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 128: return launch_wgmma<128>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    case 256: return launch_wgmma<256>(q, k, v, out, b, s, h, strides, window, prefix, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
