// Sliding-window causal flash attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `swa_attention_bhsd` (band-resident
// `_fwd_kernel` and streaming `_fwd_kernel_stream`,
// src/repro/kernels/swa_attention/kernel.py:144): for every (batch, head)
//   o[i] = sum_j softmax_j(q[i] . k[j] / sqrt(hd)) v[j]
// over the causal band i - W < j <= i (W = 0: every j <= i), softmax in
// float32, inputs and output in float32 or bfloat16.
//
// Layout. The model's own: q and o (B, S, H, hd), k and v (B, S, KV, hd),
// row-major and contiguous. Query head h reads kv head h / (H / KV) (GQA,
// the order of jnp.broadcast_to in the JAX package's _repeat_kv), so k and
// v are never repeated in memory, and no transpose to (B*H, S, hd) is made.
//
// Bound. At the serving shapes the band holds S*W (q, k) pairs of 4*hd
// flops each; against the card's bf16 tensor-core rate that is about twice
// the time of reading q, k, v and writing o once, so the work bounds it,
// and only the tensor cores come near it.
//
// Two bodies, one per dtype:
//
// * bfloat16 (the serving path): `swa_fwd_bf16_kernel`, a flash-attention
//   forward on Hopper's warpgroup MMA (`wgmma`, bf16 in, float32
//   accumulate). A block is one warpgroup (4 warps) and owns a 64-row
//   query tile; the heaviest tiles (latest rows) launch first, and a block
//   walks only the 64-key tiles the band touches, from the diagonal back.
//   q, k and v tiles are staged in bf16 with cp.async, k and v
//   double-buffered (the next tile loads while this one computes), in the
//   128-byte swizzled layout that wgmma's shared-memory descriptors read
//   (hd 32 is padded to 64 with zeros). S = Q.K^T is one m64n64k16 wgmma
//   a 16-wide k-step, both operands from shared memory: bf16 products are
//   exact in float32, so S is the float32 dot product up to summation
//   order. scale * log2(e) is applied to the float32 scores (never to q,
//   which bf16 would round). The online softmax (band and S masks, running
//   max and sum, exp2) stays in float32 registers, masking only on the
//   diagonal and window-edge tiles; warp w holds rows 16w..16w+15 in the
//   layout of mma.sync's fragments, which is also wgmma's register A
//   operand, so P goes to P.V without leaving registers. P.V keeps float32
//   precision: each probability is split into two bf16 terms, p_hi =
//   bf16(p) and p_lo = bf16(p - p_hi), and both go through the tensor
//   cores against the (exact) bf16 V into one float32 accumulator.
//   p - p_hi - p_lo is below 2^-18 |p|, far below one bf16 step of o; a
//   single bf16 P (what SDPA does) misses o by many steps. The split costs
//   one MMA more per P.V step: 6*hd flops a pair against the function's
//   4*hd, which the bound does not count. Each wgmma group is waited on
//   before its registers are read: the softmax and the MMAs of one block
//   do not overlap; blocks on the same SM overlap each other.
//
// * float32: `swa_fwd_f32_kernel`, CUDA cores in float32. Tensor cores
//   would need three-term splits of q, k, p and v to hold the float32
//   limit (2e-5), and the serving path runs bf16, so this body keeps the
//   first design: q tile (scaled in float32) and k tile transposed in
//   shared memory, a thread owning 4 query rows x 8 key columns of the
//   score tile and 4 rows x hd/8 columns of o, probabilities through
//   shared memory into P.V.
//
// Both: rows and keys past S are zero-filled and masked, so any S works;
// W > S is full causal attention; hd 32, 64 or 128 (a template argument).
// Grids are plain products of tile and head counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 4 warps
constexpr int kPad = 4;         // f32 body: keeps float4 alignment
constexpr int kLd = kBQ + kPad; // f32 body: row stride of Qt, Kt, Pt
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> two bf16 pairs with hi + lo = (a, b) to within 2^-18 relative
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// ------------------------------------------------------- bfloat16 body

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A shared-memory matrix descriptor for wgmma: 128-byte swizzle, the
// leading and stride byte offsets as given (bytes)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// commits the wgmmas issued so far and waits for them
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders the compiler's reads and writes of an accumulator around the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d = (accumulate ? d : 0) + A . B: A 64 x 16 and B 16 x 64, both K-major
// in shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B: A 64 x 16 in registers (mma.sync's A fragments, warp w
// holding rows 16w..16w+15), B 16 x 64 N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B: A 64 x 16 in registers (mma.sync's A fragments, warp w
// holding rows 16w..16w+15), B 16 x 128 N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// An operand tile: 64 rows (queries or keys) of HP bf16 (hd padded to 64),
// as HP / 64 column blocks of 64 rows x 128 bytes, each 1024-byte group of
// 8 rows in the 128-byte swizzle (16-byte chunk c of row r at chunk
// c ^ (r % 8)) that wgmma's descriptors read. Rows past S and columns
// past hd are zero-filled.
constexpr int kAtom = 64 * 128;   // bytes of one 64-row column block

template <int HD>
__host__ __device__ constexpr int padded_hd() { return HD < 64 ? 64 : HD; }

template <int HD>
constexpr size_t smem_bf16() {   // q, 2 x k, 2 x v, and 1 KB to align
  return (size_t)5 * kAtom * (padded_hd<HD>() / 64) + 1024;
}

template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* g,
                                          long long stride, int row0, int S) {
  constexpr int kChunks = padded_hd<HD>() / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = row0 + r;
    const bool in = s < S && c < HD / 8;
    cp_async16(tile + (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               g + (in ? (long long)s * stride + c * 8 : 0), in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
swa_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                    int H, int KV, int BH, int n_qt, int window,
                    float scale_log2) {
  constexpr int HP = padded_hd<HD>();
  constexpr int TILE = kAtom * (HP / 64);
  constexpr int KS = HP / 16;   // k-steps of Q.K^T
  constexpr int DT = HP / 8;    // 8-column tiles of o
  extern __shared__ float4 smem4[];
  unsigned char* const Qs = reinterpret_cast<unsigned char*>(smem4) +
      ((1024 - (smem_addr(smem4) & 1023)) & 1023);   // swizzle atoms: 1 KB
  unsigned char* const Ks = Qs + TILE;                // [2][TILE]
  unsigned char* const Vs = Ks + 2 * TILE;            // [2][TILE]

  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;    // heaviest tiles first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const long long q_stride = (long long)H * HD;
  const long long kv_stride = (long long)KV * HD;
  const bf16* qb = q + ((long long)b * S * H + h) * HD;
  const bf16* kb = k + ((long long)b * S * KV + kvh) * HD;
  const bf16* vb = v + ((long long)b * S * KV + kvh) * HD;
  bf16* ob = o + ((long long)b * S * H + h) * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t4 = lane & 3;   // fragment row / column
  const int row0 = q0 + warp * 16 + gr;      // this thread's rows: +0, +8

  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_first / kBK, kt_hi = q_last / kBK;

  load_tile<HD>(Qs, qb, q_stride, q0, S);
  load_tile<HD>(Ks, kb, kv_stride, kt_hi * kBK, S);
  load_tile<HD>(Vs, vb, kv_stride, kt_hi * kBK, S);
  cp_async_commit();

  float acc[DT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int kt = kt_hi, it = 0; kt >= kt_lo; --kt, ++it) {
    // this tile has landed (and is visible to wgmma's reads), and every
    // warp is done with the other buffer
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int buf = it & 1;
    if (kt > kt_lo) {   // the next tile streams in while this one computes
      load_tile<HD>(Ks + (buf ^ 1) * TILE, kb, kv_stride, (kt - 1) * kBK, S);
      load_tile<HD>(Vs + (buf ^ 1) * TILE, vb, kv_stride, (kt - 1) * kBK, S);
      cp_async_commit();
    }
    const unsigned char* Kt = Ks + buf * TILE;
    const unsigned char* Vt = Vs + buf * TILE;

    // S = Q.K^T on the tensor cores: the warpgroup's 64 rows x 64 keys,
    // warp w holding rows 16w..16w+15 as mma.sync's C fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (ks >> 2) * kAtom + (ks & 3) * 32;
      wgmma_ss_n64(s, gmma_desc(Qs + off, 16, 1024),
                   gmma_desc(Kt + off, 16, 1024), ks > 0);
    }
    wg_commit_wait();
    fence_regs(s);

    // online softmax in float32: p = 2^((s - m) * scale * log2(e))
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK - 1 > q0 || k0 + kBK > S ||
                      (window > 0 && k0 + window < q0 + kBQ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t4 + e;
            if (kpos > qpos || kpos >= S ||
                (window > 0 && kpos <= qpos - window))
              s[j][2 * r + e] = -INFINITY;
          }
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float alpha = ex2(fmaf(m[r], scale_log2, -m_use));
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[j][2 * r + e], scale_log2, -m_use));
          s[j][2 * r + e] = p;
          rs += p;
        }
      l[r] = l[r] * alpha + rs;   // this thread's partial row sum
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }

    // o += P.V with P = p_hi + p_lo from registers, 16 keys a k-step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = gmma_desc(Vt + kk * 16 * 128, kAtom, 1024);
      if constexpr (HP == 64) {
        wgmma_rs_n64(acc, ph[kk], dv);
        wgmma_rs_n64(acc, pl[kk], dv);
      } else {
        wgmma_rs_n128(acc, ph[kk], dv);
        wgmma_rs_n128(acc, pl[kk], dv);
      }
    }
    wg_commit_wait();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qpos = row0 + 8 * r;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = ob + (long long)qpos * q_stride + 2 * t4;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
  }
}

// --------------------------------------------------------- float32 body

template <int HD>
constexpr size_t smem_f32() {
  return sizeof(float) *
         (size_t)(2 * HD * kLd + kBK * (HD + kPad) + kBK * kLd);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
swa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int S,
                   int H, int KV, int BH, int n_qt, int window,
                   float scale_log2) {
  constexpr int kLdv = HD + kPad;
  constexpr int NG = HD / 32;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [HD][kLd], q * scale
  float* Kt = Qt + HD * kLd;                     // [HD][kLd]
  float* Vs = Kt + HD * kLd;                     // [kBK][kLdv]
  float* Pt = Vs + kBK * kLdv;                   // [kBK][kLd]

  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;     // heaviest tiles first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const long long q_stride = (long long)H * HD;  // elements between rows
  const long long kv_stride = (long long)KV * HD;
  const float* qb = q + ((long long)b * S * H + h) * HD;
  const float* kb = k + ((long long)b * S * KV + kvh) * HD;
  const float* vb = v + ((long long)b * S * KV + kvh) * HD;
  float* ob = o + ((long long)b * S * H + h) * HD;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;      // query rows rg*4 .. rg*4+3
  const int cg = tid & 7;       // key columns cg*4+{0..3}, 32+cg*4+{0..3}

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    Qt[d * kLd + r] = s < S ? qb[(long long)s * q_stride + d] * scale_log2
                            : 0.f;
  }

  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;

  float acc[4][NG * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_first / kBK; kt <= q_last / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's readers are done (and Qt is in)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int s = k0 + c;
      const bool in = s < S;
      Kt[d * kLd + c] = in ? kb[(long long)s * kv_stride + d] : 0.f;
      Vs[c * kLdv + d] = in ? vb[(long long)s * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLd + rg * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * kLd + cg * 4]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&Kt[d * kLd + 32 + cg * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float tmax = kNegInf;
      bool valid[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4);
        valid[j] = kpos <= qpos && kpos < S &&
                   (window <= 0 || kpos > qpos - window);
        if (valid[j]) tmax = fmaxf(tmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = valid[j] ? exp2f(sc[i][j] - m_new) : 0.f;
        rsum += p[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? cg * 4 + j : 32 + cg * 4 + j - 4;
      *reinterpret_cast<float4*>(&Pt[c * kLd + rg * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[c * kLd + rg * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(
            &Vs[c * kLdv + 32 * g + cg * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], va.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], va.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], va.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], va.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + rg * 4 + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = ob + (long long)s * q_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[32 * g + cg * 4 + e] = acc[i][g * 4 + e] * inv;
  }
}

// ------------------------------------------------------------------ launch

// Raises a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
cudaError_t configure_device(Kernel kernel, size_t bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, int dtype, cudaStream_t st) {
  static bool done_bf16[kMaxDevices] = {}, done_f32[kMaxDevices] = {};
  const long long BH = (long long)B * H;
  // the band's keys, scaled by log2(e) so the softmax runs on exp2
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  cudaError_t err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const long long blocks = BH * n_qt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    // cp.async moves 16-byte chunks: every row must start on 16 bytes
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
      return (int)cudaErrorInvalidValue;
    err = configure_device(swa_fwd_bf16_kernel<HD>, smem_bf16<HD>(),
                           done_bf16);
    if (err != cudaSuccess) return (int)err;
    swa_fwd_bf16_kernel<HD><<<(unsigned int)blocks, kThreads,
                              smem_bf16<HD>(), st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, KV,
        (int)BH, n_qt, window, scale_log2);
  } else {
    err = configure_device(swa_fwd_f32_kernel<HD>, smem_f32<HD>(), done_f32);
    if (err != cudaSuccess) return (int)err;
    swa_fwd_f32_kernel<HD><<<(unsigned int)blocks, kThreads, smem_f32<HD>(),
                             st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
        KV, (int)BH, n_qt, window, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, all of one dtype
// (0: float32, 1: bfloat16; bfloat16 pointers 16-byte aligned). window
// <= 0 is full causal attention. Launches on `stream`, does not
// synchronise; returns the launch's cudaError_t (cudaErrorInvalidValue for
// a shape the kernel does not take).
int swa_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KV, int hd, int window,
                      int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, window, dtype, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, window, dtype, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, window, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
