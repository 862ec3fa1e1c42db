// Mamba-2 SSD chunked scan (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_bhsp` / `_ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:89). For each (batch, head), over
// chunks of Q steps, with the (P, N) state carried across chunks:
//   dA     = dt * A_h;  cs = cumsum(dA) within the chunk
//   y[l]   = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) dt_s x_s
//            + exp(cs_l) (C_l . carry)                (carry: state before)
//   S_c    = sum_s exp(cs_last - cs_s) dt_s x_s B_s^T (the chunk's own)
//   carry <- carry * exp(cs_last) + S_c
// from a given (B, H, P, N) float32 initial state, or from zero (a prefill).
// y in x's dtype, the final state in float32, all arithmetic in float32
// except the cumulative sums of dA: a decay exp(cs_l - cs_s) near the
// diagonal is the difference of two sums of up to 128 steps, so cs is kept
// in float64 and each difference rounded to float32 once (the plain
// version, blocks.ssd_ref, does the same; in float32 the cancellation alone
// puts ~1e-5 on y).
//
// Layout. The model's own: x and y (B, S, H, P), dt (B, S, H) float32,
// A (H,) float32, B and C (B, S, G, N) in x's dtype; the state is written
// as (B, H, P, N). Head h reads group h / (H / G), the order of jnp.repeat
// in the JAX package. No transpose to head-major layout is made.
//
// Bound. The scan reads x, dt, B, C once and writes y once; the least
// arithmetic it needs (the recurrent form, 4 flops per (step, p, n)) is
// below the bytes at every serving shape, so bytes bound it. What kept the
// first version far above that bound was its grid: one block per (batch,
// head) walking the chunks in order, 200 blocks at hymba's shape.
//
// Design: the plain version's own decomposition, over a grid of (batch,
// head, chunk) blocks, 3,200 at hymba's shape, in one launch. Each block
// stages its chunk (x, B, C with cp.async; dt, scanned in float64 while
// they land), computes its own end state S_c and decay d_c = exp(cs_last),
// then takes the carry entering its chunk from its predecessors by a
// decoupled look-back over a float32 scratch buffer: it publishes (S_c,
// d_c) behind its flag at once, sums the decayed states of the chunks
// before it back to the last window boundary's outgoing carry (or to the
// initial state), in a fixed order so calls repeat their bits, and
// publishes its own outgoing carry (the last chunk writes the final state
// instead). Blocks take their (batch,
// head, chunk) from an atomic ticket in start order, chunks innermost, so
// a block only ever waits on blocks that have started: no order of block
// scheduling can deadlock. y, which needs the carry, follows.
//
// Two bodies, one per dtype:
//
// * bfloat16 (the serving path): `ssd_scan_mma_kernel`, 4 warps on
//   `mma.sync.m16n8k16` (bf16 in, float32 accumulate). x, B, C are staged
//   in bf16 with cp.async (rows padded by 16 bytes for `ldmatrix`), and the
//   products keep float32 precision by feeding the tensor cores only exact
//   bf16 values or float32 values split into bf16 terms:
//   - C.B^T: exact bf16 inputs; N = 16 is one k-step.
//   - M.x with M = (C.B^T) * exp(cs_l - cs_s) * dt_s in float32, built a
//     16 x 16 block at a time in registers: M = m_hi + m_lo (two bf16
//     terms, 2^-18 relative) against exact bf16 x. y is rounded to bf16,
//     so that is far below its limit (one bf16 step). The exponent is
//     2^((cs_l - cs_s) log2(e) + log2(dt_s)) with the float64 sums entered
//     as float pairs: three adds and one ex2.approx an element.
//   - C.carry^T: the float32 carry split the same way (hi and lo in
//     shared memory), scaled by exp(cs_l) in float32.
//   - S_c = (w * x)^T . B with w_s = exp(cs_last - cs_s) dt_s: the state is
//     held to 3e-5 absolute and carried across chunks, so w * x is split
//     into three bf16 terms (2^-27 relative: float32 grade).
//   Warps take the chunk's 16-row blocks of y in pairs (w, 7 - w), which
//   balances the triangle; the diagonal 16 x 16 block is masked.
//
// * float32: `ssd_scan_f32_kernel`, 256 threads on the CUDA cores. Tensor
//   cores would need three-term splits of every operand to hold 3e-5, so
//   this body keeps the first version's per-chunk arithmetic (score tiles
//   of 32 rows in shared memory, y rows from them and from the carry) in
//   the same chunk-parallel grid and look-back.
//
// Any chunk length up to 128 works (125 at S = 1000), any head or group
// count, any even P and any N that shared memory holds; tiles are padded
// to 16 with zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxQ = 128;      // longest chunk
constexpr int kMmaThreads = 128;
constexpr int kF32Threads = 256;
constexpr int kRT = 32;         // f32 body: query rows per score tile
constexpr int kMaxDevices = 64;
constexpr double kLog2e = 1.4426950408889634;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// ------------------------------------------------------ shared helpers

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// The block's (batch * head, chunk), from a ticket taken in start order.
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  return ticket;
}

// Inclusive float64 scan of dA = dt * a over the chunk, by warp 0.
__device__ __forceinline__ void chunk_cumsum(const float* dtv, float a, int Q,
                                             double* cs) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int per = (Q + 31) / 32;
  const int s0 = lane * per;
  double loc[kMaxQ / 32];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < kMaxQ / 32; ++j) {
    const int s = s0 + j;
    if (j < per && s < Q) run += (double)(dtv[s] * a);
    loc[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const double base = incl - run;
#pragma unroll
  for (int j = 0; j < kMaxQ / 32; ++j) {
    const int s = s0 + j;
    if (j < per && s < Q) cs[s] = base + loc[j];
  }
}

// The look-back. Block (bh, c) publishes its own end state S_c and decay
// d_c as an aggregate (flag 1) as soon as it has them, and the carry leaving
// its chunk as an inclusive prefix (flag 2) once it has that. The carry
// entering chunk c is
//   carry_{c-1} = sum_{j<c} (d_{j+1} ... d_{c-1}) S_j  (+ the initial state)
// summed in one fixed order whatever the blocks' timing, so that every
// call gives the same bits: the inclusive prefix of chunk
// b = kWindow * floor((c - 1) / kWindow) (the initial state for chunk 0),
// then the aggregates of the chunks between, c - 1 down to b + 1, at most
// kWindow - 1 of them. Only chunks 0, kWindow, 2 kWindow, ... are read as
// inclusive prefixes, so the chain of carries waits one block per kWindow
// chunks. Warp 0 polls the window's flags, one lane a chunk, until the
// aggregates and the prefix are all published.
constexpr int kWindow = 32;
struct LookBack {
  int n, j0;            // terms in the window; the chunk before this one
  const float* src[kWindow]; // aggregates, then the inclusive prefix
  float coef[kWindow];
};

__device__ __forceinline__ void find_window(const int* flags,
                                            const float* decays,
                                            const float* aggs,
                                            const float* incls,
                                            const float* init, long long base,
                                            long long PN, LookBack* t) {
  const int lane = threadIdx.x, jj = t->j0 - lane;
  // lanes below na read aggregates, lane na the inclusive prefix (or, at
  // jj = -1, the initial state)
  const int na = t->j0 >= 0 ? t->j0 % kWindow : 0;
  const unsigned below = (1u << na) - 1u;
  while (true) {
    const int f = jj >= 0 ? ld_acquire(flags + base + jj) : 2;
    const unsigned m0 = __ballot_sync(0xffffffffu, f == 0);
    const unsigned m2 = __ballot_sync(0xffffffffu, f == 2);
    if (!(m0 & below) && (m2 >> na & 1u)) break;
    __nanosleep(20);
  }
  // the decay products d_{j+1} ... d_{c-1} weight the terms
  const float d = lane < na ? __ldcg(decays + base + jj) : 1.f;
  float inc = d;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc *= u;
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 1.f;
  if (lane <= na) {
    t->src[lane] = jj < 0 ? init
                          : (lane < na ? aggs : incls) + (base + jj) * PN;
    t->coef[lane] = exc;
  }
  __syncwarp();
  // a zero initial state adds nothing
  if (lane == 0) t->n = na + (t->j0 - na >= 0 || init != nullptr);
}

// The carry entering chunk c, then the carry leaving it (entering * decay
// + Sc, this chunk's own end state) into `out`, both P x N; keep(p, n,
// carry entering) for every (p, n) of the Pr x Nr grid (zero outside
// P x N). `init` is the initial state of this (batch, head) or null (zero).
// A thread holds 8 elements in registers, so each term's 8 loads are in
// flight together; grids above 8 elements a thread repeat the look-back
// per group of elements.
template <typename Keep>
__device__ __forceinline__ void carry_in(
    LookBack* t, const int* flags, const float* decays, const float* aggs,
    const float* incls, const float* init, long long base, int c, int P,
    int N, int Pr, int Nr, const float* Sc, float* out, float decay,
    Keep keep) {
  const long long PN = (long long)P * N;
  const int total = Pr * Nr;
  for (int i0 = threadIdx.x; i0 - (int)threadIdx.x < total;
       i0 += 8 * blockDim.x) {
    float a[8];
    int gi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = i0 + e * blockDim.x;
      const int p = i / Nr, n = i % Nr;
      gi[e] = i < total && p < P && n < N ? p * N + n : -1;
      a[e] = 0.f;
    }
    if (threadIdx.x == 0) t->j0 = c - 1;
    __syncthreads();   // t is set, and the last window read by all
    if (threadIdx.x < 32)
      find_window(flags, decays, aggs, incls, init, base, PN, t);
    __syncthreads();
    const int nt = t->n;
#pragma unroll 4
    for (int k = 0; k < nt; ++k) {
      const float* src = t->src[k];
      const float cf = t->coef[k];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gi[e] >= 0) a[e] += cf * __ldcg(src + gi[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = i0 + e * blockDim.x;
      if (i >= total) continue;
      if (gi[e] >= 0) out[gi[e]] = a[e] * decay + __ldcg(Sc + gi[e]);
      keep(i / Nr, i % Nr, gi[e] >= 0 ? a[e] : 0.f);
    }
  }
}

// Publishes slot v's aggregate (kind 1) or inclusive prefix (kind 2):
// every thread's writes before the barrier are seen by whoever acquires
// the flag.
__device__ __forceinline__ void publish(int* flags, long long v, int kind) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flags + v, kind);
}

// ---------------------------------------------------- tensor-core helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (a, b) -> bf16 pairs hi + lo = (a, b) to within 2^-18 relative
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
// (a, b) -> three bf16 pairs summing to (a, b) within 2^-27 relative
__device__ __forceinline__ void split3(float a, float b, uint32_t (&t)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  t[0] = as_u32(h);
  t[1] = as_u32(m);
  t[2] = as_u32(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
}

// rows [0, Qp) x columns [0, Cp) of a (rows, cols) operand with row
// stride `ld_src` into a bf16 tile of row stride `ld`, zero outside
// rows x cols; 16-byte cp.async when `vec` (cols % 8 == 0, aligned)
__device__ __forceinline__ void stage(bf16* tile, int ld, const bf16* src,
                                      long long ld_src, int rows, int cols,
                                      int Qp, int Cp, bool vec) {
  if (vec) {
    const int chunks = Cp / 8;
    for (int i = threadIdx.x; i < Qp * chunks; i += blockDim.x) {
      const int r = i / chunks, c8 = (i % chunks) * 8;
      const bool in = r < rows && c8 < cols;
      cp_async16(tile + r * ld + c8, src + (in ? r * ld_src + c8 : 0), in);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * Cp; i += blockDim.x) {
      const int r = i / Cp, c = i % Cp;
      tile[r * ld + c] = r < rows && c < cols ? src[r * ld_src + c]
                                              : __float2bfloat16(0.f);
    }
  }
}

// ------------------------------------------------------- bfloat16 body

size_t smem_mma(int Q, int P, int N) {
  const int Qp = pad16(Q), Pp = pad16(P), Np = pad16(N);
  return sizeof(double) * kMaxQ + sizeof(float4) * kMaxQ +
         sizeof(float) * 3 * kMaxQ +
         sizeof(bf16) * ((size_t)Qp * (Pp + 8) + 2 * (size_t)Qp * (Np + 8) +
                         2 * (size_t)Pp * (Np + 8));
}

__global__ void __launch_bounds__(kMmaThreads)
ssd_scan_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bv,
                    const bf16* __restrict__ Cv,
                    const float* __restrict__ state_in, bf16* __restrict__ y,
                    float* __restrict__ state, float* __restrict__ scratch,
                    int* __restrict__ flags, int S, int H, int G, int P, int N,
                    int Q, int nc, int vec) {
  const int Qp = pad16(Q), Pp = pad16(P), Np = pad16(N);
  const int LDX = Pp + 8, LDB = Np + 8;   // 16-byte row pads for ldmatrix
  extern __shared__ float4 smem4[];
  __shared__ LookBack look;
  double* cs = reinterpret_cast<double*>(smem4);      // [kMaxQ]
  // per step s: cs_s * log2(e) as two floats (hi, lo) and log2(dt_s)
  float4* lg = reinterpret_cast<float4*>(cs + kMaxQ); // [kMaxQ]
  float* dtv = reinterpret_cast<float*>(lg + kMaxQ);  // [kMaxQ] dt
  float* wv = dtv + kMaxQ;        // [kMaxQ] exp(cs_last - cs) * dt
  float* ecs = wv + kMaxQ;        // [kMaxQ] exp(cs)
  bf16* xs = reinterpret_cast<bf16*>(ecs + kMaxQ);    // [Qp][LDX]
  bf16* Bs = xs + Qp * LDX;       // [Qp][LDB]
  bf16* Cs = Bs + Qp * LDB;       // [Qp][LDB]
  bf16* ph = Cs + Qp * LDB;       // [Pp][LDB] carry, high bf16 term
  bf16* pl = ph + Pp * LDB;       // [Pp][LDB] carry, low bf16 term

  const int nb = (int)gridDim.x;
  const int v = take_ticket(flags + nb);
  const int bh = v / nc, c = v % nc;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;   // mma fragment row / column
  const long long PN = (long long)P * N;
  float* aggs = scratch;
  float* incls = aggs + (long long)nb * PN;
  float* decays = incls + (long long)nb * PN;

  const long long xrow = (long long)H * P;   // elements between steps
  const long long brow = (long long)G * N;
  stage(xs, LDX, x + ((long long)b * S * H + h) * P + t0 * xrow, xrow, Q, P,
        Qp, Pp, vec);
  stage(Bs, LDB, Bv + ((long long)b * S * G + g) * N + t0 * brow, brow, Q, N,
        Qp, Np, vec);
  stage(Cs, LDB, Cv + ((long long)b * S * G + g) * N + t0 * brow, brow, Q, N,
        Qp, Np, vec);
  // x, B and C stream in while dt is scanned
  for (int s = tid; s < Q; s += kMmaThreads)
    dtv[s] = dt[((long long)b * S + t0 + s) * H + h];
  __syncthreads();
  chunk_cumsum(dtv, A[h], Q, cs);
  __syncthreads();
  const double cs_last = cs[Q - 1];
  for (int s = tid; s < kMaxQ; s += kMmaThreads) {
    wv[s] = s < Q ? expf((float)(cs_last - cs[s])) * dtv[s] : 0.f;
    ecs[s] = s < Q ? expf((float)cs[s]) : 0.f;
    const double c2 = s < Q ? cs[s] * kLog2e : 0.0;
    const float hi = (float)c2;
    lg[s] = make_float4(hi, (float)(c2 - hi), s < Q ? log2f(dtv[s]) : 0.f,
                        0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  // S_c = (w * x)^T . B, w * x split into three bf16 terms, into this
  // block's aggregate slot; warp w takes the 16-row blocks p of S_c with
  // p % 4 == w, 64 columns n at a time
  float* Sc = aggs + v * PN;
  for (int mt = warp; mt < Pp / 16; mt += 4) {
    for (int n0 = 0; n0 < Np; n0 += 64) {
      const int nn = min(64, Np - n0);
      float d[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
      for (int ks = 0; ks < Qp / 16; ++ks) {
        const int s = ks * 16 + 2 * t4, p = mt * 16 + gr;
        const bf16* xr = xs + s * LDX + p;
        const float w0 = wv[s], w1 = wv[s + 1], w8 = wv[s + 8],
                    w9 = wv[s + 9];
        uint32_t a0[3], a1[3], a2[3], a3[3];
        split3(w0 * __bfloat162float(xr[0]),
               w1 * __bfloat162float(xr[LDX]), a0);
        split3(w0 * __bfloat162float(xr[8]),
               w1 * __bfloat162float(xr[LDX + 8]), a1);
        split3(w8 * __bfloat162float(xr[8 * LDX]),
               w9 * __bfloat162float(xr[9 * LDX]), a2);
        split3(w8 * __bfloat162float(xr[8 * LDX + 8]),
               w9 * __bfloat162float(xr[9 * LDX + 8]), a3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j * 16 >= nn) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, Bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDB + n0 + j * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const uint32_t af[4] = {a0[t], a1[t], a2[t], a3[t]};
            mma_bf16(d[2 * j], af, bf[0], bf[1]);
            mma_bf16(d[2 * j + 1], af, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j * 8 >= nn) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = mt * 16 + gr + (e >> 1) * 8;
          const int n = n0 + j * 8 + 2 * t4 + (e & 1);
          if (p < P && n < N) Sc[p * N + n] = d[j][e];
        }
      }
    }
  }
  const float decay = expf((float)cs_last);
  if (c > 0 && c < nc - 1) {   // the aggregate, for the chunks after this
    if (tid == 0) decays[v] = decay;
    publish(flags, v, 1);
  }
  carry_in(&look, flags, decays, aggs, incls,
           state_in ? state_in + bh * PN : nullptr, (long long)bh * nc, c,
           P, N, Pp, Np, Sc, c == nc - 1 ? state + bh * PN : incls + v * PN,
           decay,
           [&](int p, int n, float pv) {
             const bf16 hi = __float2bfloat16(pv);
             ph[p * LDB + n] = hi;
             pl[p * LDB + n] = __float2bfloat16(pv - __bfloat162float(hi));
           });
  if (c < nc - 1) publish(flags, v, 2);
  __syncthreads();

  // y: 16-row blocks of the chunk, warp w taking blocks w and 7 - w
  bf16* yb = y + ((long long)b * S * H + h) * P + t0 * xrow;
  const int n_mq = Qp / 16;
  for (int pass = 0; pass < 2; ++pass) {
    const int mt = pass == 0 ? warp : 7 - warp;
    if (mt >= n_mq) continue;
    const int l0 = mt * 16;
    const int la = l0 + gr, lb = la + 8;   // this thread's rows
    const float4 ga = lg[la], gb = lg[lb];
    for (int p0 = 0; p0 < Pp; p0 += 64) {
      const int np = min(64, Pp - p0);
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // exp(cs_l) C_l . carry^T, carry = hi + lo
      for (int ks = 0; ks < Np / 16; ++ks) {
        uint32_t cf[4];
        ldsm_x4(cf, Cs + (l0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                        ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j * 16 >= np) break;
          const int off = (p0 + j * 16 + (lane & 7) + (lane >> 4) * 8) * LDB +
                          ks * 16 + ((lane >> 3) & 1) * 8;
          uint32_t hf[4], lf[4];
          ldsm_x4(hf, ph + off);
          ldsm_x4(lf, pl + off);
          mma_bf16(acc[2 * j], cf, hf[0], hf[1]);
          mma_bf16(acc[2 * j], cf, lf[0], lf[1]);
          mma_bf16(acc[2 * j + 1], cf, hf[2], hf[3]);
          mma_bf16(acc[2 * j + 1], cf, lf[2], lf[3]);
        }
      }
      const float ea = ecs[la], eb = ecs[lb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
      // + sum_{s <= l} M[l, s] x[s], 16 columns s at a time
      for (int kb = 0; kb <= mt; ++kb) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int ks = 0; ks < Np / 16; ++ks) {
          uint32_t cf[4], bf[4];
          ldsm_x4(cf, Cs + (l0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                          ks * 16 + (lane >> 4) * 8);
          ldsm_x4(bf, Bs + (kb * 16 + (lane & 7) + (lane >> 4) * 8) * LDB +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[0], cf, bf[0], bf[1]);
          mma_bf16(sc[1], cf, bf[2], bf[3]);
        }
        // M = (C.B^T) exp(cs_l - cs_s) dt_s on s <= l, as
        // 2^((cs_l - cs_s) log2(e) + log2(dt_s)): the float64 sums enter
        // as float pairs, so the difference keeps float32 precision (below
        // 1e-6 relative on M, far below y's bf16 step). Rows past Q are
        // never written; columns past Q only meet them (s <= l).
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = kb * 16 + j * 8 + 2 * t4 + e;
            const float4 gs = lg[s];
            const float ta = (ga.x - gs.x) + ((ga.y - gs.y) + gs.z);
            const float tb = (gb.x - gs.x) + ((gb.y - gs.y) + gs.z);
            sc[j][e] *= ex2(ta);
            sc[j][2 + e] *= ex2(tb);
            if (kb == mt) {   // the diagonal block
              if (s > la) sc[j][e] = 0.f;
              if (s > lb) sc[j][2 + e] = 0.f;
            }
          }
        uint32_t mh[4], ml[4];
        split2(sc[0][0], sc[0][1], mh[0], ml[0]);
        split2(sc[0][2], sc[0][3], mh[1], ml[1]);
        split2(sc[1][0], sc[1][1], mh[2], ml[2]);
        split2(sc[1][2], sc[1][3], mh[3], ml[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j * 16 >= np) break;
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDX + p0 + j * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * j], mh, xf[0], xf[1]);
          mma_bf16(acc[2 * j], ml, xf[0], xf[1]);
          mma_bf16(acc[2 * j + 1], mh, xf[2], xf[3]);
          mma_bf16(acc[2 * j + 1], ml, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = r ? lb : la;
        if (l >= Q) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = p0 + j * 8 + 2 * t4;
          if (j * 8 < np && p < P)
            *reinterpret_cast<__nv_bfloat162*>(yb + l * xrow + p) =
                __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
        }
      }
    }
  }
}

// -------------------------------------------------------- float32 body

size_t smem_f32(int Q, int P, int N) {
  return sizeof(double) * kMaxQ +
         sizeof(float) * (size_t)(2 * kMaxQ + N * P + kRT * Q + Q * P +
                                  2 * N * (Q + 1));
}

__global__ void __launch_bounds__(kF32Threads)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bv,
                    const float* __restrict__ Cv,
                    const float* __restrict__ state_in, float* __restrict__ y,
                    float* __restrict__ state, float* __restrict__ scratch,
                    int* __restrict__ flags, int S, int H, int G, int P, int N,
                    int Q, int nc) {
  extern __shared__ float4 smem4[];
  __shared__ LookBack look;
  double* cs = reinterpret_cast<double*>(smem4); // [kMaxQ] cumsum of dA
  float* dtv = reinterpret_cast<float*>(cs + kMaxQ);   // [kMaxQ] dt
  float* wv = dtv + kMaxQ;                       // [kMaxQ] exp(cs_last-cs)*dt
  float* stT = wv + kMaxQ;                       // [N][P] carry entering
  float* Ms = stT + N * P;                       // [kRT][Q] score tile
  float* xs = Ms + kRT * Q;                      // [Q][P]
  const int ldq = Q + 1;
  float* Bt = xs + Q * P;                        // [N][Q + 1]
  float* Ct = Bt + N * ldq;                      // [N][Q + 1]

  const int nb = (int)gridDim.x;
  const int v = take_ticket(flags + nb);
  const int bh = v / nc, c = v % nc;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int half = P / 2;
  const long long t0 = (long long)c * Q;
  const long long PN = (long long)P * N;
  float* aggs = scratch;
  float* incls = aggs + (long long)nb * PN;
  float* decays = incls + (long long)nb * PN;

  const long long xrow = (long long)H * P;       // elements between steps
  const long long brow = (long long)G * N;
  const float* xb = x + ((long long)b * S * H + h) * P;
  float* yb = y + ((long long)b * S * H + h) * P;
  const float* dtb = dt + (long long)b * S * H + h;
  const float* Bb = Bv + ((long long)b * S * G + g) * N;
  const float* Cb = Cv + ((long long)b * S * G + g) * N;

  for (int s = tid; s < Q; s += kF32Threads) dtv[s] = dtb[(t0 + s) * H];
  for (int i = tid; i < Q * P; i += kF32Threads) {
    const int s = i / P, p = i % P;
    xs[i] = xb[(t0 + s) * xrow + p];
  }
  for (int i = tid; i < Q * N; i += kF32Threads) {
    const int s = i / N, n = i % N;
    const long long off = (t0 + s) * brow + n;
    Bt[n * ldq + s] = Bb[off];
    Ct[n * ldq + s] = Cb[off];
  }
  __syncthreads();
  chunk_cumsum(dtv, A[h], Q, cs);
  __syncthreads();
  const double cs_last = cs[Q - 1];
  for (int s = tid; s < Q; s += kF32Threads) {
    wv[s] = expf((float)(cs_last - cs[s])) * dtv[s];
  }
  __syncthreads();

  // this chunk's own end state S_c, in its aggregate slot
  float* Sc = aggs + v * PN;
  for (int i = tid; i < N * P; i += kF32Threads) {
    const int n = i / P, p = i % P;
    float acc = 0.f;
    for (int s = 0; s < Q; ++s) {
      acc = fmaf(xs[s * P + p] * wv[s], Bt[n * ldq + s], acc);
    }
    Sc[p * N + n] = acc;
  }
  const float decay = expf((float)cs_last);
  if (c > 0 && c < nc - 1) {
    if (tid == 0) decays[v] = decay;
    publish(flags, v, 1);
  }
  carry_in(&look, flags, decays, aggs, incls,
           state_in ? state_in + bh * PN : nullptr, (long long)bh * nc, c, P,
           N, P, N, Sc, c == nc - 1 ? state + bh * PN : incls + v * PN, decay,
           [&](int p, int n, float pv) { stT[n * P + p] = pv; });
  if (c < nc - 1) publish(flags, v, 2);

  for (int r0 = 0; r0 < Q; r0 += kRT) {
    __syncthreads();   // the carry is in; the previous rows are done
    {  // score tile: rows r0 + lg*4 + i, columns sg + 32*j
      const int lg = tid >> 5, sg = tid & 31;
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + lg * 4 + i;
          cv[i] = l < Q ? Ct[n * ldq + l] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sg + 32 * j;
          bv[j] = s < Q ? Bt[n * ldq + s] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + lg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = sg + 32 * j;
          if (s >= Q) continue;
          Ms[(lg * 4 + i) * Q + s] =
              (l < Q && s <= l)
                  ? sc[i][j] * expf((float)(cs[l] - cs[s])) * dtv[s]
                  : 0.f;
        }
      }
    }
    __syncthreads();
    // rows r0 + li0 + i of y, columns pc and pc + P/2
    for (int task = tid; task < (kRT / 4) * half; task += kF32Threads) {
      const int li0 = (task / half) * 4, pc = task % half;
      if (r0 + li0 >= Q) continue;
      float yo[4][2], yd[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) yo[i][0] = yo[i][1] = yd[i][0] = yd[i][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s0 = stT[n * P + pc], s1 = stT[n * P + pc + half];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = r0 + li0 + i;
          const float cl = l < Q ? Ct[n * ldq + l] : 0.f;
          yo[i][0] = fmaf(cl, s0, yo[i][0]);
          yo[i][1] = fmaf(cl, s1, yo[i][1]);
        }
      }
      const int s_end = min(r0 + li0 + 3, Q - 1);
      for (int s = 0; s <= s_end; ++s) {
        const float x0 = xs[s * P + pc];
        const float x1 = xs[s * P + pc + half];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mv = Ms[(li0 + i) * Q + s];
          yd[i][0] = fmaf(mv, x0, yd[i][0]);
          yd[i][1] = fmaf(mv, x1, yd[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = r0 + li0 + i;
        if (l >= Q) continue;
        const float e = expf((float)cs[l]);
        float* yrow = yb + (t0 + l) * xrow;
        yrow[pc] = yd[i][0] + e * yo[i][0];
        yrow[pc + half] = yd[i][1] + e * yo[i][1];
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// Raises a kernel's dynamic shared-memory limit to the device's opt-in
// maximum less the kernel's static shared memory (the ticket), once per
// device; returns that limit in *most.
template <typename Kernel>
cudaError_t configure_device(Kernel kernel, int* limit, int* most) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && limit[dev]) {
    *most = limit[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *most -= (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *most);
  if (err == cudaSuccess && dev < kMaxDevices) limit[dev] = *most;
  return err;
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P) and Bv, Cv: (B, S, G, N), all of one dtype
// (0: float32, 1: bfloat16); dt: (B, S, H) float32; A: (H,) float32;
// state_in (null: the zero state) and state: (B, H, P, N) float32;
// contiguous. Scratch from the caller, with nb = B*H*(S/Q) blocks:
// scratch, (2*P*N + 1)*nb float32 (aggregates, inclusive prefixes,
// decays); flags, nb + 1 int32 (zeroed here, on `stream`). Q divides S,
// Q <= 128, P even, H a multiple of G. Launches on `stream`, does not
// synchronise; returns the launch's cudaError_t (cudaErrorInvalidValue for
// a shape the kernel does not take).
int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                 const void* Bv, const void* Cv, const void* state_in,
                 void* y, void* state, void* scratch, void* flags, int B,
                 int S, int H, int G, int P, int N, int Q, int dtype,
                 void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 2 || P % 2 ||
      N < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      (long long)B * H * (S / Q) > 0x7FFFFFFFLL ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  static int limit_mma[kMaxDevices] = {}, limit_f32[kMaxDevices] = {};
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = S / Q;
  const unsigned int blocks = (unsigned int)((long long)B * H * nc);
  int most = 0;
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(int) * ((size_t)blocks + 1), st);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    err = configure_device(ssd_scan_mma_kernel, limit_mma, &most);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = smem_mma(Q, P, N);
    if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
    const int vec = P % 8 == 0 && N % 8 == 0 &&
                    !(((uintptr_t)x | (uintptr_t)Bv | (uintptr_t)Cv) & 15);
    ssd_scan_mma_kernel<<<blocks, kMmaThreads, smem, st>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bv,
        (const bf16*)Cv, (const float*)state_in, (bf16*)y, (float*)state,
        (float*)scratch, (int*)flags, S, H, G, P, N, Q, nc, vec);
  } else {
    err = configure_device(ssd_scan_f32_kernel, limit_f32, &most);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = smem_f32(Q, P, N);
    if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
    ssd_scan_f32_kernel<<<blocks, kF32Threads, smem, st>>>(
        (const float*)x, (const float*)dt, (const float*)A,
        (const float*)Bv, (const float*)Cv, (const float*)state_in,
        (float*)y, (float*)state, (float*)scratch, (int*)flags, S, H, G, P,
        N, Q, nc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
