// Single-qubit gate kernels over batched statevectors, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/statevec_gate/
// kernel.py, and the gate layer's backward:
//   * `apply_layer_planes` / `_kernel_fused_layer` (:170, :149) — TPU
//     kernel #1 — gate q acts on qubit q for all nq qubits of one layer, as
//     nq butterfly stages pairing amplitude i with i ^ (1 << q), with the
//     state resident on chip: `warp_layer_kernel` (one warp per state, dim
//     <= 2^10) and `tile_layer_kernel` (register-blocked, 2^11 to 2^13);
//   * `apply_layer_planes_tiled` / `_kernel_fused_group` (:234, :208) —
//     TPU kernel #2 — as pass 0 (`tile_layer_kernel`, register-blocked over
//     2^low-amplitude tiles, or `warp_layer_kernel` for low <= 10) plus one
//     `fused_group_kernel` pass per later qubit group;
//   * `apply_gate_planes` / `_kernel_small`, `_kernel_large` (:94, :69,
//     :82) — TPU kernel #3 — as `gate_1q_kernel`, one 2x2 gate on a qubit;
//   * the layer's backward, which the JAX package leaves to XLA
//     (src/repro/kernels/statevec_gate/ops.py:180 `_layer_bwd` replays the
//     reference under jax.vjp): `layer_bwd_kernel` and
//     `layer_grad_reduce_kernel`.
//
// Layout. States are float32 (re, im) planes of shape (G, S, 2^nq), row-major
// and contiguous; gates are packed as 8 float32 reals
// [g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i], one set per group g
// (row (g, s) takes set g), `gate_stride` floats apart. The VQC's ansatz
// layers run with G = clients and S = batch, its per-sample encoding layer
// with G = clients * batch and S = 1; the parameter-shift branch stacks with
// G = clients and S = 2 * nq * batch.
//
// Bound. A butterfly does 28 flops per amplitude pair, far below the card's
// float32 rate, so every kernel here is bound by bytes: both planes read
// once and written once per pass, 16 B per amplitude (plus the gates); the
// backward reads the input and the cotangent and writes the cotangent,
// 24 B per amplitude.
//
// Kernel #1, dim <= 2^10: one warp per state (several states per warp
// below 2^6). The amplitudes live in registers, R = dim / 32 contiguous
// ones per lane, loaded and stored as float4 (float2 at R = 2): qubits
// below log2(R) are butterflies inside a thread, the rest pair lanes with
// __shfl_xor_sync. No shared memory, no block barrier; each lane divides
// its row by S once. The ansatz shape (64, 32, 2^8) is 2,048 warps, the
// shift rule's suffix (64, 512, 2^8) 32,768.
//
// Kernel #1, 2^11 to 2^13, and pass 0 of kernel #2: one block a state (or a
// 2^low-amplitude tile), register-blocked (`tile_layer_kernel`): each of
// 2^(m-5) threads holds 32 amplitudes, applies 5 qubits in registers, and
// exchanges through shared memory padded by one word in 32 (no bank
// conflicts in any of the three layouts): three register rounds and two
// exchanges instead of 13 barrier-separated shared-memory stages.
//
// Kernel #2. Past 2^13 amplitudes a state no longer fits a block, so the
// layer takes one pass over memory per qubit group, as on the TPU. Pass 0
// applies qubits [0, low) to each 2^low-amplitude tile of the (G,
// S * 2^nq / 2^low, 2^low) view with kernel #1's bodies.
// A later group of gs qubits [q0, q0 + gs) views the state as (hi, 2^gs,
// 2^q0): a block stages a (2^gs, tc) tile of that view — tc consecutive
// lanes of each of the 2^gs rows, so each row segment is a coalesced
// tc * 4 B read — runs the gs stages in shared memory and writes the tile
// back. tc is at most 2^13 / 2^gs lanes (64 at gs = 7), so a tile is at most
// 64 KB and three blocks fit an SM. The wrapper's `group_tile` is an upper
// bound on tc.
//
// Kernel #3. One thread per amplitude pair computes
// i0 = ((j >> q) << (q + 1)) | (j & (lo - 1)) and i1 = i0 | lo, which covers
// both of the TPU kernel's regimes (stride inside or across VMEM tiles).
//
// The backward. The gates of one layer act on different qubits, so they
// commute: gate q's cotangent pairs the cotangent at its output with its
// input, whichever side the other gates stand on. The backward splits the
// register into passes — a low pass of qubits [0, m0), m0 <= 8, then column
// passes of at most 3 qubits — recomputes each pass's input with the
// forward bodies (every pass but the last), and runs the passes in reverse.
// A pass holds a unit's 2^m amplitudes of the input u and the cotangent v in
// registers (the low pass one warp per 2^m0 chunk, as kernel #1; a column
// pass one thread per (hi, lane) column of the (hi, 2^gs, 2^q0) view, so its
// qubits are all inside a thread and its loads coalesce over the lanes). One
// forward sweep keeps every gate's input in registers (m copies of the
// unit: the pass sizes keep that at 128 floats); then for gate j, last to
// first, it pairs gate j's input with v (the math of ref.gate_grad) and
// applies gate j's adjoint to v. No gate is ever
// inverted, so any 2x2 gate works. Each gate's 8 sums are reduced over the
// warp in 9 shuffles, over the block's warps in shared memory in a fixed
// order, and written as one partial per block; a block's units all belong
// to one group. `layer_grad_reduce_kernel` sums each group's partials in
// order, in double. No float atomics: a call is bit-identical from run to
// run.
//
// The shared-memory limits are raised once per device, to the most any
// launch needs, not by a CUDA API call before every launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQubits = 13;
// the largest state of the warp-per-state body (32 amplitudes a lane)
constexpr int kWarpQubits = 10;
// the backward's passes: a low pass of at most kBwdLowQubits qubits, column
// passes of at most kBwdColQubits (each gate's input kept in registers)
constexpr int kBwdLowQubits = 8;
constexpr int kBwdColQubits = 3;
constexpr int kMaxPasses = 16;
constexpr int kMaxDevices = 64;
// amplitudes of one group-pass tile (2^gs rows x tc lanes): 64 KB for both
// planes
constexpr long long kGroupAmps = 8192;
// blocks of the single-gate kernel's grid; a grid-stride loop covers more
constexpr long long kMaxGridBlocks = 1LL << 20;
constexpr unsigned kFull = 0xffffffffu;

// padded words of one plane of a register-blocked tile
__host__ __device__ constexpr int tile_words(int m) {
  return (1 << m) + ((1 << m) >> 5);
}

struct Gate {
  float r00, i00, r01, i01, r10, i10, r11, i11;
};

__device__ __forceinline__ Gate load_gate(const float* __restrict__ p) {
  Gate g;
  g.r00 = __ldg(p + 0); g.i00 = __ldg(p + 1);
  g.r01 = __ldg(p + 2); g.i01 = __ldg(p + 3);
  g.r10 = __ldg(p + 4); g.i10 = __ldg(p + 5);
  g.r11 = __ldg(p + 6); g.i11 = __ldg(p + 7);
  return g;
}

// the conjugate transpose (ref.adjoint_gate8)
__device__ __forceinline__ Gate adjoint(const Gate& g) {
  return {g.r00, -g.i00, g.r10, -g.i10, g.r01, -g.i01, g.r11, -g.i11};
}

// (a0, a1) <- g (a0, a1)
__device__ __forceinline__ void butterfly(const Gate& g, float& a0r,
                                          float& a0i, float& a1r,
                                          float& a1i) {
  const float y0r = g.r00 * a0r - g.i00 * a0i + g.r01 * a1r - g.i01 * a1i;
  const float y0i = g.r00 * a0i + g.i00 * a0r + g.r01 * a1i + g.i01 * a1r;
  const float y1r = g.r10 * a0r - g.i10 * a0i + g.r11 * a1r - g.i11 * a1i;
  const float y1i = g.r10 * a0i + g.i10 * a0r + g.r11 * a1i + g.i11 * a1r;
  a0r = y0r; a0i = y0i; a1r = y1r; a1i = y1i;
}

// A unit of 2^M amplitudes held by 2^W lanes, R = 2^(M - W) registers each:
// bit s < M - W of an amplitude's index is register bit s, bit s >= M - W is
// lane bit s - (M - W). Every loop below is unrolled with constant indices,
// so the register arrays stay in registers.
template <int R>
__device__ __forceinline__ void gate_in_thread(float (&xr)[R], float (&xi)[R],
                                               int s, const Gate& g) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j & (1 << s)) continue;
    const int k = j | (1 << s);
    butterfly(g, xr[j], xi[j], xr[k], xi[k]);
  }
}

// gate on a lane bit: each lane holds one side of every pair, the other
// side arrives by shuffle (`hi`: this lane holds the 1-side)
template <int R>
__device__ __forceinline__ void gate_across_lanes(float (&xr)[R],
                                                  float (&xi)[R], int mask,
                                                  bool hi, const Gate& g) {
  const float cor = hi ? g.r11 : g.r00, coi = hi ? g.i11 : g.i00;
  const float cxr = hi ? g.r10 : g.r01, cxi = hi ? g.i10 : g.i01;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float br = __shfl_xor_sync(kFull, xr[j], mask);
    const float bi = __shfl_xor_sync(kFull, xi[j], mask);
    const float ar = xr[j], ai = xi[j];
    xr[j] = cor * ar - coi * ai + cxr * br - cxi * bi;
    xi[j] = cor * ai + coi * ar + cxr * bi + cxi * br;
  }
}

template <int M, int W>
__device__ __forceinline__ void apply_qubit(float (&xr)[1 << (M - W)],
                                            float (&xi)[1 << (M - W)], int q,
                                            int sl, const Gate& g) {
  constexpr int T = M - W;
  if (q < T) {
    gate_in_thread(xr, xi, q, g);
  } else {
    gate_across_lanes(xr, xi, 1 << (q - T), (sl >> (q - T)) & 1, g);
  }
}

// Gate q's cotangent (ref.gate_grad) from its input w and the cotangent v
// at its output, this thread's share: acc[2(2a + b)] += Re(conj(v_a) w_b),
// acc[2(2a + b) + 1] += Im(conj(v_a) w_b) over the pairs (a, b the bit q).
template <int M, int W>
__device__ __forceinline__ void pair_qubit(const float (&wr)[1 << (M - W)],
                                           const float (&wi)[1 << (M - W)],
                                           const float (&vr)[1 << (M - W)],
                                           const float (&vi)[1 << (M - W)],
                                           int q, int sl, float (&acc)[8]) {
  constexpr int T = M - W;
  constexpr int R = 1 << T;
  if (q < T) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & (1 << q)) continue;
      const int k = j | (1 << q);
      acc[0] += vr[j] * wr[j] + vi[j] * wi[j];
      acc[1] += vi[j] * wr[j] - vr[j] * wi[j];
      acc[2] += vr[j] * wr[k] + vi[j] * wi[k];
      acc[3] += vi[j] * wr[k] - vr[j] * wi[k];
      acc[4] += vr[k] * wr[j] + vi[k] * wi[j];
      acc[5] += vi[k] * wr[j] - vr[k] * wi[j];
      acc[6] += vr[k] * wr[k] + vi[k] * wi[k];
      acc[7] += vi[k] * wr[k] - vr[k] * wi[k];
    }
  } else {
    // this lane holds side a of each pair for both v and w; the other
    // side of w arrives by shuffle. Side a contributes row a of the gate.
    const int mask = 1 << (q - T);
    const bool hi = (sl >> (q - T)) & 1;
    float same_r = 0.f, same_i = 0.f, other_r = 0.f, other_i = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float xr = __shfl_xor_sync(kFull, wr[j], mask);
      const float xi = __shfl_xor_sync(kFull, wi[j], mask);
      same_r += vr[j] * wr[j] + vi[j] * wi[j];
      same_i += vi[j] * wr[j] - vr[j] * wi[j];
      other_r += vr[j] * xr + vi[j] * xi;
      other_i += vi[j] * xr - vr[j] * xi;
    }
    // a = 0: (0,0) same, (0,1) other; a = 1: (1,0) other, (1,1) same
    acc[0] += hi ? 0.f : same_r;
    acc[1] += hi ? 0.f : same_i;
    acc[2] += hi ? 0.f : other_r;
    acc[3] += hi ? 0.f : other_i;
    acc[4] += hi ? other_r : 0.f;
    acc[5] += hi ? other_i : 0.f;
    acc[6] += hi ? same_r : 0.f;
    acc[7] += hi ? same_i : 0.f;
  }
}

// Sums a[0..7] over the warp's 32 lanes in 9 shuffles: each of the first
// three levels sends half of what a lane still holds and keeps the other
// half, the last two add whole values. Lane l ends with the total of entry
// 4 * bit4(l) + 2 * bit3(l) + bit2(l); the order is fixed.
__device__ __forceinline__ float warp_sum8(const float (&a)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float k[4], m[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? a[i] : a[i + 4];
    k[i] = (b4 ? a[i + 4] : a[i]) + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? k[i] : k[i + 2];
    m[i] = (b3 ? k[i + 2] : k[i]) + __shfl_xor_sync(kFull, send, 8);
  }
  float r = (b2 ? m[1] : m[0]) + __shfl_xor_sync(kFull, b2 ? m[0] : m[1], 4);
  r += __shfl_xor_sync(kFull, r, 2);
  r += __shfl_xor_sync(kFull, r, 1);
  return r;
}

// R contiguous floats (R a power of two >= 2; p aligned to 8 * R bytes,
// up to 16): float4 or float2 accesses
template <int R>
__device__ __forceinline__ void load_run(float (&x)[R],
                                         const float* __restrict__ p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + j));
      x[j] = t.x; x[j + 1] = t.y; x[j + 2] = t.z; x[j + 3] = t.w;
    }
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  }
}

template <int R>
__device__ __forceinline__ void store_run(const float (&x)[R], float* p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      *reinterpret_cast<float4*>(p + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    }
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// Kernel #1 for dim = 2^M <= 2^10 (and pass 0 of kernel #2 at low <= 10):
// one warp per state, 2^W lanes per state, R amplitudes a lane.
template <int M>
__global__ void __launch_bounds__(kThreads)
warp_layer_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ gates, float* __restrict__ out_re,
                  float* __restrict__ out_im, long long total_rows,
                  int states_per_group, int gate_stride) {
  constexpr int W = M - 1 < 5 ? M - 1 : 5;
  constexpr int R = 1 << (M - W);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t >> W;
  const int sl = threadIdx.x & ((1 << W) - 1);
  // lanes past the last row still take part in the shuffles, on zeros
  const bool live = row < total_rows;
  const long long base = (row << M) + (long long)sl * R;
  float xr[R], xi[R];
  if (live) {
    load_run(xr, re + base);
    load_run(xi, im + base);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) xr[j] = xi[j] = 0.f;
  }
  const float* gg =
      gates + (live ? row / states_per_group : 0) * (long long)gate_stride;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    apply_qubit<M, W>(xr, xi, q, sl, load_gate(gg + q * 8));
  }
  if (live) {
    store_run(xr, out_re + base);
    store_run(xi, out_im + base);
  }
}

// Kernel #1 at 2^11..2^13 and pass 0 of kernel #2 at low = M in 11..13,
// register-blocked: block b takes tile b (2^M amplitudes), 2^(M-5) threads
// of 32 amplitudes each. Round layout `base`: register j of thread tid
// holds amplitude
// (tid & (2^base - 1)) | (j << base) | ((tid >> base) << (base + 5)), so the
// round's qubits [base, base + 5) are register bits. Rounds at base 0, 5 and
// M - 5 apply qubits [0, 5), [5, 10) and [10, M); the first loads with
// float4, the last stores coalesced scalars.
__device__ __forceinline__ int tile_index(int tid, int j, int base) {
  return (tid & ((1 << base) - 1)) | (j << base) |
         ((tid >> base) << (base + 5));
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ void tile_exchange(float (&xr)[32], float (&xi)[32],
                                              float* sre, float* sim, int tid,
                                              int from, int to) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = padded(tile_index(tid, j, from));
    sre[i] = xr[j];
    sim[i] = xi[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int i = padded(tile_index(tid, j, to));
    xr[j] = sre[i];
    xi[j] = sim[i];
  }
  __syncthreads();
}

template <int M>
__global__ void __launch_bounds__(1 << (M - 5))
tile_layer_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ gates, float* __restrict__ out_re,
                  float* __restrict__ out_im, int states_per_group,
                  int gate_stride) {
  extern __shared__ float smem[];
  float* sre = smem;
  float* sim = smem + tile_words(M);
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long base = tile << M;
  const float* gg = gates + (tile / states_per_group) * (long long)gate_stride;
  float xr[32], xi[32];
  load_run(xr, re + base + tid * 32);
  load_run(xi, im + base + tid * 32);
#pragma unroll
  for (int q = 0; q < 5; ++q) gate_in_thread(xr, xi, q, load_gate(gg + q * 8));
  tile_exchange(xr, xi, sre, sim, tid, 0, 5);
#pragma unroll
  for (int q = 5; q < 10; ++q) {
    gate_in_thread(xr, xi, q - 5, load_gate(gg + q * 8));
  }
  tile_exchange(xr, xi, sre, sim, tid, 5, M - 5);
#pragma unroll
  for (int q = 10; q < M; ++q) {
    gate_in_thread(xr, xi, q - (M - 5), load_gate(gg + q * 8));
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const long long a = base + tile_index(tid, j, M - 5);
    out_re[a] = xr[j];
    out_im[a] = xi[j];
  }
}

// One qubit group of the tiled layer (kernel #2, passes after the first):
// stages gs = `gs` of the (hi, 2^gs, lo = 2^q0) view over (2^gs, tc) tiles.
// Block b takes row h = b / (lo / tc) of the view and lanes
// [t * tc, (t + 1) * tc), t = b % (lo / tc). Stage s pairs middle indices
// differing in bit s; threads walk the pairs lane-fastest, so a warp's
// shared-memory accesses fall on consecutive words.
__global__ void fused_group_kernel(const float* __restrict__ re,
                                   const float* __restrict__ im,
                                   const float* __restrict__ gates,
                                   float* __restrict__ out_re,
                                   float* __restrict__ out_im,
                                   long long hi_per_group, int gate_stride,
                                   int q0, int gs, int tc_shift) {
  extern __shared__ float smem[];
  const int mid = 1 << gs;
  const int tc = 1 << tc_shift;
  const int n = mid << tc_shift;
  const long long lo = 1LL << q0;
  const long long nt = lo >> tc_shift;
  const long long h = (long long)blockIdx.x / nt;
  const long long t = (long long)blockIdx.x - h * nt;
  const long long base = h * (lo << gs) + t * tc;
  float* sre = smem;
  float* sim = smem + n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long a = base + (long long)(i >> tc_shift) * lo + (i & (tc - 1));
    sre[i] = re[a];
    sim[i] = im[a];
  }
  __syncthreads();

  const float* gg = gates + (h / hi_per_group) * gate_stride + q0 * 8;
  const int n_pairs = n >> 1;
  for (int s = 0; s < gs; ++s) {
    const float* g = gg + s * 8;
    const float g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3];
    const float g4 = g[4], g5 = g[5], g6 = g[6], g7 = g[7];
    const int in = 1 << s;
    for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
      const int jm = p >> tc_shift;
      const int m0 = ((jm >> s) << (s + 1)) | (jm & (in - 1));
      const int i0 = (m0 << tc_shift) | (p & (tc - 1));
      const int i1 = i0 + (in << tc_shift);
      const float a0r = sre[i0], a0i = sim[i0];
      const float a1r = sre[i1], a1i = sim[i1];
      sre[i0] = g0 * a0r - g1 * a0i + g2 * a1r - g3 * a1i;
      sim[i0] = g0 * a0i + g1 * a0r + g2 * a1i + g3 * a1r;
      sre[i1] = g4 * a0r - g5 * a0i + g6 * a1r - g7 * a1i;
      sim[i1] = g4 * a0i + g5 * a0r + g6 * a1i + g7 * a1r;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long a = base + (long long)(i >> tc_shift) * lo + (i & (tc - 1));
    out_re[a] = sre[i];
    out_im[a] = sim[i];
  }
}

// One 2x2 gate on qubit q (kernel #3): one thread per amplitude pair, over
// (G, S, 2^nq) planes; pair p lies in row p >> (nq - 1), which takes gate
// set row / S.
__global__ void gate_1q_kernel(const float* __restrict__ re,
                               const float* __restrict__ im,
                               const float* __restrict__ gates,
                               float* __restrict__ out_re,
                               float* __restrict__ out_im,
                               long long total_pairs, int states_per_group,
                               int nq, int q) {
  const long long half = 1LL << (nq - 1);
  const long long lo = 1LL << q;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total_pairs; p += stride) {
    const long long row = p >> (nq - 1);
    const long long j = p & (half - 1);
    const long long i0 = (row << nq) + (((j >> q) << (q + 1)) | (j & (lo - 1)));
    const long long i1 = i0 + lo;
    const float* g = gates + (row / states_per_group) * 8;
    const float a0r = re[i0], a0i = im[i0];
    const float a1r = re[i1], a1i = im[i1];
    out_re[i0] = g[0] * a0r - g[1] * a0i + g[2] * a1r - g[3] * a1i;
    out_im[i0] = g[0] * a0i + g[1] * a0r + g[2] * a1i + g[3] * a1r;
    out_re[i1] = g[4] * a0r - g[5] * a0i + g[6] * a1r - g[7] * a1i;
    out_im[i1] = g[4] * a0i + g[5] * a0r + g[6] * a1i + g[7] * a1r;
  }
}

// The backward of one pass over M qubits (see the header). Block b covers
// units [blk * U, (blk + 1) * U) of group g = b / blocks_per_group, blk =
// b % blocks_per_group, U = kThreads >> W units a block.
//   column = false: a unit is a row of the (G, units_per_group, 2^M) view
//     (the low pass, q0 = 0), held by 2^W lanes of R contiguous amplitudes;
//   column = true (W = 0): a unit is a column (h, l) of the (hi, 2^M, 2^q0)
//     view, h = unit >> q0, l = unit & (2^q0 - 1), one thread of R = 2^M.
// u: the pass's input; v: the cotangent at its output; out: the cotangent
// at its input (written if need_state); partial[b][j][8]: gate q0 + j's
// cotangent summed over the block (written if need_gate).
// The 8-qubit low pass keeps 8 inputs of 8 amplitudes a lane: 195
// registers unbounded, so one block an SM; it is held to two blocks an SM
// (128 registers, a few spilled to L1), the faster of the two.
template <int M, int W, bool kColumn>
__global__ void __launch_bounds__(kThreads, M >= 8 ? 2 : 1)
layer_bwd_kernel(const float* __restrict__ u_re, const float* __restrict__ u_im,
                 const float* __restrict__ gates,
                 const float* __restrict__ v_re, const float* __restrict__ v_im,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 float* __restrict__ partial, long long units_per_group,
                 int blocks_per_group, int q0, int gate_stride,
                 int need_state, int need_gate) {
  constexpr int R = 1 << (M - W);
  constexpr int kWarps = kThreads / 32;
  // every gate's input is kept in registers: M copies of the unit
  static_assert(M * 2 * R <= 128, "a pass keeps at most 128 floats of inputs");
  __shared__ float red[kWarps][M * 8];
  const long long g = blockIdx.x / blocks_per_group;
  const long long blk = blockIdx.x - g * blocks_per_group;
  const long long unit = blk * (kThreads >> W) + (threadIdx.x >> W);
  const int sl = threadIdx.x & ((1 << W) - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = unit < units_per_group;
  const long long gu = g * units_per_group + unit;
  long long base, step;
  if (kColumn) {
    base = ((gu >> q0) << (q0 + M)) + (gu & ((1LL << q0) - 1));
    step = 1LL << q0;
  } else {
    base = (gu << M) + (long long)sl * R;
    step = 1;
  }
  float vr[R], vi[R], ur[R], ui[R];
#pragma unroll
  for (int j = 0; j < R; ++j) vr[j] = vi[j] = ur[j] = ui[j] = 0.f;
  if (live) {
    if (kColumn) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        vr[j] = v_re[base + j * step];
        vi[j] = v_im[base + j * step];
        if (need_gate) {
          ur[j] = u_re[base + j * step];
          ui[j] = u_im[base + j * step];
        }
      }
    } else {
      load_run(vr, v_re + base);
      load_run(vi, v_im + base);
      if (need_gate) {
        load_run(ur, u_re + base);
        load_run(ui, u_im + base);
      }
    }
  }
  const float* gg = gates + g * gate_stride + q0 * 8;
  // gate j's cotangent, reduced over the warp: lanes with bits 1 and 0
  // clear hold the 8 entries (warp_sum8) and write them to red
  auto reduce_gate = [&](int j, const float (&acc)[8]) {
    const float t = warp_sum8(acc, lane);
    if ((lane & 3) == 0) {
      red[warp][j * 8 + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                ((lane >> 2) & 1)] = t;
    }
  };
  // forward through the pass once, keeping every gate's input
  float sr[M][R], si[M][R];
  if (need_gate) {
#pragma unroll
    for (int k = 0; k < R; ++k) { sr[0][k] = ur[k]; si[0][k] = ui[k]; }
#pragma unroll
    for (int q = 0; q + 1 < M; ++q) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        sr[q + 1][k] = sr[q][k];
        si[q + 1][k] = si[q][k];
      }
      apply_qubit<M, W>(sr[q + 1], si[q + 1], q, sl, load_gate(gg + q * 8));
    }
  }
#pragma unroll
  for (int j = M - 1; j >= 0; --j) {
    if (need_gate) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      pair_qubit<M, W>(sr[j], si[j], vr, vi, j, sl, acc);
      reduce_gate(j, acc);
    }
    apply_qubit<M, W>(vr, vi, j, sl, adjoint(load_gate(gg + j * 8)));
  }
  if (need_state && live) {
    if (kColumn) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        out_re[base + j * step] = vr[j];
        out_im[base + j * step] = vi[j];
      }
    } else {
      store_run(vr, out_re + base);
      store_run(vi, out_im + base);
    }
  }
  if (need_gate) {
    __syncthreads();
    for (int i = threadIdx.x; i < M * 8; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][i];
      partial[(long long)blockIdx.x * (M * 8) + i] = s;
    }
  }
}

// the passes of one backward, as the reduce kernel reads them: pass p's
// partials start at off[p], (n_groups, per_group[p], m[p], 8), for qubits
// [q0[p], q0[p] + m[p])
struct PassTable {
  long long off[kMaxPasses];
  int per_group[kMaxPasses];
  int q0[kMaxPasses];
  int m[kMaxPasses];
  int n;
};

// out[g][q][c] = the sum of pass p's partials of group g for qubit q, in
// order and in double (one thread per output)
__global__ void layer_grad_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ out,
                                         long long n_groups, int nq,
                                         PassTable tab) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_groups * nq * 8) return;
  const long long g = idx / (nq * 8);
  const int q = (int)((idx >> 3) % nq);
  const int c = (int)(idx & 7);
  int p = 0;
  while (p + 1 < tab.n && q >= tab.q0[p + 1]) ++p;
  const int m = tab.m[p], per = tab.per_group[p];
  const float* src = partial + tab.off[p] + g * per * (long long)(m * 8) +
                     (q - tab.q0[p]) * 8 + c;
  double s = 0.0;
  for (int i = 0; i < per; ++i) s += src[(long long)i * m * 8];
  out[idx] = (float)s;
}

// Raises the dynamic shared-memory limits of the tile and group kernels on
// the current device to the most any launch needs, once per device.
cudaError_t configure_device() {
  static int done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fused_group_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * kGroupAmps));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tile_layer_kernel<11>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * tile_words(11)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tile_layer_kernel<12>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * tile_words(12)));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tile_layer_kernel<13>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * tile_words(13)));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = 1;
  return err;
}

typedef void (*WarpLayerFn)(const float*, const float*, const float*, float*,
                            float*, long long, int, int);

WarpLayerFn warp_layer_fn(int m) {
  switch (m) {
    case 1: return warp_layer_kernel<1>;
    case 2: return warp_layer_kernel<2>;
    case 3: return warp_layer_kernel<3>;
    case 4: return warp_layer_kernel<4>;
    case 5: return warp_layer_kernel<5>;
    case 6: return warp_layer_kernel<6>;
    case 7: return warp_layer_kernel<7>;
    case 8: return warp_layer_kernel<8>;
    case 9: return warp_layer_kernel<9>;
    case 10: return warp_layer_kernel<10>;
    default: return nullptr;
  }
}

// lanes of one state in the warp body: 2^W
int warp_lane_bits(int m) { return m - 1 < 5 ? m - 1 : 5; }

cudaError_t launch_warp_layer(const float* re, const float* im,
                              const float* gates, float* out_re, float* out_im,
                              long long total_rows, int states_per_group,
                              int m, int gate_stride, cudaStream_t stream) {
  const long long threads = total_rows << warp_lane_bits(m);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  warp_layer_fn(m)<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      re, im, gates, out_re, out_im, total_rows, states_per_group,
      gate_stride);
  return cudaGetLastError();
}

typedef void (*BwdFn)(const float*, const float*, const float*, const float*,
                      const float*, float*, float*, float*, long long, int,
                      int, int, int, int);

BwdFn bwd_fn(int m, int column) {
  if (column) {
    switch (m) {
      case 1: return layer_bwd_kernel<1, 0, true>;
      case 2: return layer_bwd_kernel<2, 0, true>;
      case 3: return layer_bwd_kernel<3, 0, true>;
      default: return nullptr;
    }
  }
  switch (m) {
    case 1: return layer_bwd_kernel<1, 0, false>;
    case 2: return layer_bwd_kernel<2, 1, false>;
    case 3: return layer_bwd_kernel<3, 2, false>;
    case 4: return layer_bwd_kernel<4, 3, false>;
    case 5: return layer_bwd_kernel<5, 4, false>;
    case 6: return layer_bwd_kernel<6, 5, false>;
    case 7: return layer_bwd_kernel<7, 5, false>;
    case 8: return layer_bwd_kernel<8, 5, false>;
    default: return nullptr;
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.

// Kernel #1, and pass 0 of kernel #2: gate q on qubit q for q < nq over
// (n_groups, states_per_group, 2^nq) planes (for pass 0, nq = low and the
// rows are the state's 2^low-amplitude tiles); group g's gates start at
// gates + g * gate_stride. nq <= 10 runs the warp body, 11..13 the
// register-blocked body.
extern "C" int statevec_gate_layer(const float* re, const float* im,
                                   const float* gates, float* out_re,
                                   float* out_im, long long n_groups,
                                   int states_per_group, int nq,
                                   int gate_stride, void* stream) {
  if (nq < 1 || nq > kMaxQubits || n_groups < 1 || states_per_group < 1 ||
      gate_stride < nq * 8) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = n_groups * (long long)states_per_group;
  if (nq <= kWarpQubits) {
    return (int)launch_warp_layer(re, im, gates, out_re, out_im, rows,
                                  states_per_group, nq, gate_stride,
                                  (cudaStream_t)stream);
  }
  cudaError_t err = configure_device();
  if (err != cudaSuccess) return (int)err;
  if (rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2 * sizeof(float) * tile_words(nq);
  const unsigned int grid = (unsigned int)rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 11) {
    tile_layer_kernel<11><<<grid, 1 << 6, smem, s>>>(
        re, im, gates, out_re, out_im, states_per_group, gate_stride);
  } else if (nq == 12) {
    tile_layer_kernel<12><<<grid, 1 << 7, smem, s>>>(
        re, im, gates, out_re, out_im, states_per_group, gate_stride);
  } else {
    tile_layer_kernel<13><<<grid, 1 << 8, smem, s>>>(
        re, im, gates, out_re, out_im, states_per_group, gate_stride);
  }
  return (int)cudaGetLastError();
}

// Kernel #2, one group pass: qubits [q0, q0 + gs) of (n_hi, 2^gs, 2^q0)
// planes in (2^gs, 2^tc_shift) tiles; view row h takes gate set
// h / hi_per_group, whose gate for qubit q0 + s is at
// gates + set * gate_stride + (q0 + s) * 8.
extern "C" int statevec_gate_group(const float* re, const float* im,
                                   const float* gates, float* out_re,
                                   float* out_im, long long n_hi,
                                   long long hi_per_group, int gate_stride,
                                   int q0, int gs, int tc_shift,
                                   void* stream) {
  if (gs < 1 || q0 < 0 || tc_shift < 0 || tc_shift > q0 || n_hi < 1 ||
      hi_per_group < 1 || (1LL << (gs + tc_shift)) > kGroupAmps ||
      gate_stride < (q0 + gs) * 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = configure_device();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = n_hi << (q0 - tc_shift);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = 2 * sizeof(float) * ((size_t)1 << (gs + tc_shift));
  fused_group_kernel<<<(unsigned int)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      re, im, gates, out_re, out_im, hi_per_group, gate_stride, q0, gs,
      tc_shift);
  return (int)cudaGetLastError();
}

// Kernel #3: gate set g (8 floats at gates + g * 8) on qubit q of every row
// of group g, over (n_groups, states_per_group, 2^nq) planes.
extern "C" int statevec_gate_1q(const float* re, const float* im,
                                const float* gates, float* out_re,
                                float* out_im, long long n_groups,
                                int states_per_group, int nq, int q,
                                void* stream) {
  if (nq < 1 || nq > 62 || q < 0 || q >= nq || n_groups < 1 ||
      states_per_group < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total_pairs =
      (n_groups * (long long)states_per_group) << (nq - 1);
  long long blocks = (total_pairs + kThreads - 1) / kThreads;
  if (blocks > kMaxGridBlocks) blocks = kMaxGridBlocks;   // grid-stride loop
  gate_1q_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      re, im, gates, out_re, out_im, total_pairs, states_per_group, nq, q);
  return (int)cudaGetLastError();
}

// The layer backward, one pass over qubits [q0, q0 + m): column = 0 is the
// low pass (q0 = 0, m <= 8, a unit is a 2^m-amplitude row), column = 1 a
// column pass (m <= 3). units_per_group units of each of n_groups groups,
// blocks_per_group blocks a group (units_per_block = 256 >> lane bits for
// the low pass, 256 for a column pass); partial holds n_groups *
// blocks_per_group * m * 8 floats.
extern "C" int statevec_gate_layer_bwd(
    const float* u_re, const float* u_im, const float* gates,
    const float* v_re, const float* v_im, float* out_re, float* out_im,
    float* partial, long long n_groups, long long units_per_group,
    int blocks_per_group, int q0, int m, int gate_stride, int column,
    int need_state, int need_gate, void* stream) {
  const BwdFn fn = bwd_fn(m, column);
  const int lane_bits = column ? 0 : warp_lane_bits(m);
  if (fn == nullptr || m > (column ? kBwdColQubits : kBwdLowQubits) ||
      n_groups < 1 || units_per_group < 1 || q0 < 0 ||
      (!column && q0 != 0) || gate_stride < (q0 + m) * 8 ||
      (long long)blocks_per_group * (kThreads >> lane_bits) <
          units_per_group ||
      (need_state && (out_re == nullptr || out_im == nullptr)) ||
      (need_gate && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = n_groups * (long long)blocks_per_group;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u_re, u_im, gates, v_re, v_im, out_re, out_im, partial,
      units_per_group, blocks_per_group, q0, gate_stride, need_state,
      need_gate);
  return (int)cudaGetLastError();
}

// The gate cotangent (n_groups, nq, 8) from the partials of n_pass passes;
// desc holds (offset, blocks_per_group, q0, m) of each pass, in qubit
// order, 4 int64 each.
extern "C" int statevec_gate_grad_reduce(const float* partial, float* out,
                                         long long n_groups, int nq,
                                         int n_pass, const long long* desc,
                                         void* stream) {
  if (n_groups < 1 || nq < 1 || n_pass < 1 || n_pass > kMaxPasses) {
    return (int)cudaErrorInvalidValue;
  }
  PassTable tab;
  tab.n = n_pass;
  int covered = 0;
  for (int p = 0; p < n_pass; ++p) {
    tab.off[p] = desc[4 * p];
    tab.per_group[p] = (int)desc[4 * p + 1];
    tab.q0[p] = (int)desc[4 * p + 2];
    tab.m[p] = (int)desc[4 * p + 3];
    if (tab.q0[p] != covered || tab.m[p] < 1 || tab.per_group[p] < 1) {
      return (int)cudaErrorInvalidValue;
    }
    covered += tab.m[p];
  }
  if (covered != nq) return (int)cudaErrorInvalidValue;
  const long long total = n_groups * nq * 8;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  layer_grad_reduce_kernel<<<(unsigned int)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(partial, out, n_groups,
                                                     nq, tab);
  return (int)cudaGetLastError();
}
