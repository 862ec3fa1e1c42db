// Single-qubit gate kernels over batched statevectors, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/statevec_gate/
// kernel.py:
//   * `apply_layer_planes` / `_kernel_fused_layer` (:170, :149) — TPU
//     kernel #1 — as `fused_layer_kernel`: gate q acts on qubit q for all
//     nq qubits of one layer, as nq butterfly stages pairing amplitude i
//     with i ^ (1 << q), with the state resident in fast memory;
//   * `apply_layer_planes_tiled` / `_kernel_fused_group` (:234, :208) —
//     TPU kernel #2 — as pass 0 = `fused_layer_kernel` over 2^low-amplitude
//     tiles plus one `fused_group_kernel` pass per later qubit group;
//   * `apply_gate_planes` / `_kernel_small`, `_kernel_large` (:94, :69,
//     :82) — TPU kernel #3 — as `gate_1q_kernel`: one 2x2 gate on one qubit.
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
// once and written once per pass, 16 B per amplitude (plus the gates).
//
// Kernel #1. One block stages whole states in shared memory with coalesced
// loads, runs all nq stages there with a __syncthreads() between stages,
// and writes each state back once — one round trip to device memory per
// layer instead of one per gate. States of up to 2^13 amplitudes (64 KB for
// both planes) stay resident, the same range as the TPU kernel's
// MAX_FUSED_DIM. Each row's gate set is staged beside it in shared memory.
// (Staging one set per group instead, which the ansatz's S rows of a group
// share, read a row-to-set index per butterfly and measured ~6% slower on an
// H100.)
//
// Kernel #2. Past 2^13 amplitudes a state no longer fits a block, so the
// layer takes one pass over memory per qubit group, as on the TPU. Pass 0
// is kernel #1 on the (G, S * 2^nq / 2^low, 2^low) view (qubits [0, low)
// stay inside one tile). A later group of gs qubits [q0, q0 + gs) views the
// state as (hi, 2^gs, 2^q0): a block stages a (2^gs, tc) tile of that view
// — tc consecutive lanes of each of the 2^gs rows, so each row segment is a
// coalesced tc * 4 B read — runs the gs stages in shared memory and writes
// the tile back. The TPU's 512-lane tile would take 512 KB of shared memory
// at gs = 7, more than the 227 KB a Hopper block gets: here tc is at most
// 2^13 / 2^gs lanes (64 at gs = 7), so a tile is at most 64 KB and three
// blocks fit an SM. The wrapper's `group_tile` is an upper bound on tc.
//
// Kernel #3. The TPU kernel's two regimes (stride inside an 8192-lane tile,
// or stride spanning tiles) exist because of VMEM; here one thread per
// amplitude pair computes i0 = ((j >> q) << (q + 1)) | (j & (lo - 1)) and
// i1 = i0 | lo and covers both. Loads are coalesced for q >= 5; below that a
// warp reads two interleaved segments (vector loads are later work).
//
// The shared-memory limits are raised once per device, to the most any
// launch needs, not by a CUDA API call before every launch.
//
// This version is deliberately plain: no TMA, no warp specialisation, no
// register blocking.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQubits = 13;
// amplitudes staged per block for small states (several states per block)
constexpr int kBlockAmps = 4096;
constexpr int kMaxDevices = 64;
// amplitudes of one group-pass tile (2^gs rows x tc lanes): 64 KB for both
// planes
constexpr long long kGroupAmps = 8192;
// blocks of the single-gate kernel's grid; a grid-stride loop covers more
constexpr long long kMaxGridBlocks = 1LL << 20;

int rows_per_block(int nq) {
  const int dim = 1 << nq;
  return dim >= kBlockAmps ? 1 : kBlockAmps / dim;
}

// the planes and one gate set per row
size_t smem_bytes(int nq) {
  return sizeof(float) * (size_t)rows_per_block(nq) * (2 * (1 << nq) + nq * 8);
}

__global__ void fused_layer_kernel(const float* __restrict__ re,
                                   const float* __restrict__ im,
                                   const float* __restrict__ gates,
                                   float* __restrict__ out_re,
                                   float* __restrict__ out_im,
                                   long long total_rows, int states_per_group,
                                   int nq, int gate_stride,
                                   int rows_per_block) {
  extern __shared__ float smem[];
  const int dim = 1 << nq;
  const int half = dim >> 1;
  float* sre = smem;
  float* sim = sre + rows_per_block * dim;
  float* sg = sim + rows_per_block * dim;

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = total_rows - row0;
  const int nrows = left < rows_per_block ? (int)left : rows_per_block;
  const long long base = row0 * dim;
  const int n_amps = nrows * dim;

  for (int i = threadIdx.x; i < n_amps; i += blockDim.x) {
    sre[i] = re[base + i];
    sim[i] = im[base + i];
  }
  const int per_row = nq * 8;
  for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const long long g = (row0 + r) / states_per_group;
    sg[i] = gates[g * gate_stride + (i - r * per_row)];
  }
  __syncthreads();

  const int n_pairs = nrows * half;
  for (int q = 0; q < nq; ++q) {
    const int lo = 1 << q;
    for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
      const int r = p >> (nq - 1);
      const int j = p & (half - 1);
      const int i0 = r * dim + (((j >> q) << (q + 1)) | (j & (lo - 1)));
      const int i1 = i0 + lo;
      const float* g = sg + r * per_row + q * 8;
      const float a0r = sre[i0], a0i = sim[i0];
      const float a1r = sre[i1], a1i = sim[i1];
      sre[i0] = g[0] * a0r - g[1] * a0i + g[2] * a1r - g[3] * a1i;
      sim[i0] = g[0] * a0i + g[1] * a0r + g[2] * a1i + g[3] * a1r;
      sre[i1] = g[4] * a0r - g[5] * a0i + g[6] * a1r - g[7] * a1i;
      sim[i1] = g[4] * a0i + g[5] * a0r + g[6] * a1i + g[7] * a1r;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_amps; i += blockDim.x) {
    out_re[base + i] = sre[i];
    out_im[base + i] = sim[i];
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

// Raises the dynamic shared-memory limits of the layer and group kernels
// on the current device to the most any launch needs, once per device.
cudaError_t configure_device() {
  static int done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  size_t most = 0;
  for (int nq = 1; nq <= kMaxQubits; ++nq) {
    const size_t b = smem_bytes(nq);
    most = b > most ? b : most;
  }
  err = cudaFuncSetAttribute(fused_layer_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_group_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * kGroupAmps));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = 1;
  return err;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.

// Kernel #1 (and pass 0 of kernel #2): gate q on qubit q for q < nq over
// (n_groups, states_per_group, 2^nq) planes; group g's gates start at
// gates + g * gate_stride.
extern "C" int statevec_gate_layer(const float* re, const float* im,
                                   const float* gates, float* out_re,
                                   float* out_im, long long n_groups,
                                   int states_per_group, int nq,
                                   int gate_stride, void* stream) {
  if (nq < 1 || nq > kMaxQubits || n_groups < 1 || states_per_group < 1 ||
      gate_stride < nq * 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = configure_device();
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_block(nq);
  const long long total_rows = n_groups * (long long)states_per_group;
  const long long blocks = (total_rows + rows - 1) / rows;
  fused_layer_kernel<<<(unsigned int)blocks, kThreads, smem_bytes(nq),
                       (cudaStream_t)stream>>>(
      re, im, gates, out_re, out_im, total_rows, states_per_group, nq,
      gate_stride, rows);
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
