// Fused single-qubit gate layer over batched statevectors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `apply_layer_planes` / `_kernel_fused_layer`
// (src/repro/kernels/statevec_gate/kernel.py:170 and :149): gate q acts on
// qubit q for all nq qubits of one layer, as nq butterfly stages pairing
// amplitude i with i ^ (1 << q), with the state resident in fast memory.
//
// Layout. States are float32 (re, im) planes of shape (G, S, 2^nq), row-major
// and contiguous; gates are (G, nq, 8) float32 packed as
// [g00r, g00i, g01r, g01i, g10r, g10i, g11r, g11i]; row (g, s) takes gate set
// g. The VQC's ansatz layers run with G = clients and S = batch, its
// per-sample encoding layer with G = clients * batch and S = 1.
//
// Bound. The butterflies do 28 flops per amplitude pair per stage, far below
// the card's float32 rate, so the layer is bound by bytes: both planes read
// once and written once, 2 planes * 4 B * 2^nq * 2 per state (plus the
// gates). The design moves exactly that: one block stages whole states in
// shared memory with coalesced loads, runs all nq stages there with a
// __syncthreads() between stages, and writes each state back once — one
// round trip to device memory per layer instead of one per gate. States of
// up to 2^13 amplitudes (64 KB for both planes) stay resident, the same
// range as the TPU kernel's MAX_FUSED_DIM.
//
// Each row's gate set is staged beside it in shared memory. (Staging one
// set per group instead, which the ansatz's S rows of a group share, read
// a row-to-set index per butterfly and measured ~6% slower on an H100.)
// The shared-memory limit is raised once per device, to the most any
// register size needs, not by a driver call before every launch.
//
// This first version is deliberately plain: no TMA, no warp specialisation,
// no register blocking.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQubits = 13;
// amplitudes staged per block for small states (several states per block)
constexpr int kBlockAmps = 4096;
constexpr int kMaxDevices = 64;

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
                                   int nq, int rows_per_block) {
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
    sg[i] = gates[g * per_row + (i - r * per_row)];
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

// Raises the kernel's dynamic shared-memory limit on the current device to
// the most any launch needs, once per device.
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
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = 1;
  return err;
}

}  // namespace

// Launches the fused layer on `stream`. Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int statevec_gate_layer(const float* re, const float* im,
                                   const float* gates, float* out_re,
                                   float* out_im, long long n_groups,
                                   int states_per_group, int nq,
                                   void* stream) {
  if (nq < 1 || nq > kMaxQubits || n_groups < 1 || states_per_group < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = configure_device();
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_block(nq);
  const long long total_rows = n_groups * (long long)states_per_group;
  const long long blocks = (total_rows + rows - 1) / rows;
  fused_layer_kernel<<<(unsigned int)blocks, kThreads, smem_bytes(nq),
                       (cudaStream_t)stream>>>(
      re, im, gates, out_re, out_im, total_rows, states_per_group, nq, rows);
  return (int)cudaGetLastError();
}
