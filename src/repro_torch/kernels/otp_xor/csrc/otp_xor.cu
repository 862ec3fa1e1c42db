// Fused OTP-XOR + polynomial MAC over GF(2^31 - 1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `otp_xor_mac_edge_blocks` /
// `_otp_mac_edge_kernel` (src/repro/kernels/otp_xor/kernel.py:98) and
// `otp_xor_mac_blocks` / `_otp_mac_kernel` (kernel.py:131): one streaming
// pass that XORs a message with its one-time pad and tags a word stream
// with the Carter-Wegman polynomial MAC of repro.security.mac.poly_mac_u32.
//
// Per row e of (E, n) u32 words:
//   ct[e]  = msg[e] ^ pad[e]
//   tag[e] = sum_i (sym_i + 1) * r^(2n - i) + (2n mod p) * s   (mod p)
// with p = 2^31 - 1, r = (r_key mod p) | 1, s = s_key mod p, and symbol 2w
// the low 16 bits of word w, symbol 2w + 1 its high 16 bits. `tag_input`
// chooses the words tagged: the ciphertext written (sender, 0) or the
// words read (receiver, 1: it tags what it received, then decrypts).
//
// Bound. 12 bytes move per word (two reads, one write) and the MAC needs
// two modular multiply-adds per word, so the kernel is bound by bytes at
// every length worth measuring; at the trainer's 62-word rows it is bound
// by the launch itself.
//
// Design. The TPU kernel carried a 128x128 power table per edge and summed
// blocks in grid order. Here blocks run in parallel and in no order, so
// every term carries its ABSOLUTE power and the cross-block combine is a
// plain modular sum. Words are counted from the row's end, v = n - 1 - w:
// word w contributes (lo * r + hi) * r^(2v + 1). Thread t of block b takes
// v = b * kWordsPerBlock + k * kThreads + t for k < kSteps (neighbouring
// threads touch neighbouring words: coalesced), sums its words by Horner in
// R = r^(2 * kThreads), and scales by r^(2t) once; thread 0 scales the
// block's sum by r^(2 * b * kWordsPerBlock + 1). Products are exact 64-bit
// products folded with 2^31 = 1 (mod p), which gives the same residues as
// the JAX package's 16-bit-split uint32 arithmetic. A row spanning several
// blocks writes one partial per block; the last block to arrive (a per-row
// arrival count, zeroed by the launcher) adds them and writes the tag.
//
// This first version is plain: scalar 4-byte loads, no vector loads, no
// in-kernel pad generation (the pads come from the threefry code).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kThreads = 256;
constexpr int kLog2TwoThreads = 9;              // 2 * kThreads = 2^9
constexpr int kSteps = 16;                      // words per thread
constexpr int kWordsPerBlock = kThreads * kSteps;
constexpr long long kMaxRows = 65535;           // gridDim.y

__device__ __forceinline__ uint32_t mod_p(uint64_t x) {   // x < 2^62
  x = (x & kP) + (x >> 31);                     // < 2^32
  x = (x & kP) + (x >> 31);                     // <= p + 1
  return (uint32_t)(x >= kP ? x - kP : x);
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b) {
  return mod_p((uint64_t)a * b);                // a, b < 2^31
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;                     // a, b < p: no wrap
  return s >= kP ? s - kP : s;
}

__device__ uint32_t powmod(uint32_t r, unsigned long long e) {
  uint32_t acc = 1;
  while (e) {
    if (e & 1) acc = mulmod(acc, r);
    r = mulmod(r, r);
    e >>= 1;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
otp_xor_mac_kernel(const uint32_t* __restrict__ msg,
                   const uint32_t* __restrict__ pad,
                   const uint32_t* __restrict__ r_keys,
                   const uint32_t* __restrict__ s_keys,
                   uint32_t r_scalar, uint32_t s_scalar,
                   uint32_t* __restrict__ ct, uint32_t* __restrict__ tags,
                   uint32_t* __restrict__ partials,
                   unsigned int* __restrict__ arrivals,
                   long long n, int tag_input) {
  const int e = blockIdx.y;
  const int b = blockIdx.x;
  const int nblk = gridDim.x;
  const int t = threadIdx.x;
  const uint32_t r = mod_p(r_keys ? r_keys[e] : r_scalar) | 1u;
  const size_t row = (size_t)e * (size_t)n;

  // stream the block's words: XOR, store, and keep the tagged symbol pairs
  const long long v0 = (long long)b * kWordsPerBlock + t;
  uint32_t c[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long long v = v0 + (long long)k * kThreads;
    c[k] = 0;
    if (v < n) {
      const size_t idx = row + (size_t)(n - 1 - v);
      const uint32_t m = msg[idx];
      const uint32_t x = m ^ pad[idx];
      ct[idx] = x;
      const uint32_t w = tag_input ? m : x;
      c[k] = addmod(mulmod((w & 0xFFFFu) + 1u, r), (w >> 16) + 1u);
    }
  }
  // Horner over the thread's words in R = r^(2 * kThreads)
  uint32_t R = r;
#pragma unroll
  for (int i = 0; i < kLog2TwoThreads; ++i) R = mulmod(R, R);
  uint32_t acc = 0;
#pragma unroll
  for (int k = kSteps - 1; k >= 0; --k) acc = addmod(mulmod(acc, R), c[k]);
  acc = mulmod(acc, powmod(r, 2ull * (unsigned long long)t));

  // block sum: every term < 2^31, so a 64-bit sum of 256 is exact
  uint64_t sum = acc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  __shared__ uint64_t warp_sums[kThreads / 32];
  if ((t & 31) == 0) warp_sums[t >> 5] = sum;
  __syncthreads();
  if (t != 0) return;
  uint64_t total = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  uint32_t part = mulmod(
      mod_p(total),
      powmod(r, 2ull * (unsigned long long)b * kWordsPerBlock + 1ull));

  if (nblk > 1) {
    partials[(size_t)e * nblk + b] = part;
    __threadfence();
    if (atomicAdd(&arrivals[e], 1u) != (unsigned int)(nblk - 1)) return;
    __threadfence();
    const volatile uint32_t* row_parts = partials + (size_t)e * nblk;
    total = 0;
    for (int i = 0; i < nblk; ++i) total += row_parts[i];
    part = mod_p(total);
  }
  const uint32_t s = mod_p(s_keys ? s_keys[e] : s_scalar);
  const uint32_t n_sym = (uint32_t)((2ull * (unsigned long long)n) % kP);
  tags[e] = addmod(part, mulmod(n_sym, s));
}

}  // namespace

extern "C" {

// Words each block covers; the wrapper sizes its scratch with it.
int otp_xor_mac_words_per_block() { return kWordsPerBlock; }

// msg, pad, ct: (rows, n) u32 words, row-major and contiguous. r_keys and
// s_keys: (rows,) u32 device arrays, or null to use r_scalar / s_scalar
// for every row. tags: (rows,) u32. scratch: rows * (nblk + 1) u32 words
// when a row spans nblk > 1 blocks, else unused. Launches on `stream`,
// does not synchronise; returns the launch's cudaError_t.
int otp_xor_mac(const void* msg, const void* pad, const void* r_keys,
                const void* s_keys, unsigned int r_scalar,
                unsigned int s_scalar, void* ct, void* tags, void* scratch,
                long long rows, long long n, int tag_input, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 1) return (int)cudaErrorInvalidValue;
  const long long nblk = (n + kWordsPerBlock - 1) / kWordsPerBlock;
  if (nblk > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* partials = nullptr;
  unsigned int* arrivals = nullptr;
  if (nblk > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    partials = (uint32_t*)scratch;
    arrivals = (unsigned int*)(partials + rows * nblk);
    const cudaError_t err =
        cudaMemsetAsync(arrivals, 0, rows * sizeof(unsigned int), st);
    if (err != cudaSuccess) return (int)err;
  }
  otp_xor_mac_kernel<<<dim3((unsigned int)nblk, (unsigned int)rows),
                       kThreads, 0, st>>>(
      (const uint32_t*)msg, (const uint32_t*)pad, (const uint32_t*)r_keys,
      (const uint32_t*)s_keys, r_scalar, s_scalar, (uint32_t*)ct,
      (uint32_t*)tags, partials, arrivals, n, tag_input);
  return (int)cudaGetLastError();
}

}  // extern "C"
