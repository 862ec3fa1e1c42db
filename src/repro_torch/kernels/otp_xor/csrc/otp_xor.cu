// Fused OTP-XOR + polynomial MAC over GF(2^31 - 1), for Hopper (sm_90a),
// with the threefry one-time pads generated inside the kernel.
//
// Replaces the Pallas TPU kernels `otp_xor_mac_edge_blocks` /
// `_otp_mac_edge_kernel` (src/repro/kernels/otp_xor/kernel.py:98, #4) and
// `otp_xor_mac_blocks` / `_otp_mac_kernel` (kernel.py:131, #5): one
// streaming pass that XORs a message with its one-time pad and tags a word
// stream with the Carter-Wegman polynomial MAC of
// repro.security.mac.poly_mac_u32.
//
// Per row e of (E, n) u32 words:
//   ct[e]  = msg[e] ^ pad[e]
//   tag[e] = sum_i (sym_i + 1) * r^(2n - i) + (2n mod p) * s   (mod p)
// with p = 2^31 - 1, r = (r_key mod p) | 1, s = s_key mod p, and symbol 2w
// the low 16 bits of word w, symbol 2w + 1 its high 16 bits. `tag_input`
// chooses the words tagged: the ciphertext written (sender, 0) or the
// words read (receiver, 1: it tags what it received, then decrypts).
//
// Two bodies, chosen at compile time (`kSeeded`):
//   * given pad: pad[e] is read from memory (12 bytes a word);
//   * seeded: row e's pad is generated from its 32-bit seed s_e and a pad
//     layout, bit for bit what repro.security.otp.encrypt_tree(_rows) XORs
//     in (jax.random under jax_threefry_partitionable=True). The layout
//     has one row per leaf of the parameter tree, in flatten order:
//     (leaf index i, first wire word, elements per row, width 32 or 16).
//     The leaf key is threefry2x32(k = (0, s_e), x = (0, i)), which is
//     fold_in(key(s_e), i); element j of the leaf draws b1 ^ b2 of
//     threefry2x32(k = leaf key, x = (j >> 32, j & 0xFFFFFFFF)). A 16-bit
//     leaf packs the low halves of elements 2m and 2m + 1 into wire word m,
//     low element first; past an odd length the high half's pad is 0.
//
// Bound. The seeded body moves 8 bytes a word (msg read, ct written) and
// 12 a row (seed and two MAC keys read, tag written); it does one
// threefry2x32 (about 80 integer operations: 20 rounds of add, rotate,
// xor, and 5 key injections) per 32-bit pad word, two per 16-bit packed
// word, and the MAC's 5 a word. On an H100 that is about 160 us by bytes
// and 340 us by operations at (64, 2^20): operations bound it. At the
// trainer's (64, 62) rows the launch bounds it, whatever the body. The
// given-pad body moves 12 bytes a word and is bound by bytes.
//
// Design.
//   * Pads. Generating the pad here removes the pad's 4 bytes a word of
//     traffic and, on the trainer's path, the ~1,400 small int64 tensor
//     operations a secure stage spent building pads in plain torch. Each
//     block first computes the key of every leaf its word range touches,
//     once, into shared memory (one threefry a leaf), together with the
//     leaves' first words; a thread finds the leaf of its first word by a
//     binary search there and then walks the leaves as its words move.
//     Rotations are `__funnelshift_l`. Neighbouring threads take
//     neighbouring words, so a warp mostly stays in one leaf.
//   * MAC. The TPU kernel carried a 128x128 power table per edge and summed
//     blocks in grid order. Here blocks run in parallel and in no order, so
//     every term carries its ABSOLUTE power and the cross-block combine is a
//     plain modular sum. Words are counted from the row's end, v = n-1-w:
//     word w contributes (lo * r + hi) * r^(2v + 1). Thread t of block b
//     takes v = b * kWordsPerBlock + k * kThreads + t for k < kSteps
//     (coalesced), sums its words by Horner in R = r^(2 * kThreads), and
//     scales by r^(2t) once; thread 0 scales the block's sum by
//     r^(2 * b * kWordsPerBlock + 1). Products are exact 64-bit products
//     folded with 2^31 = 1 (mod p), which gives the same residues as the
//     JAX package's 16-bit-split uint32 arithmetic. A row spanning several
//     blocks writes one partial per block; the last block to arrive (a
//     per-row arrival count, zeroed by the launcher) adds them and writes
//     the tag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kThreads = 256;
constexpr int kLog2TwoThreads = 9;              // 2 * kThreads = 2^9
constexpr int kSteps = 16;                      // words per thread
constexpr int kWordsPerBlock = kThreads * kSteps;
constexpr long long kMaxRows = 65535;           // gridDim.y
constexpr int kMaxLeaves = 512;                 // the shared key table
constexpr int kLayoutCols = 4;                  // index, first, count, width

struct Args {
  const uint32_t* msg;
  const uint32_t* pad;          // given-pad body
  const uint32_t* seeds;        // seeded body: (rows,) or null for `seed`
  const long long* layout;      // seeded body: (n_leaves, kLayoutCols)
  const uint32_t* r_keys;       // (rows,) or null for `r_scalar`
  const uint32_t* s_keys;       // (rows,) or null for `s_scalar`
  uint32_t* ct;
  uint32_t* tags;
  uint32_t* partials;
  unsigned int* arrivals;
  long long n;
  int n_leaves;
  int tag_input;
  uint32_t seed, r_scalar, s_scalar;
};

// the leaves a block touches: first wire word, elements, 16-bit flag, key
struct LeafTable {
  long long first[kMaxLeaves];
  long long count[kMaxLeaves];
  uint2 key[kMaxLeaves];
  bool half[kMaxLeaves];
};

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

// threefry2x32's rotation j of round group i (Random123 / jax.random)
__device__ __forceinline__ int rot(int i, int j) {
  return (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.bits' 32-bit word for element j under a leaf key
__device__ __forceinline__ uint32_t pad_bits(uint2 key, long long j) {
  const uint2 y = threefry2x32(key.x, key.y, (uint32_t)(j >> 32),
                               (uint32_t)j);
  return y.x ^ y.y;
}

// the pad of wire word w (in leaf l) of the row keyed into `tab`
__device__ __forceinline__ uint32_t word_pad(const LeafTable& tab, int l,
                                             long long w) {
  const long long j = w - tab.first[l];
  const uint2 key = tab.key[l];
  if (!tab.half[l]) return pad_bits(key, j);
  const long long j0 = 2 * j;
  uint32_t p = pad_bits(key, j0) & 0xFFFFu;
  if (j0 + 1 < tab.count[l]) p |= pad_bits(key, j0 + 1) << 16;
  return p;
}

// the MAC term of one tagged word: lo * r + hi over the +1 symbols
__device__ __forceinline__ uint32_t mac_term(uint32_t w, uint32_t r) {
  return addmod(mulmod((w & 0xFFFFu) + 1u, r), (w >> 16) + 1u);
}

template <bool kSeeded>
__global__ void __launch_bounds__(kThreads)
otp_xor_mac_kernel(const Args a) {
  const int e = blockIdx.y;
  const int b = blockIdx.x;
  const int nblk = gridDim.x;
  const int t = threadIdx.x;
  const long long n = a.n;
  const uint32_t r = mod_p(a.r_keys ? a.r_keys[e] : a.r_scalar) | 1u;
  const size_t row = (size_t)e * (size_t)n;

  // stream the block's words: XOR, store, and keep the tagged symbol pairs
  const long long v0 = (long long)b * kWordsPerBlock + t;
  uint32_t c[kSteps];
  if constexpr (kSeeded) {
    __shared__ LeafTable tab;
    const uint32_t seed = a.seeds ? a.seeds[e] : a.seed;
    const long long w_hi = n - 1 - (long long)b * kWordsPerBlock;
    const long long w_lo = w_hi - kWordsPerBlock + 1;     // may be < 0
    const int L = a.n_leaves;
    for (int l = t; l < L; l += kThreads) {
      const long long* leaf = a.layout + (size_t)l * kLayoutCols;
      const long long first = leaf[1], count = leaf[2];
      const bool half = leaf[3] == 16;
      const long long words = half ? (count + 1) >> 1 : count;
      tab.first[l] = first;
      tab.count[l] = count;
      tab.half[l] = half;
      if (first <= w_hi && first + words > w_lo)   // the block touches it
        tab.key[l] = threefry2x32(0u, seed, 0u, (uint32_t)leaf[0]);
    }
    __syncthreads();
    // the leaf of the thread's first word: the last leaf starting at or
    // before it (an empty leaf shares its first word with the next one)
    const long long w0 = n - 1 - v0;
    int l = 0;
    if (w0 >= 0) {
      int hi = L - 1;
      while (l < hi) {
        const int mid = (l + hi + 1) >> 1;
        if (tab.first[mid] <= w0) l = mid; else hi = mid - 1;
      }
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long v = v0 + (long long)k * kThreads;
      c[k] = 0;
      if (v < n) {
        const long long w = n - 1 - v;
        while (tab.first[l] > w) --l;
        const size_t idx = row + (size_t)w;
        const uint32_t m = a.msg[idx];
        const uint32_t x = m ^ word_pad(tab, l, w);
        a.ct[idx] = x;
        c[k] = mac_term(a.tag_input ? m : x, r);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const long long v = v0 + (long long)k * kThreads;
      c[k] = 0;
      if (v < n) {
        const size_t idx = row + (size_t)(n - 1 - v);
        const uint32_t m = a.msg[idx];
        const uint32_t x = m ^ a.pad[idx];
        a.ct[idx] = x;
        c[k] = mac_term(a.tag_input ? m : x, r);
      }
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
    a.partials[(size_t)e * nblk + b] = part;
    __threadfence();
    if (atomicAdd(&a.arrivals[e], 1u) != (unsigned int)(nblk - 1)) return;
    __threadfence();
    const volatile uint32_t* row_parts = a.partials + (size_t)e * nblk;
    total = 0;
    for (int i = 0; i < nblk; ++i) total += row_parts[i];
    part = mod_p(total);
  }
  const uint32_t s = mod_p(a.s_keys ? a.s_keys[e] : a.s_scalar);
  const uint32_t n_sym = (uint32_t)((2ull * (unsigned long long)n) % kP);
  a.tags[e] = addmod(part, mulmod(n_sym, s));
}

// Shared launcher: grid (blocks a row, rows), the arrival counts zeroed
// first when a row spans several blocks. Returns a cudaError_t.
template <bool kSeeded>
int launch(Args a, void* scratch, long long rows, void* stream) {
  if (rows < 1 || rows > kMaxRows || a.n < 1)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (a.n + kWordsPerBlock - 1) / kWordsPerBlock;
  if (nblk > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  a.partials = nullptr;
  a.arrivals = nullptr;
  if (nblk > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    a.partials = (uint32_t*)scratch;
    a.arrivals = (unsigned int*)(a.partials + rows * nblk);
    const cudaError_t err =
        cudaMemsetAsync(a.arrivals, 0, rows * sizeof(unsigned int), st);
    if (err != cudaSuccess) return (int)err;
  }
  otp_xor_mac_kernel<kSeeded>
      <<<dim3((unsigned int)nblk, (unsigned int)rows), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Words each block covers; the wrapper sizes its scratch with it.
int otp_xor_mac_words_per_block() { return kWordsPerBlock; }

// Leaves the seeded body's shared key table holds.
int otp_xor_mac_max_leaves() { return kMaxLeaves; }

// Given pad. msg, pad, ct: (rows, n) u32 words, row-major and contiguous.
// r_keys and s_keys: (rows,) u32 device arrays, or null to use r_scalar /
// s_scalar for every row. tags: (rows,) u32. scratch: rows * (nblk + 1)
// u32 words when a row spans nblk > 1 blocks, else unused. Launches on
// `stream`, does not synchronise; returns the launch's cudaError_t.
int otp_xor_mac(const void* msg, const void* pad, const void* r_keys,
                const void* s_keys, unsigned int r_scalar,
                unsigned int s_scalar, void* ct, void* tags, void* scratch,
                long long rows, long long n, int tag_input, void* stream) {
  if (pad == nullptr) return (int)cudaErrorInvalidValue;
  Args a{};
  a.msg = (const uint32_t*)msg;
  a.pad = (const uint32_t*)pad;
  a.r_keys = (const uint32_t*)r_keys;
  a.s_keys = (const uint32_t*)s_keys;
  a.ct = (uint32_t*)ct;
  a.tags = (uint32_t*)tags;
  a.n = n;
  a.tag_input = tag_input;
  a.r_scalar = r_scalar;
  a.s_scalar = s_scalar;
  return launch<false>(a, scratch, rows, stream);
}

// Seeded: as otp_xor_mac, with the pad generated in the kernel from
// `seeds` ((rows,) u32, or null to use seed_scalar for every row) and
// `layout` ((n_leaves, 4) int64 on the device: leaf index, first wire
// word, elements per row, width 32 or 16; leaves tile [0, n) in order).
int otp_xor_mac_seeded(const void* msg, const void* seeds,
                       unsigned int seed_scalar, const void* layout,
                       int n_leaves, const void* r_keys, const void* s_keys,
                       unsigned int r_scalar, unsigned int s_scalar,
                       void* ct, void* tags, void* scratch, long long rows,
                       long long n, int tag_input, void* stream) {
  if (layout == nullptr || n_leaves < 1 || n_leaves > kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.msg = (const uint32_t*)msg;
  a.seeds = (const uint32_t*)seeds;
  a.layout = (const long long*)layout;
  a.r_keys = (const uint32_t*)r_keys;
  a.s_keys = (const uint32_t*)s_keys;
  a.ct = (uint32_t*)ct;
  a.tags = (uint32_t*)tags;
  a.n = n;
  a.n_leaves = n_leaves;
  a.tag_input = tag_input;
  a.seed = seed_scalar;
  a.r_scalar = r_scalar;
  a.s_scalar = s_scalar;
  return launch<true>(a, scratch, rows, stream);
}

}  // extern "C"
