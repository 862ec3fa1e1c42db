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
// the time of reading q, k, v and writing o once, so the work bounds it.
// This first version runs on the CUDA cores in float32 (no tensor cores),
// so it sits well above that bound; the tensor-core version (wgmma on bf16
// tiles, P rounded to bf16) is later work.
//
// Design. One block of 128 threads per (64-row query tile, batch * head),
// the heaviest tiles (latest rows, most keys under W = 0) launched first.
// Each block walks only the 64-key tiles the band touches, with an online
// softmax (running max m, sum l and accumulator in float32 registers). The
// q tile stays in shared memory for the whole walk, transposed (d-major) so
// a thread reads its 4 query rows as one float4; each k tile is staged
// transposed the same way and each v tile row-major. A thread owns 4 query
// rows x 8 key columns of the score tile (columns cg*4.. and 32+cg*4.., so
// the 8 threads of a row group read 128 contiguous bytes) and 4 rows x hd/8
// columns of the output; the 8 threads of a row group reduce the row max
// and row sum with warp shuffles. Probabilities go through shared memory
// (transposed) into the P.V product. Rows and keys past S are zero-filled
// and masked, so any S works; W > S is full causal attention. Grids are
// plain products of tile and head counts: nothing assumes a power of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kPad = 4;         // keeps float4 alignment, breaks some conflicts
constexpr int kLd = kBQ + kPad; // row stride of Qt, Kt, Pt (kBQ == kBK)
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * HD * kLd + kBK * (HD + kPad) + kBK * kLd);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int H,
               int KV, int BH, int n_qt, int window, float scale_log2) {
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
  const T* qb = q + ((long long)b * S * H + h) * HD;
  const T* kb = k + ((long long)b * S * KV + kvh) * HD;
  const T* vb = v + ((long long)b * S * KV + kvh) * HD;
  T* ob = o + ((long long)b * S * H + h) * HD;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;      // query rows rg*4 .. rg*4+3
  const int cg = tid & 7;       // key columns cg*4+{0..3}, 32+cg*4+{0..3}

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    Qt[d * kLd + r] =
        s < S ? to_f(qb[(long long)s * q_stride + d]) * scale_log2 : 0.f;
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
      Kt[d * kLd + c] = in ? to_f(kb[(long long)s * kv_stride + d]) : 0.f;
      Vs[c * kLdv + d] = in ? to_f(vb[(long long)s * kv_stride + d]) : 0.f;
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
    T* orow = ob + (long long)s * q_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[32 * g + cg * 4 + e] = from_f<T>(acc[i][g * 4 + e] * inv);
  }
}

// Raises the kernel's dynamic shared-memory limit once per device.
template <typename T, int HD>
cudaError_t configure_device() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(swa_fwd_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<HD>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, cudaStream_t st) {
  cudaError_t err = configure_device<T, HD>();
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const long long BH = (long long)B * H;
  const long long blocks = BH * n_qt;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // the band's keys, scaled by log2(e) so the softmax runs on exp2
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  swa_fwd_kernel<T, HD><<<(unsigned int)blocks, kThreads, smem_bytes<HD>(),
                          st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, (int)BH, n_qt,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int hd, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); contiguous, all of one dtype
// (0: float32, 1: bfloat16). window <= 0 is full causal attention.
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape the kernel does not take).
int swa_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KV, int hd, int window,
                      int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_hd<float>(q, k, v, o, B, S, H, KV, hd, window, st);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, window,
                                      st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
