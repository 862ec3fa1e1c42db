// Mamba-2 SSD chunked scan (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_bhsp` / `_ssd_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:89). For each (batch, head), over
// chunks of Q steps in order, with the (P, N) state carried across chunks:
//   dA     = dt * A_h;  cs = cumsum(dA) within the chunk
//   y[l]   = sum_{s<=l} (C_l . B_s) exp(cs_l - cs_s) dt_s x_s
//            + exp(cs_l) (C_l . state)                      (state before)
//   state <- state * exp(cs_last) + sum_s exp(cs_last - cs_s) dt_s x_s B_s^T
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
// below the bytes at every serving shape, so bytes bound it. This first
// version does the chunked form's intra-chunk products on the CUDA cores
// in float32, which is several times that arithmetic; tensor cores are
// later work.
//
// Design. The TPU kernel folded every head into one block with an
// (H, P, N) state in VMEM: at hymba's 50 heads that is 200 KB, no fit for
// an SM. Here one block of 256 threads owns one (batch, head) and walks
// its chunks in order, the (P, N) state resident in shared memory (4 KB at
// N = 16, 32 KB at N = 128). Per chunk it stages x (Q x P) and B, C
// (transposed, N x Q) in shared memory, scans dA with one warp (in
// float64), then
// builds the masked, decayed score matrix 32 query rows at a time (a
// 32 x Q tile in shared memory) and forms those rows of y from it and from
// the old state; the state update follows once every row is written. Any
// chunk length up to 128 works (125 at S = 1000), and any head or group
// count: the grid is B * H blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;   // longest chunk; 4 score columns per thread
constexpr int kRT = 32;      // query rows of the chunk per score tile
constexpr int kMaxDevices = 64;

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

template <typename T>
size_t smem_bytes(int Q, int P, int N) {
  return sizeof(double) * kMaxQ +
         sizeof(float) * (size_t)(2 * kMaxQ + N * P + kRT * Q) +
         sizeof(T) * (size_t)(Q * P + 2 * N * (Q + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bv,
                const T* __restrict__ Cv,
                const float* __restrict__ state_in, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int G, int P,
                int N, int Q) {
  extern __shared__ float4 smem4[];
  double* cs = reinterpret_cast<double*>(smem4); // [kMaxQ] cumsum of dA
  float* dtv = reinterpret_cast<float*>(cs + kMaxQ);   // [kMaxQ] dt
  float* wv = dtv + kMaxQ;                       // [kMaxQ] exp(cs_last-cs)*dt
  float* stT = wv + kMaxQ;                       // [N][P] the state
  float* Ms = stT + N * P;                       // [kRT][Q] score tile
  T* xs = reinterpret_cast<T*>(Ms + kRT * Q);    // [Q][P]
  const int ldq = Q + 1;
  T* Bt = xs + Q * P;                            // [N][Q + 1]
  T* Ct = Bt + N * ldq;                          // [N][Q + 1]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[h];
  const int tid = threadIdx.x;
  const int nc = S / Q;
  const int half = P / 2;

  const long long xrow = (long long)H * P;       // elements between steps
  const long long brow = (long long)G * N;
  const T* xb = x + ((long long)b * S * H + h) * P;
  T* yb = y + ((long long)b * S * H + h) * P;
  const float* dtb = dt + (long long)b * S * H + h;
  const T* Bb = Bv + ((long long)b * S * G + g) * N;
  const T* Cb = Cv + ((long long)b * S * G + g) * N;

  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i % P;
    stT[i] = state_in ? state_in[((long long)bh * P + p) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    __syncthreads();   // the previous chunk is done with every buffer
    for (int s = tid; s < Q; s += kThreads) dtv[s] = dtb[(t0 + s) * H];
    for (int i = tid; i < Q * P; i += kThreads) {
      const int s = i / P, p = i % P;
      xs[i] = xb[(t0 + s) * xrow + p];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int s = i / N, n = i % N;
      const long long off = (t0 + s) * brow + n;
      Bt[n * ldq + s] = Bb[off];
      Ct[n * ldq + s] = Cb[off];
    }
    __syncthreads();
    if (tid < 32) {    // inclusive scan of dA = dt * a by one warp
      const int per = (Q + 31) / 32;
      const int s0 = tid * per;
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
        if (tid >= off) incl += t;
      }
      const double base = incl - run;
#pragma unroll
      for (int j = 0; j < kMaxQ / 32; ++j) {
        const int s = s0 + j;
        if (j < per && s < Q) cs[s] = base + loc[j];
      }
    }
    __syncthreads();
    const double cs_last = cs[Q - 1];
    for (int s = tid; s < Q; s += kThreads) {
      wv[s] = expf((float)(cs_last - cs[s])) * dtv[s];
    }

    for (int r0 = 0; r0 < Q; r0 += kRT) {
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
            cv[i] = l < Q ? to_f(Ct[n * ldq + l]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = sg + 32 * j;
            bv[j] = s < Q ? to_f(Bt[n * ldq + s]) : 0.f;
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
      for (int task = tid; task < (kRT / 4) * half; task += kThreads) {
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
            const float cl = l < Q ? to_f(Ct[n * ldq + l]) : 0.f;
            yo[i][0] = fmaf(cl, s0, yo[i][0]);
            yo[i][1] = fmaf(cl, s1, yo[i][1]);
          }
        }
        const int s_end = min(r0 + li0 + 3, Q - 1);
        for (int s = 0; s <= s_end; ++s) {
          const float x0 = to_f(xs[s * P + pc]);
          const float x1 = to_f(xs[s * P + pc + half]);
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
          T* yrow = yb + (t0 + l) * xrow;
          yrow[pc] = from_f<T>(yd[i][0] + e * yo[i][0]);
          yrow[pc + half] = from_f<T>(yd[i][1] + e * yo[i][1]);
        }
      }
      __syncthreads();   // every row is done with Ms and the old state
    }

    const float decay = expf((float)cs_last);
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float acc = 0.f;
      for (int s = 0; s < Q; ++s) {
        acc = fmaf(to_f(xs[s * P + p]) * wv[s], to_f(Bt[n * ldq + s]), acc);
      }
      stT[i] = stT[i] * decay + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i % P;
    state_out[((long long)bh * P + p) * N + n] = stT[i];
  }
}

// Raises the kernel's dynamic shared-memory limit to the device's opt-in
// maximum, once per device; returns that maximum in *most.
template <typename T>
cudaError_t configure_device(int* most) {
  static int limit[kMaxDevices] = {};
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
  err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *most);
  if (err == cudaSuccess && dev < kMaxDevices) limit[dev] = *most;
  return err;
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bv,
           const void* Cv, const void* state_in, void* y, void* state, int B,
           int S, int H, int G, int P, int N, int Q, cudaStream_t st) {
  int most = 0;
  cudaError_t err = configure_device<T>(&most);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T>(Q, P, N);
  if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
  ssd_scan_kernel<T><<<(unsigned int)(B * H), kThreads, smem, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bv,
      (const T*)Cv, (const float*)state_in, (T*)y, (float*)state, S, H, G,
      P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (B, S, H, P) and Bv, Cv: (B, S, G, N), all of one dtype
// (0: float32, 1: bfloat16); dt: (B, S, H) float32; A: (H,) float32;
// state_in (null: the zero state) and state: (B, H, P, N) float32;
// contiguous. Q divides S, Q <= 128, P even,
// H a multiple of G. Launches on `stream`, does not synchronise; returns
// the launch's cudaError_t (cudaErrorInvalidValue for a shape the kernel
// does not take).
int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                 const void* Bv, const void* Cv, const void* state_in,
                 void* y, void* state, int B, int S, int H, int G, int P,
                 int N, int Q, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 2 || P % 2 ||
      N < 1 || Q < 1 || Q > kMaxQ || S % Q != 0 ||
      (long long)B * H > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(x, dt, A, Bv, Cv, state_in, y, state, B, S, H, G,
                         P, N, Q, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, A, Bv, Cv, state_in, y, state, B, S,
                                 H, G, P, N, Q, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
