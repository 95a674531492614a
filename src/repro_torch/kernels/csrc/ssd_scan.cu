// Mamba-2 SSD chunk scan, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_pallas): x_dt (B,S,H,P), Bm/Cm (B,S,N) (one group), log_a
// (B,S,H) f32 -> y (B,S,H,P) in x's dtype and the final state (B,H,P,N)
// f32.  Per (b, h), with cum the inclusive prefix sum of log_a inside a
// chunk:
//   y[t]  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x[s]      (dual form)
//         + exp(cum_t) C_t h                                     (carried)
//   h    <- exp(cum_last) h + sum_s exp(cum_last - cum_s) x[s] B_s^T
// starting from the optional initial state (a null pointer means zeros).
// Chunking is exact, so the chunk here (kQ) is a tiling choice only; the
// last chunk may be ragged, so any S works.
//
// What bounds it: operations.  On the FP32 pipes, as here, the chunk
// loop does about 2*Q*N + 2*Q*P + 4*P*N FLOPs per token and head on a few
// bytes per token; tensor cores (mma/wgmma) are later work.
//
// Design.  The chunks of one (b, h) run in order, so one block walks them
// in a loop (the TPU's sequential grid axis), with the (P,N) state in
// shared memory.  A block owns kPB = 16 columns p of y and rows of the
// state; those are independent once C B^T and cum are known, so P/16
// blocks share a head and the engine's B=1, H=24, P=64 launch fills 96
// SMs instead of 24.  Each block recomputes C B^T for its chunk (one
// group: the same for every head).  Per chunk of kQ = 32 tokens: B, C and
// the x slice are staged as f32; warp 0 scans log_a with shuffles; W =
// (C B^T) o L is formed with exp taken only where s <= t (above the
// diagonal exp(cum_t - cum_s) can overflow, and inf * 0 is NaN); then y,
// then the state.  Everything accumulates in f32 and y is rounded once.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kQ = 32;        // tokens per chunk; one warp scans a chunk
constexpr int kPB = 16;       // columns p of y (rows of the state) per block
constexpr int kThreads = 256;
constexpr int kWP = kQ + 1;   // padded row of W

size_t smem_bytes(int N) {
  const size_t NP = (size_t)N + 1;
  return sizeof(float) * (2 * kQ * NP + kPB * NP + kQ * kPB + kQ * kWP + kQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ log_a,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  constexpr int VN = Vec<T>::N;
  const int NP = N + 1;
  float* b_s = smem;                // kQ x NP
  float* c_s = b_s + kQ * NP;       // kQ x NP
  float* h_s = c_s + kQ * NP;       // kPB x NP, the state slice
  float* x_s = h_s + kPB * NP;      // kQ x kPB
  float* w_s = x_s + kQ * kPB;      // kQ x kWP
  float* cum_s = w_s + kQ * kWP;    // kQ

  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t state0 = ((size_t)b * H + h) * P + p0;  // row of h[b,h,p0]

  for (int e = tid; e < kPB * N; e += kThreads) {
    const int p = e / N, n = e % N;
    h_s[p * NP + n] = h0 ? h0[(state0 + p) * N + n] : 0.f;
  }

  const int vpr = N / VN;  // vector loads per row of B or C
  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int q = min(kQ, S - c0);
    __syncthreads();  // the previous chunk's readers are done

    for (int v = tid; v < q * vpr; v += kThreads) {
      const int r = v / vpr, n = (v % vpr) * VN;
      const size_t off = ((size_t)b * S + c0 + r) * N + n;
      float tb[VN], tc[VN];
      Vec<T>::load(Bm + off, tb);
      Vec<T>::load(Cm + off, tc);
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        b_s[r * NP + n + i] = tb[i];
        c_s[r * NP + n + i] = tc[i];
      }
    }
    for (int v = tid; v < q * (kPB / VN); v += kThreads) {
      const int r = v / (kPB / VN), p = (v % (kPB / VN)) * VN;
      float tx[VN];
      Vec<T>::load(x + (((size_t)b * S + c0 + r) * H + h) * P + p0 + p, tx);
#pragma unroll
      for (int i = 0; i < VN; ++i) x_s[r * kPB + p + i] = tx[i];
    }
    if (tid < 32) {  // inclusive prefix sum of log_a over the chunk
      float v = tid < q ? log_a[((size_t)b * S + c0 + tid) * H + h] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      cum_s[tid] = v;
    }
    __syncthreads();

    {  // W[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0
      const int t = tid >> 3, s0 = tid & 7;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < q) {
        for (int n = 0; n < N; ++n) {
          const float cv = c_s[t * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = fmaf(cv, b_s[(s0 + 8 * j) * NP + n], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 8 * j;
        w_s[t * kWP + s] =
            (t < q && s <= t) ? acc[j] * expf(cum_s[t] - cum_s[s]) : 0.f;
      }
    }
    __syncthreads();

    {  // y[t][p] = sum_{s<=t} W[t][s] x[s][p] + exp(cum_t) C_t . h[p]
      const int p = tid & 15;
#pragma unroll
      for (int i = 0; i < kQ / 16; ++i) {
        const int t = (tid >> 4) + 16 * i;
        if (t >= q) continue;
        float intra = 0.f, inter = 0.f;
        for (int s = 0; s <= t; ++s)
          intra = fmaf(w_s[t * kWP + s], x_s[s * kPB + p], intra);
        for (int n = 0; n < N; ++n)
          inter = fmaf(c_s[t * NP + n], h_s[p * NP + n], inter);
        y[(((size_t)b * S + c0 + t) * H + h) * P + p0 + p] =
            from_float<T>(fmaf(inter, expf(cum_s[t]), intra));
      }
    }
    __syncthreads();

    // x[s] *= exp(cum_last - cum_s): the decay from s to the chunk's end
    for (int e = tid; e < q * kPB; e += kThreads)
      x_s[e] *= expf(cum_s[q - 1] - cum_s[e / kPB]);
    __syncthreads();

    const float decay = expf(cum_s[q - 1]);
    for (int e = tid; e < kPB * N; e += kThreads) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int s = 0; s < q; ++s)
        acc = fmaf(x_s[s * kPB + p], b_s[s * NP + n], acc);
      h_s[p * NP + n] = fmaf(h_s[p * NP + n], decay, acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < kPB * N; e += kThreads) {
    const int p = e / N, n = e % N;
    h_out[(state0 + p) * N + n] = h_s[p * NP + n];
  }
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const float* log_a,
           const float* h0, void* y, float* h_out, int B, int S, int H, int P,
           int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ssd_scan_kernel<T>), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / kPB, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), log_a, h0, static_cast<T*>(y), h_out, S, H,
      P, N);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`; h0 may be null (zero initial state).  Needs
// P % 16 == 0 and N % 8 == 0, N <= 256 (the wrapper checks).  Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_launch(int device, int dtype, const void* x,
                               const void* Bm, const void* Cm,
                               const void* log_a, const void* h0, void* y,
                               void* h_out, int B, int S, int H, int P, int N,
                               void* stream) {
  using namespace repro_torch;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P % kPB != 0 || N % 8 != 0 || N <= 0 || N > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* h_in = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  if (dtype == kFloat32)
    return launch<float>(x, Bm, Cm, la, h_in, y, ho, B, S, H, P, N, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, Bm, Cm, la, h_in, y, ho, B, S, H, P, N,
                                 st);
  return (int)cudaErrorInvalidValue;
}
