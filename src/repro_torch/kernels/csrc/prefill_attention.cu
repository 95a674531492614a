// Flash-attention forward for prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention/kernel.py
// (prefill_attention_pallas): q (B,S,H,D), k/v (B,S,KV,D) -> (B,S,H,D),
// with GQA through kv head = h / (H/KV), causal, sliding-window and
// prefix-LM masks and a tanh softcap.  Query and key positions are the
// sequence indices; keys at or past the true S are masked here, so any S
// is exact (the TPU wrapper's zero padding attended to padded keys when
// causal=False: ROADMAP C-ref1).
//
// What bounds it: operations.  Causal prefill does ~2*S^2*H*D FLOPs on
// 2*S*(H+2*KV)*D*bytes of input, far above the byte bound at the chunk
// sizes calibration uses; this first version runs on the FP32 pipes
// (no tensor cores), so its bound is far off.  Tensor cores (mma/wgmma)
// are later work.
//
// Design.  One block of 256 threads owns a tile of BQ = 64 query rows of one
// (b, head) and loops over key tiles of BK = 64 inside the block (the TPU's
// sequential K grid axis).  Q, K, V and the probabilities are staged in
// shared memory as f32; a 16 x 16 thread grid holds a 4 x 4 patch of the
// scores and a 4 x D/16 patch of the output in registers, with the online
// softmax state (m, l) in f32.  Key tiles that the causal or window mask
// rules out entirely are skipped, so causal prefill does S^2/2 work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kMinM = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int S, int H,
               int KV, int causal, int window, int prefix_len, float scale,
               float softcap) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = D / VN;
  constexpr int DJ = D / 16;  // output columns per thread
  float* q_s = smem;             // BQ * DP
  float* k_s = q_s + kBQ * DP;   // BK * DP
  float* v_s = k_s + kBK * DP;   // BK * D
  float* p_s = v_s + kBK * D;    // BQ * PP

  const int G = H / KV;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int c = tid; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, dv = (c % CPR) * VN;
    float tmp[VN];
    if (q0 + r < S) {
      Vec<T>::load(q + (((size_t)b * S + q0 + r) * H + h) * D + dv, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) q_s[r * DP + dv + i] = tmp[i];
  }

  float o[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMinM;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
  }

  // key tiles that can hold a valid key for some row of this query tile
  int kt_begin = 0, kt_end = (S + kBK - 1) / kBK;
  if (prefix_len < 0) {
    if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) + kBK - 1) / kBK);
    if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, dv = (c % CPR) * VN;
      float tk[VN], tv[VN];
      if (k0 + r < S) {
        const size_t off = (((size_t)b * S + k0 + r) * KV + kvh) * D + dv;
        Vec<T>::load(k + off, tk);
        Vec<T>::load(v + off, tv);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) tk[i] = tv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        k_s[r * DP + dv + i] = tk[i];
        v_s[r * D + dv + i] = tv[i];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        if (prefix_len >= 0) ok = ok || (kpos < prefix_len);
        ok = ok && (kpos < S);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = e;
        rs += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] *= alpha[i];
    const int c_end = min(kBK, S - k0);
#pragma unroll 4
    for (int c = 0; c < c_end; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((size_t)b * S + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_float<T>(o[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, int prefix_len,
           float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(prefill_kernel<T, D>), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, causal,
      window, prefix_len, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int KV, int causal, int window,
             int prefix_len, float scale, float softcap,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, causal, window,
                                  prefix_len, scale, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, window,
                                  prefix_len, scale, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, window,
                                  prefix_len, scale, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, causal,
                                    window, prefix_len, scale, softcap,
                                    stream);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, KV, causal,
                                    window, prefix_len, scale, softcap,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`.  window <= 0 and prefix_len < 0 mean "none";
// softcap <= 0 means no softcap.  Returns the cudaError_t of the launch.
extern "C" int prefill_attention_launch(int device, int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* out, int B, int S, int H,
                                        int KV, int D, int causal, int window,
                                        int prefix_len, float scale,
                                        float softcap, void* stream) {
  using namespace repro_torch;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_d<float>(D, q, k, v, out, B, S, H, KV, causal, window,
                           prefix_len, scale, softcap, st);
  if (dtype == kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, S, H, KV, causal,
                                   window, prefix_len, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
