// One-token GQA decode attention over a contiguous KV cache, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas): q (B,1,H,D) against k/v (B,S,KV,D); slot s of
// row b is a valid key where s < kv_len[b] and, with a sliding window,
// where q_pos[b] - k_pos[b,s] < window and k_pos[b,s] <= q_pos[b].  An
// optional tanh softcap bounds the scores.  A row with no valid key writes
// zeros (as the TPU kernel does at kv_len == 0).
//
// What bounds it: bytes.  Each key is read once and meets the G = H/KV query
// heads of its group (G = 7 for qwen2-0.5b), so there are ~2G FLOPs per
// byte of bf16 cache, far below the card's ~295 FLOPs/byte ridge.
//
// Design.  The TPU walked S sequentially inside one (b, kv-head) program.
// Here B*KV blocks alone leave most of the 132 SMs idle at calibration
// sizes (16 to 32 blocks), so S is split across gridDim.y (flash-decoding):
// each block runs the online softmax over its span of S in tiles of TS keys
// staged through shared memory with 16-byte loads, keeping m, l and the
// (G, D) accumulator in f32, and writes the unnormalised partials; a second
// kernel merges the splits.  With one split the first kernel writes the
// output itself.  Keys past kv_len are never loaded, so the bytes moved
// follow the true cache fill, not S.  G query rows do not fill a tensor-core
// tile, so the products are plain FMA.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr float kMinM = -1e30f;  // running-max floor: exp(kMinM - m) is 0

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_len,
               const int* __restrict__ k_pos, const int* __restrict__ q_pos,
               T* __restrict__ out, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int S, int H, int KV, int D, int TS, int window, float scale,
               float softcap, int split_len) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int bk = blockIdx.x;  // b * KV + kv head
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bk / KV, kvh = bk % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  constexpr int VN = Vec<T>::N;
  const int cpr = D / VN;  // 16-byte chunks per row
  const int DP = D + 1;    // padded K row: conflict-free column reads

  float* q_s = smem;               // G * D
  float* acc_s = q_s + G * D;      // G * D
  float* k_s = acc_s + G * D;      // TS * DP
  float* v_s = k_s + TS * DP;      // TS * D
  float* p_s = v_s + TS * D;       // G * TS
  float* m_s = p_s + G * TS;       // G
  float* l_s = m_s + G;            // G
  float* a_s = l_s + G;            // G

  // heads kvh*G .. kvh*G+G-1 of row b are one contiguous (G, D) block
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int c = tid; c < G * cpr; c += blockDim.x) {
    float tmp[VN];
    Vec<T>::load(qb + (size_t)c * VN, tmp);
#pragma unroll
    for (int i = 0; i < VN; ++i) q_s[c * VN + i] = tmp[i];
  }
  for (int i = tid; i < G * D; i += blockDim.x) acc_s[i] = 0.f;
  if (tid < G) {
    m_s[tid] = kMinM;
    l_s[tid] = 0.f;
  }
  const int len = max(0, min(kv_len[b], S));
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, len);
  const int qp = window > 0 ? q_pos[b] : 0;
  __syncthreads();

  for (int t0 = s_begin; t0 < s_end; t0 += TS) {
    const int rows = min(TS, s_end - t0);
    for (int c = tid; c < rows * cpr; c += blockDim.x) {
      const int r = c / cpr, dv = (c % cpr) * VN;
      const size_t off = (((size_t)b * S + t0 + r) * KV + kvh) * D + dv;
      float tmp[VN];
      Vec<T>::load(k + off, tmp);
#pragma unroll
      for (int i = 0; i < VN; ++i) k_s[r * DP + dv + i] = tmp[i];
      Vec<T>::load(v + off, tmp);
#pragma unroll
      for (int i = 0; i < VN; ++i) v_s[r * D + dv + i] = tmp[i];
    }
    __syncthreads();

    // scores of every (head, key) pair of the tile; masked keys get -inf
    for (int idx = tid; idx < G * rows; idx += blockDim.x) {
      const int g = idx / rows, r = idx % rows;
      const float* qr = q_s + g * D;
      const float* kr = k_s + r * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool valid = true;
      if (window > 0) {
        const int kp = k_pos[(size_t)b * S + t0 + r];
        valid = (qp - kp < window) && (kp <= qp);
      }
      p_s[g * TS + r] = valid ? s : -INFINITY;
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int g = warp; g < G; g += n_warps) {
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * TS + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float e = expf(p_s[g * TS + r] - m_new);
        p_s[g * TS + r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += blockDim.x) {
      const int g = idx / D, d = idx % D;
      const float* pr = p_s + g * TS;
      float a = acc_s[idx] * a_s[g];
      for (int r = 0; r < rows; ++r) a = fmaf(pr[r], v_s[r * D + d], a);
      acc_s[idx] = a;
    }
    __syncthreads();
  }

  if (n_split == 1) {
    T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
    for (int idx = tid; idx < G * D; idx += blockDim.x)
      ob[idx] = from_float<T>(acc_s[idx] / fmaxf(l_s[idx / D], 1e-30f));
    return;
  }
  const size_t part = (size_t)bk * n_split + split;
  for (int idx = tid; idx < G * D; idx += blockDim.x)
    part_acc[part * G * D + idx] = acc_s[idx];
  if (tid < G) {
    part_m[part * G + tid] = m_s[tid];
    part_l[part * G + tid] = l_s[tid];
  }
}

// Merge the n_split partial softmax states of one (b, kv head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int H, int KV, int D, int n_split) {
  const int G = H / KV;
  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk % KV;
  const size_t p0 = (size_t)bk * n_split;
  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float m = kMinM;
    for (int i = 0; i < n_split; ++i) m = fmaxf(m, part_m[(p0 + i) * G + g]);
    float l = 0.f, o = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(part_m[(p0 + i) * G + g] - m);
      l = fmaf(part_l[(p0 + i) * G + g], w, l);
      o = fmaf(part_acc[(p0 + i) * G * D + idx], w, o);
    }
    ob[idx] = from_float<T>(o / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           const int* k_pos, const int* q_pos, void* out, float* part_m,
           float* part_l, float* part_acc, int B, int S, int H, int KV, int D,
           int TS, int window, float scale, float softcap, int n_split,
           int split_len, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)TS * (2 * D + 1) +
                       (size_t)G * TS + 3 * (size_t)G);
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(decode_partial<T>), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  decode_partial<T><<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, k_pos, q_pos, static_cast<T*>(out),
      part_m, part_l, part_acc, S, H, KV, D, TS, window, scale, softcap,
      split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_combine<T><<<B * KV, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), H, KV, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`; k_pos/q_pos may be null when window <= 0, and the
// part_* scratch when n_split == 1.  Returns the cudaError_t of the launches.
extern "C" int decode_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    const int* kv_len, const int* k_pos, const int* q_pos, void* out,
    float* part_m, float* part_l, float* part_acc, int B, int S, int H,
    int KV, int D, int TS, int window, float scale, float softcap,
    int n_split, int split_len, void* stream) {
  using namespace repro_torch;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, kv_len, k_pos, q_pos, out, part_m, part_l,
                         part_acc, B, S, H, KV, D, TS, window, scale, softcap,
                         n_split, split_len, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, kv_len, k_pos, q_pos, out, part_m,
                                 part_l, part_acc, B, S, H, KV, D, TS, window,
                                 scale, softcap, n_split, split_len, st);
  return (int)cudaErrorInvalidValue;
}
