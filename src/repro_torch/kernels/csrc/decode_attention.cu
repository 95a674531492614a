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
// byte of bf16 cache, far below the card's ~295 FLOPs/byte ridge.  G rows do
// not fill a tensor-core tile, so the products are plain FMA.
//
// Design: one launch, memory-pipelined, merged in a cluster.
// - A block owns the GC (<= 8) query heads of one pass over one (b, kv head)
//   and one span of S.  The S-splits of a (b, kv head, pass) form one
//   thread-block cluster (gridDim.y <= 8 blocks).
// - Each of the block's 4 warps owns every 4th tile of KW keys of the span
//   and streams its tiles through its own ring of 3 shared-memory stages by
//   cp.async (16 bytes a lane), in the cache's own type: two tiles load
//   while one is computed, and the warp synchronises only with itself.
// - Scores: lane r dots key r of the tile with all GC heads (queries as f32
//   in shared memory, read as broadcasts; K rows XOR-swizzled by 16-byte
//   chunk, so 32 lanes reading one chunk column hit distinct banks).  The
//   warp keeps its own (m, l, acc) per head: the tile's max by shuffles, l
//   per lane, acc with lane j owning columns j*DPL .. j*DPL+DPL-1.
// - The warps merge once, at the end, in shared memory; the cluster's
//   blocks then merge through distributed shared memory, each block
//   finishing a slice of the outputs.  No global scratch, no second kernel.
// Keys past kv_len are never loaded, so the bytes moved follow the true
// cache fill, not S.  The split plan (KW, cluster size, keys per block) is
// chosen by the wrapper (decode_attention/ops.py: decode_plan).

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // per-warp ring: two tiles load, one computes
constexpr float kMinM = -1e30f;  // running-max floor: exp(kMinM - m) is 0
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes: rows past the span read as zeros
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive values at p (aligned to N values), widened to float
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) Vec<float>::load(p + 4 * i, out + 4 * i);
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    Vec<__nv_bfloat16>::load(p, out);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  }
}

// GC: heads per block (a power of two >= G, or 8 with G/8 passes); DPL:
// output columns per lane (32 * DPL >= D).
template <typename T, int GC, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              const int* __restrict__ k_pos, const int* __restrict__ q_pos,
              T* __restrict__ out, int S, int H, int KV, int D, int KW,
              int n_pass, int split_len, int window, float scale,
              float softcap) {
  constexpr int VN = Vec<T>::N;  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int pass = blockIdx.x % n_pass, bk = blockIdx.x / n_pass;
  const int b = bk / KV, kvh = bk % KV;
  const int g0 = pass * GC, gn = min(GC, G - g0);
  const int n_split = gridDim.y, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpr = D / VN;  // 16-byte chunks per row
  // K chunk c of row r sits at slot c ^ (r & kmask): kmask keeps it in range
  const int kmask = min(cpr & -cpr, 8) - 1;

  // shared memory: the warps' K/V rings, the queries (f32), each warp's
  // probabilities, and the block's merged state (read by the cluster)
  T* ring = reinterpret_cast<T*>(smem_raw);
  const size_t stage = (size_t)2 * KW * D;  // K then V of one tile
  float* q_s =
      reinterpret_cast<float*>(ring + (size_t)kWarps * kStages * stage);
  float* p_s = q_s + GC * D;      // kWarps * KW * GC
  float* bm = p_s + kWarps * KW * GC;  // GC
  float* bl = bm + GC;            // GC
  float* bacc = bl + GC;          // GC * D

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < GC * D; i += kThreads)
    q_s[i] = i < gn * D ? to_float(qb[i]) : 0.f;

  const int len = max(0, min(kv_len[b], S));
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, len);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KW - 1) / KW : 0;
  const int my_tiles =
      warp < n_tiles ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const int qp = window > 0 ? q_pos[b] : 0;

  T* wring = ring + (size_t)warp * kStages * stage;
  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kvh) * D;
  const T* vb = v + ((size_t)b * S * KV + kvh) * D;
  auto fetch = [&](int i) {  // this warp's i-th tile into stage i % kStages
    const int t0 = s_begin + (warp + i * kWarps) * KW;
    const int rows = min(KW, s_end - t0);
    T* ks = wring + (size_t)(i % kStages) * stage;
    T* vs = ks + (size_t)KW * D;
    for (int c = lane; c < KW * cpr; c += 32) {
      const int r = c / cpr, ch = c % cpr;
      const bool ok = r < rows;
      const size_t off = (size_t)(ok ? t0 + r : 0) * row_stride + ch * VN;
      cp_async16(ks + (size_t)r * D + (ch ^ (r & kmask)) * VN, kb + off, ok);
      cp_async16(vs + (size_t)r * D + ch * VN, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) fetch(i);
    cp_commit();
  }

  float m[GC], lsum[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kMinM;
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }
  const int d0 = lane * DPL;  // this lane's output columns
  float* pw = p_s + (size_t)warp * KW * GC;
  __syncthreads();  // q_s is written

  for (int i = 0; i < my_tiles; ++i) {
    if (i + kStages - 1 < my_tiles) fetch(i + kStages - 1);
    cp_commit();
    cp_wait<kStages - 1>();  // this lane's copies of tile i have landed
    __syncwarp();            // and every lane's
    const int t0 = s_begin + (warp + i * kWarps) * KW;
    const int rows = min(KW, s_end - t0);
    const T* ks = wring + (size_t)(i % kStages) * stage;
    const T* vs = ks + (size_t)KW * D;

    // lane r: key t0 + r against the GC heads
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    bool valid = lane < rows;
    if (valid) {
      const T* kr = ks + (size_t)lane * D;
      for (int ch = 0; ch < cpr; ++ch) {
        float kf[VN];
        Vec<T>::load(kr + (ch ^ (lane & kmask)) * VN, kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + g * D + ch * VN);
#pragma unroll
          for (int j = 0; j < VN / 4; ++j) {
            const float4 x = qv[j];
            s[g] = fmaf(x.x, kf[4 * j], s[g]);
            s[g] = fmaf(x.y, kf[4 * j + 1], s[g]);
            s[g] = fmaf(x.z, kf[4 * j + 2], s[g]);
            s[g] = fmaf(x.w, kf[4 * j + 3], s[g]);
          }
        }
      }
      if (window > 0) {
        const int kp = k_pos[(size_t)b * S + t0 + lane];
        valid = (qp - kp < window) && (kp <= qp);
      }
    }

    // online softmax per head over the warp's tile (base 2)
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float x = s[g] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = valid ? x * kLog2e : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float alpha = exp2f(m[g] - m_new);
      m[g] = m_new;
      const float p = exp2f(x - m_new);
      lsum[g] = fmaf(lsum[g], alpha, p);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
      if (lane < KW) pw[lane * GC + g] = p;
    }
    __syncwarp();

    // acc += P V over the tile's valid keys
    if (d0 < D) {
      for (int r = 0; r < rows; ++r) {
        float pr[GC], vf[DPL];
        if constexpr (GC % 4 == 0) {
#pragma unroll
          for (int j = 0; j < GC / 4; ++j)
            Vec<float>::load(pw + r * GC + 4 * j, pr + 4 * j);
        } else {
#pragma unroll
          for (int g = 0; g < GC; ++g) pr[g] = pw[r * GC + g];
        }
        load_n<DPL>(vs + (size_t)r * D + d0, vf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
      }
    }
    __syncwarp();  // the stage and pw are free for the next tile
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // the warps' states, then the block's
  float* wm = reinterpret_cast<float*>(smem_raw);  // kWarps * GC
  float* wl = wm + kWarps * GC;                     // kWarps * GC
  float* wacc = wl + kWarps * GC;                   // kWarps * GC * D
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const float lw = warp_sum(lsum[g]);
    if (lane == 0) {
      wm[warp * GC + g] = m[g];
      wl[warp * GC + g] = lw;
    }
    if (d0 < D) {
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        wacc[(warp * GC + g) * D + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * G + g0) * D;
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kMinM;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * GC + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(wm[w * GC + g] - M);
      L = fmaf(wl[w * GC + g], e, L);
      A = fmaf(wacc[(w * GC + g) * D + d], e, A);
    }
    if (n_split == 1) {
      ob[i] = from_float<T>(A / fmaxf(L, 1e-30f));
    } else {
      bacc[i] = A;
      if (d == 0) {
        bm[g] = M;
        bl[g] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the cluster's splits merge through distributed shared memory; block
  // `rank` finishes every n_split-th slice of kThreads outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * kThreads + tid; i < gn * D; i += n_split * kThreads) {
    const int g = i / D;
    float M = kMinM;
    for (int r = 0; r < n_split; ++r)
      M = fmaxf(M, cluster.map_shared_rank(bm, r)[g]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float e = exp2f(cluster.map_shared_rank(bm, r)[g] - M);
      L = fmaf(cluster.map_shared_rank(bl, r)[g], e, L);
      A = fmaf(cluster.map_shared_rank(bacc, r)[i], e, A);
    }
    ob[i] = from_float<T>(A / fmaxf(L, 1e-30f));
  }
  cluster.sync();  // no block exits while another reads its shared memory
}

template <typename T, int GC, int DPL>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           const int* k_pos, const int* q_pos, void* out, int B, int S, int H,
           int KV, int D, int KW, int n_pass, int n_split, int split_len,
           int window, float scale, float softcap, size_t smem,
           cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  auto kern = decode_kernel<T, GC, DPL>;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kern), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * n_pass, n_split, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           kv_len, k_pos, q_pos, static_cast<T*>(out), S, H,
                           KV, D, KW, n_pass, split_len, window, scale,
                           softcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int GC>
int launch_dpl(int dpl, const void* q, const void* k, const void* v,
               const int* kv_len, const int* k_pos, const int* q_pos,
               void* out, int B, int S, int H, int KV, int D, int KW,
               int n_pass, int n_split, int split_len, int window,
               float scale, float softcap, size_t smem,
               cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(DPL)                                             \
  return launch<T, GC, DPL>(q, k, v, kv_len, k_pos, q_pos, out, B, S, H, KV, \
                            D, KW, n_pass, n_split, split_len, window, scale, \
                            softcap, smem, stream)
  switch (dpl) {
    case 2: REPRO_DECODE_LAUNCH(2);
    case 4: REPRO_DECODE_LAUNCH(4);
    case 8: REPRO_DECODE_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_LAUNCH
}

template <typename T>
int launch_gc(int gc, int dpl, const void* q, const void* k, const void* v,
              const int* kv_len, const int* k_pos, const int* q_pos,
              void* out, int B, int S, int H, int KV, int D, int KW,
              int n_pass, int n_split, int split_len, int window, float scale,
              float softcap, size_t smem, cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(GC)                                               \
  return launch_dpl<T, GC>(dpl, q, k, v, kv_len, k_pos, q_pos, out, B, S, H, \
                           KV, D, KW, n_pass, n_split, split_len, window,     \
                           scale, softcap, smem, stream)
  switch (gc) {
    case 1: REPRO_DECODE_LAUNCH(1);
    case 2: REPRO_DECODE_LAUNCH(2);
    case 4: REPRO_DECODE_LAUNCH(4);
    case 8: REPRO_DECODE_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_LAUNCH
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`; k_pos/q_pos may be null when window <= 0.  The
// plan (gc heads per block, dpl columns per lane, kw keys per warp tile,
// n_pass head passes, n_split blocks per cluster of split_len keys each,
// smem bytes) comes from decode_plan in decode_attention/ops.py.  Returns
// the cudaError_t of the launch.
extern "C" int decode_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    const int* kv_len, const int* k_pos, const int* q_pos, void* out, int B,
    int S, int H, int KV, int D, int gc, int dpl, int kw, int n_pass,
    int n_split, int split_len, int window, float scale, float softcap,
    int smem, void* stream) {
  using namespace repro_torch;
  if (n_split < 1 || n_split > 8 || kw < 1 || kw > 32 || smem <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_gc<float>(gc, dpl, q, k, v, kv_len, k_pos, q_pos, out, B, S,
                            H, KV, D, kw, n_pass, n_split, split_len, window,
                            scale, softcap, (size_t)smem, st);
  if (dtype == kBFloat16)
    return launch_gc<__nv_bfloat16>(gc, dpl, q, k, v, kv_len, k_pos, q_pos,
                                    out, B, S, H, KV, D, kw, n_pass, n_split,
                                    split_len, window, scale, softcap,
                                    (size_t)smem, st);
  return (int)cudaErrorInvalidValue;
}
