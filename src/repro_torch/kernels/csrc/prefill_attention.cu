// Flash-attention forward for prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention/kernel.py
// (prefill_attention_pallas): q (B,Sq,H,D), k/v (B,Skv,KV,D) ->
// (B,Sq,H,D), with GQA through kv head = h / (H/KV), causal,
// sliding-window and prefix-LM masks and a tanh softcap.  Key positions
// are the cache's slot indices; query row i of batch row b sits at
// position q_offset[b] + i, and keys at or past kv_len[b] are neither
// read nor attended.  Both are int32 device arrays read by the kernel (a
// chunk of a longer cache launches with no host sync); null means 0 and
// Skv, the whole prompt (Sq = Skv = S), where keys at or past the true S
// are masked, so any S is exact (the TPU wrapper's zero padding attended
// to padded keys when causal=False: ROADMAP C-ref1).
//
// What bounds it: operations.  Causal prefill does ~2*S^2*H*D FLOPs on
// 2*S*(H+2*KV)*D*bytes of input, far above the byte bound at the chunk
// sizes calibration uses.  Two routes, one per element type:
//
// bf16: the tensor cores, by wgmma (bf16 in, f32 accumulate).  A block is
//   one warpgroup (4 warps) and owns BQ = 64 query rows of one (b, head),
//   the m64 of wgmma, with Q resident in shared memory.  Key tiles of BK =
//   64 keys (32 at D = 256) stream through a ring of 3 shared-memory
//   stages by cp.async, so two tiles are in flight while one is multiplied
//   and each tile costs one block barrier.  Tiles are laid out as wgmma's
//   swizzled K-major atoms (128-byte rows, 64 and 32 bytes at D = 32, 16)
//   and read through shared-memory descriptors: S = Q K^T takes both
//   operands from shared memory, and P V takes V as an MN-major operand
//   (its rows are keys) and P from registers.  S and the online softmax
//   state (m, l) stay in registers; a row's four owning lanes reduce by
//   shuffles.  P = exp(S - m) is f32; rounding it to bf16 once misses the
//   bf16 gate (one output rounding step, 2^-7) on ~10% of outputs, so P V
//   runs as two products, P_hi = bf16(P) and P_lo = bf16(P - P_hi): 1.5x
//   the tensor-core work of one product, and P exact to ~2^-16.  The mask
//   is evaluated only on tiles that the diagonal, the window edge, the
//   prefix edge or S crosses.
// f32: the FP32 pipes.  Tensor cores would take f32 as TF32, which holds
//   about three decimal digits, not the 3e-5 of the f32 gate.  One block
//   of 256 threads owns 64 query rows and stages Q, K, V and P in shared
//   memory as f32; a 16 x 16 thread grid holds a 4 x 4 patch of the scores
//   and a 4 x D/16 patch of the output.
//
// Both routes skip key tiles that the causal or window mask rules out
// entirely, so causal prefill does S^2/2 work, and a chunk reads the
// cache only up to its last row's position or kv_len, whichever is less.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr float kMinM = -1e30f;  // running-max floor: exp(kMinM - m) is 0

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows of a block, 16 a warp
constexpr int kStages = 3;        // K/V ring: two tiles load while one computes
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // K (or V) of one stage
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle atom)
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)kStages * 2 * KV_BYTES;
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows of D
// bf16, laid out as wgmma reads it with the swizzle mode of the row width
// (128, 64 or 32 bytes).  Rows wider than 128 bytes are split into
// 64-column panels.  Inside a panel, address bits [4, 4+B) are XORed with
// bits [7, 7+B), B = 3, 2, 1: the hardware's 128-, 64- and 32-byte
// swizzles, so the 8 rows of one column also sit in distinct bank groups
// for the cp.async writes.  Tiles start on 1024-byte boundaries.
template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // bytes of a panel row
  constexpr int CP = RB / 16;                    // chunks of a panel row
  const uint32_t a = (uint32_t)(r * RB + (c % CP) * 16);
  return (uint32_t)((c / CP) * ROWS * 128) +
         (a ^ (((a >> 7) & (CP - 1)) << 4));
}

// wgmma's shared-memory descriptor of the tile at `addr` laid out by swz:
// start address, the 8-row stride of the swizzle atom in both offset
// fields (one operand never spans two atoms along the other dimension),
// and the swizzle mode.
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr int RB = D * 2 < 128 ? D * 2 : 128;
  constexpr uint64_t mode = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  constexpr uint64_t atom = (8 * RB) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (atom << 16) | (atom << 32) |
         (mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a b: a (64x16) and b (16x64) K-major tiles
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d += a b: a (64x16) and b (16x32) K-major tiles
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db));
}

// d += a b: a (64x16) from registers, b (16x64) an MN-major tile
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += a b: a (64x16) from registers, b (16x32) an MN-major tile
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += a b: a (64x16) from registers, b (16x16) an MN-major tile
__device__ __forceinline__ void wgmma_rs16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// ROWS rows from row0 of a (rows, stride) bf16 matrix into a swizzled
// tile; rows at or past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int n,
                                          int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + swz<D, ROWS>(r, c),
               src + (size_t)(ok ? row0 + r : 0) * stride + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                  int KV, const int* __restrict__ q_offset,
                  const int* __restrict__ kv_len, int causal, int window,
                  int prefix_len, float scale, float softcap) {
  using Cfg = Tile<D>;
  constexpr int BK = Cfg::BK, NT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + Cfg::Q_BYTES;

  const int G = H / KV;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // position of query row 0, and the keys this batch row has
  const int qo = q_offset ? q_offset[b] : 0;
  const int S = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;

  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (prefix_len < 0) {
    if (causal)
      kt_end = min(kt_end, (qo + min(q0 + kBQ, Sq) + BK - 1) / BK);
    if (window > 0) kt_begin = max(0, qo + q0 - window + 1) / BK;
  }
  const int nt = kt_end - kt_begin;
  const int q_last = qo + min(q0 + kBQ, Sq) - 1;  // a position

  const __nv_bfloat16* kb = k + ((size_t)b * Skv * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * KV + kvh) * D;
  const size_t kv_stride = (size_t)KV * D;
  load_tile<D, kBQ>(q_s, q + ((size_t)b * Sq * H + h) * D, (size_t)H * D,
                      q0, Sq, tid);
  load_tile<D, BK>(kv_s, kb, kv_stride, kt_begin * BK, S, tid);
  load_tile<D, BK>(kv_s + Cfg::KV_BYTES, vb, kv_stride, kt_begin * BK, S,
                     tid);
  cp_commit();
  if (nt > 1) {
    load_tile<D, BK>(kv_s + 2 * Cfg::KV_BYTES, kb, kv_stride,
                       (kt_begin + 1) * BK, S, tid);
    load_tile<D, BK>(kv_s + 3 * Cfg::KV_BYTES, vb, kv_stride,
                       (kt_begin + 1) * BK, S, tid);
  }
  cp_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMinM, kMinM}, l[2] = {0.f, 0.f};
  // this lane's rows: +0, +8 (positions)
  const int row_a = qo + q0 + warp * 16 + (lane >> 2);
  // the softmax runs in base 2: raw scores are scaled inside the
  // exponent's FMA; with a softcap they are capped and scaled first
  const float c2 = softcap > 0.f ? 1.f : scale * kLog2e;
  const float cap_log2 = softcap * kLog2e, cap_in = scale / softcap;

  for (int t = 0; t < nt; ++t) {
    cp_wait<1>();  // this thread's copies of tile t have landed
    // make them visible to wgmma, which reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's have; tile t-1's readers are done
    if (t + 2 < nt) {
      const uint32_t st = kv_s + ((t + 2) % kStages) * 2 * Cfg::KV_BYTES;
      load_tile<D, BK>(st, kb, kv_stride, (kt_begin + t + 2) * BK, S, tid);
      load_tile<D, BK>(st + Cfg::KV_BYTES, vb, kv_stride,
                         (kt_begin + t + 2) * BK, S, tid);
    }
    cp_commit();
    const uint32_t ks = kv_s + (t % kStages) * 2 * Cfg::KV_BYTES;
    const uint32_t vs = ks + Cfg::KV_BYTES;
    const int k0 = (kt_begin + t) * BK;

    // S = Q K^T for the block's 64 rows and the tile's BK keys; this warp
    // holds rows 16 * warp .. + 15 (the m16n8 accumulator layout per 8 keys)
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    float(&s)[BK / 2] = reinterpret_cast<float(&)[BK / 2]>(sc);
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns of D: 32 bytes
      const uint64_t da = desc<D>(q_s + (kk / 4) * kBQ * 128 + (kk % 4) * 32);
      const uint64_t db = desc<D>(ks + (kk / 4) * BK * 128 + (kk % 4) * 32);
      if constexpr (BK == 64) {
        wgmma_ss64(s, da, db);
      } else {
        wgmma_ss32(s, da, db);
      }
    }
    wg_commit_wait();
    pin(s);

    // a tile is masked element by element only where an edge crosses it
    bool full = k0 + BK <= S;
    if (!(prefix_len >= 0 && k0 + BK <= prefix_len)) {
      if (causal) full = full && k0 + BK - 1 <= qo + q0;
      if (window > 0) full = full && q_last - k0 < window;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e];
        if (softcap > 0.f) x = cap_log2 * tanhf(x * cap_in);
        if (!full) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          bool ok = true;
          if (causal) ok = key <= row;
          if (window > 0) ok = ok && (row - key < window);
          if (prefix_len >= 0) ok = ok || (key < prefix_len);
          if (!(ok && key < S)) x = -INFINITY;
        }
        sc[j][e] = x;
      }

    // online softmax; a row's 16 scores of this lane, then its quad
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * i], sc[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = ex2((m[i] - m_new) * c2);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(fmaf(sc[j][e], c2, -m[e >> 1] * c2));
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V as P_hi V + P_lo V: the score tiles are the A fragments,
    // V an MN-major operand (D contiguous), 16 keys a product
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      split_bf16(sc[2 * i][0], sc[2 * i][1], hi[i][0], lo[i][0]);
      split_bf16(sc[2 * i][2], sc[2 * i][3], hi[i][1], lo[i][1]);
      split_bf16(sc[2 * i + 1][0], sc[2 * i + 1][1], hi[i][2], lo[i][2]);
      split_bf16(sc[2 * i + 1][2], sc[2 * i + 1][3], hi[i][3], lo[i][3]);
    }
    float(&of)[NT * 4] = reinterpret_cast<float(&)[NT * 4]>(o);
    pin(of);
    wg_fence();
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      if constexpr (D >= 64) {
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {  // one 64-column panel a product
          float(&op)[32] = reinterpret_cast<float(&)[32]>(o[8 * p]);
          const uint64_t dv = desc<D>(vs + p * BK * 128 + i * 16 * 128);
          wgmma_rs64(op, hi[i], dv);
          wgmma_rs64(op, lo[i], dv);
        }
      } else {
        const uint64_t dv = desc<D>(vs + i * 16 * D * 2);
        if constexpr (D == 32) {
          wgmma_rs32(of, hi[i], dv);
          wgmma_rs32(of, lo[i], dv);
        } else {
          wgmma_rs16(of, hi[i], dv);
          wgmma_rs16(of, lo[i], dv);
        }
      }
    }
    wg_commit_wait();
    pin(of);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_a - qo + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, const int* q_offset,
           const int* kv_len, int causal, int window, int prefix_len,
           float scale, float softcap, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(prefill_tc_kernel<D>),
                 Tile<D>::SMEM, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  prefill_tc_kernel<D><<<grid, kThreads, Tile<D>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, KV, q_offset, kv_len, causal, window, prefix_len, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 route: FP32 pipes
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
          (size_t)kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int Sq,
               int Skv, int H, int KV, const int* __restrict__ q_offset,
               const int* __restrict__ kv_len, int causal, int window,
               int prefix_len, float scale, float softcap) {
  using T = float;
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
  // position of query row 0, and the keys this batch row has
  const int qo = q_offset ? q_offset[b] : 0;
  const int S = kv_len ? max(0, min(kv_len[b], Skv)) : Skv;

  for (int c = tid; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, dv = (c % CPR) * VN;
    float tmp[VN];
    if (q0 + r < Sq) {
      Vec<T>::load(q + (((size_t)b * Sq + q0 + r) * H + h) * D + dv, tmp);
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
    if (causal)
      kt_end = min(kt_end, (qo + min(q0 + kBQ, Sq) + kBK - 1) / kBK);
    if (window > 0) kt_begin = max(0, qo + q0 - window + 1) / kBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, dv = (c % CPR) * VN;
      float tk[VN], tv[VN];
      if (k0 + r < S) {
        const size_t off = (((size_t)b * Skv + k0 + r) * KV + kvh) * D + dv;
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
      const int qpos = qo + q0 + ty * 4 + i;
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
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_float<T>(o[i][j] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, const int* q_offset,
           const int* kv_len, int causal, int window, int prefix_len,
           float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(prefill_kernel<D>), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  prefill_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KV,
      q_offset, kv_len, causal, window, prefix_len, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// one instantiation per head dim, for either route's launcher
#define REPRO_PREFILL_CASE(NS, DIM)                                         \
  case DIM:                                                                 \
    return NS::launch<DIM>(q, k, v, out, B, Sq, Skv, H, KV, q_offset,       \
                           kv_len, causal, window, prefix_len, scale,       \
                           softcap, st);
#define REPRO_PREFILL_DISPATCH(NS)                                          \
  switch (D) {                                                              \
    REPRO_PREFILL_CASE(NS, 16)                                              \
    REPRO_PREFILL_CASE(NS, 32)                                              \
    REPRO_PREFILL_CASE(NS, 64)                                              \
    REPRO_PREFILL_CASE(NS, 128)                                             \
    REPRO_PREFILL_CASE(NS, 256)                                             \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`.  bf16 launches the tensor-core kernel, f32 the
// FP32-pipe kernel.  q_offset and kv_len are null or (B,) int32: the
// position of each batch row's first query and its number of keys
// (clamped to Skv); null means 0 and Skv.  window <= 0 and prefix_len < 0
// mean "none"; softcap <= 0 means no softcap.  Returns the cudaError_t of
// the launch.
extern "C" int prefill_attention_launch(int device, int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* out, int B, int Sq, int Skv,
                                        int H, int KV, int D,
                                        const int* q_offset,
                                        const int* kv_len, int causal,
                                        int window, int prefix_len,
                                        float scale, float softcap,
                                        void* stream) {
  using namespace repro_torch;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) { REPRO_PREFILL_DISPATCH(tc) }
  if (dtype == kFloat32) { REPRO_PREFILL_DISPATCH(fp32) }
  return (int)cudaErrorInvalidValue;
}
