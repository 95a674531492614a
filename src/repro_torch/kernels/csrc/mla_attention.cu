// Multi-head latent attention (DeepSeek-V2/V3's MLA), absorbed form, for
// sm_90a: B4.
//
// Replaces no TPU kernel: the reference computes MLA's attention with
// plain jnp.einsum (src/repro/models/mla.py), and the port's plain
// version of it (kernels/mla_attention/ops.py::mla_attention_plain)
// scored every query against every cache slot on the FP32 pipes, masked
// the slots past its position and kept a (heads, queries, slots) f32
// score tensor.  B4 serves the two calls MLA makes on the serving path,
// the one-token decode and the continuation chunk, in one kernel.
//
// What it computes.  Query n of batch row b = n / Sq (q_lat (N, H, 512),
// q_rope (N, H, 64), N = B * Sq) attends the keys 0 .. last(n) =
// min(pos[n], kv_len - 1) of cache row b (c_kv (B, S, 512), k_rope (B, S,
// 64)): s = (q_lat . c_kv + q_rope . k_rope) * scale, p = softmax(s) in
// f32, rounded to bf16, ctx = p . c_kv accumulated in f32 and rounded to
// bf16 -- the reference's arithmetic.  pos is read on the card.  A key
// past last(n) is never read: its rows of a tile are zero-filled.
//
// What bounds it.  A key is 576 bf16 shared by all H heads, and its first
// 512 are also the value, so a query's 128 heads do 128 * (2*576 + 2*512)
// FLOPs per 1152 bytes of key: 242 FLOP/B, just under the card's ridge
// (295).  The decode (64 rows over their own caches) sits near the byte
// bound, the chunk (512 queries over one slot, the keys shared) is bound
// by operations.
//
// Design.  A warpgroup owns 64 (query, head) rows -- 64 heads of one
// query, the m64 of wgmma -- over one split of the query's keys.  Key
// tiles of 64 keys x 576 stream through a ring in shared memory by
// cp.async, laid out as wgmma's 128-byte-swizzled K-major panels of 64
// columns; the same tile is K for the scores (its 9 panels) and, its
// first 8 panels read MN-major, V for P . V.
//
// The reference rounds p to bf16 after normalising it.  An online softmax
// would round the unnormalised exp(s - m) instead, which differs from the
// plain version by up to 2^-8 of sum p |v| per output.  So B4 runs two
// passes over the keys: mla_stats_kernel takes the scores alone and keeps
// each row's running max m and sum l; mla_attend_kernel takes them again,
// forms p = 2^((s - m) c) / l with the row's final m and l, rounds it
// to bf16 and accumulates p . V: the plain version's arithmetic, at 1.5x
// the tensor-core work of one pass (one pass leaves ~6% of outputs more
// than one bf16 step from the plain version, two passes ~0.03-0.04%).  The
// stats block runs both head tiles of a query (two warpgroups over the
// same key tiles), its queries held as A fragments in registers.  P . V's
// 64 x 512 f32 accumulator would need 256 registers a thread in one
// warpgroup, so the attend block has two for one head tile, its queries
// in shared memory: warpgroup 0 takes the scores, forms P and hands its
// fragments to warpgroup 1 through shared memory; each then multiplies P
// into its half of the 512 columns (4 panels, 128 accumulator registers).
//
// Splits.  A decode has few rows (64 x 2 head tiles), each over its own
// length, so one long row would serialise the call: the wrapper splits
// the keys into pieces of `split` keys, each pass of each piece a block;
// the attend blocks combine the pieces' (m, l) before forming p, write
// their piece's f32 partial of ctx, and mla_combine_kernel sums the
// pieces and rounds.  The chunk's 512 queries fill the card alone and run
// unsplit, the attend blocks writing ctx directly; its blocks start with
// the last queries, which have the most keys.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kLat = 512;               // latent width: the value
constexpr int kRope = 64;               // shared RoPE key width
constexpr int kKey = kLat + kRope;      // 576: the key
constexpr int kChunks = kKey / 8;       // 16-byte chunks of a key row
constexpr int kRows = 64;               // (query, head) rows of a block
constexpr int kBK = 64;                 // keys of a tile
constexpr int kPanel = 128;             // bytes of a panel row (64 bf16)
constexpr int kQBytes = kRows * kKey * 2;
constexpr int kTileBytes = kBK * kKey * 2;
constexpr int kStages = 2;               // the attend kernel's key ring
constexpr int kStatsStages = 3;          // the stats kernel's
constexpr int kPBytes = (kBK / 16) * 128 * 16;  // P fragments of a tile
constexpr float kMinM = -1e30f;  // running-max floor: 2^(kMinM - m) is 0
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t kStatsSmem = 1024 + (size_t)kStatsStages * kTileBytes;
constexpr size_t kAttendSmem = 1024 + kQBytes + (size_t)kStages * kTileBytes +
                               kPBytes + 2 * kRows * sizeof(float);

// Byte offset of 16-byte chunk c (0..71) of row r in a tile of ROWS rows
// of 576 bf16: 64-column panels of ROWS x 128 bytes, and inside a panel
// the 128-byte swizzle (chunk XOR row % 8), as wgmma reads it.  Tiles
// start on 1024-byte boundaries.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * kPanel + r * kPanel +
                    (((c & 7) ^ (r & 7)) << 4));
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand at
// `addr`: 8-row atoms of 1024 bytes in both offset fields.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
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

// d += a b: a (64x16) and b (16x64) K-major tiles in shared memory
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

// d += a b: a (64x16) from registers, b (16x64) a K-major (TB = 0) or
// MN-major (TB = 1) tile
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

// ROWS rows from row0 of [lat (rows, 512) | rope (rows, 64)] into a
// swizzled tile; rows at or past `end` are zero-filled and not read
template <int ROWS, int NTHR>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* lat,
                                          const __nv_bfloat16* rope,
                                          int row0, int end, int tid) {
  for (int i = tid; i < ROWS * kChunks; i += NTHR) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < end;
    const size_t row = (size_t)(ok ? row0 + r : 0);
    const __nv_bfloat16* src = c < kLat / 8
                                   ? lat + row * kLat + c * 8
                                   : rope + row * kRope + (c - kLat / 8) * 8;
    cp_async16(dst + swz<ROWS>(r, c), src, ok);
  }
}

// The block's place: query n (the last queries first), its cache row,
// the 64 heads from h0, and the keys [k_begin, k_end) of its split.
struct Place {
  int n, b, h0, last, k_begin, k_end;
  __device__ Place(const int* pos, int Sq, int S, int kv_len, int split) {
    n = gridDim.z - 1 - blockIdx.z;
    b = n / Sq;
    h0 = blockIdx.y * kRows;
    last = max(0, min(min(pos[n], kv_len - 1), S - 1));
    k_begin = blockIdx.x * split;
    k_end = min(k_begin + split, last + 1);
  }
};

// S = Q K^T for the block's 64 rows and the tile's 64 keys, one warpgroup
__device__ __forceinline__ void scores(float (&s)[32], uint32_t q_s,
                                       uint32_t ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  pin(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKey / 16; ++kk) {  // 16 columns: 32 bytes
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss64(s, desc(q_s + (kk / 4) * kRows * kPanel + off),
               desc(ks + (kk / 4) * kBK * kPanel + off));
  }
  wg_commit_wait();
  pin(s);
}

// -inf where the key is at or past k_end; element e of 8-key group j of
// this lane is key k0 + 8 j + 2 (lane & 3) + (e & 1)
__device__ __forceinline__ void mask(float (&s)[32], int k0, int k_end,
                                     int lane) {
  if (k0 + kBK <= k_end) return;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= k_end)
        s[4 * j + e] = -INFINITY;
}

// ---------------------------------------------------------------------------
// pass 1: each row's running max m and sum l over the split's keys.  A
// block takes two head tiles, one a warpgroup, over the same key tiles:
// each key tile is read once for 128 heads, and one warpgroup's
// exponentials overlap the other's products.  Q needs no shared memory:
// each warpgroup holds its 64 x 576 queries as wgmma's A fragments in
// registers (144 a thread), so the key ring has three stages.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256, 1)
mla_stats_kernel(const __nv_bfloat16* __restrict__ q_lat,
                 const __nv_bfloat16* __restrict__ q_rope,
                 const __nv_bfloat16* __restrict__ c_kv,
                 const __nv_bfloat16* __restrict__ k_rope,
                 const int* __restrict__ pos, float2* __restrict__ stats,
                 int Sq, int H, int S, int kv_len, int split, float c2) {
  const Place pl(pos, Sq, S, kv_len, split);
  if (pl.k_begin >= pl.k_end) return;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t k_s =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int N = gridDim.z;
  const int h = blockIdx.y * 2 * kRows + wg * kRows;  // this warpgroup's
  const bool mine = h < H;  // H an odd number of tiles: the last idles
  const __nv_bfloat16* ck = c_kv + (size_t)pl.b * S * kLat;
  const __nv_bfloat16* kr = k_rope + (size_t)pl.b * S * kRope;
  const int nt = (pl.k_end - pl.k_begin + kBK - 1) / kBK;

  load_rows<kBK, 256>(k_s, ck, kr, pl.k_begin, pl.k_end, tid);
  cp_commit();
  if (nt > 1)
    load_rows<kBK, 256>(k_s + kTileBytes, ck, kr, pl.k_begin + kBK,
                        pl.k_end, tid);
  cp_commit();

  // A fragments of 16 columns kk: rows ra, ra + 8 of this warp's 16, at
  // columns 16 kk + 2 (lane & 3) (+ 8); a k-step lies in q_lat or q_rope
  const int ra = warp * 16 + (lane >> 2);
  uint32_t qa[kKey / 16][4];
  if (mine) {
    const size_t row = (size_t)pl.n * H + h + ra;
#pragma unroll
    for (int kk = 0; kk < kKey / 16; ++kk) {
      const __nv_bfloat16* a =
          kk < kLat / 16 ? q_lat + row * kLat + 16 * kk
                         : q_rope + row * kRope + 16 * (kk - kLat / 16);
      const size_t down = 8 * (kk < kLat / 16 ? kLat : kRope);  // 8 rows
      const int c = 2 * (lane & 3);
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(a + c);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(a + down + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(a + c + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(a + down + c + 8);
    }
  }

  float m[2] = {kMinM, kMinM}, l[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    cp_wait<1>();  // tile t landed (t + 1 may still be in flight)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile t landed for all; tile t-1's readers are done
    if (t + 2 < nt)
      load_rows<kBK, 256>(k_s + ((t + 2) % kStatsStages) * kTileBytes, ck,
                          kr, pl.k_begin + (t + 2) * kBK, pl.k_end, tid);
    cp_commit();
    if (!mine) continue;
    const uint32_t ks = k_s + (t % kStatsStages) * kTileBytes;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKey / 16; ++kk)
      wgmma_rs64<0>(s, qa[kk],
                    desc(ks + (kk / 4) * kBK * kPanel + (kk % 4) * 32));
    wg_commit_wait();
    pin(s);
    mask(s, pl.k_begin + t * kBK, pl.k_end, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows +0 and +8 of this lane
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += ex2(fmaf(s[4 * j + 2 * i + e], c2, -m_new * c2));
      l[i] = l[i] * ex2((m[i] - m_new) * c2) + sum;
      m[i] = m_new;
    }
  }
  cp_wait<0>();
  if (!mine) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if ((lane & 3) == 0)
      stats[((size_t)blockIdx.x * N + pl.n) * H + h + ra + 8 * i] =
          make_float2(m[i], l[i]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: p with the row's final m and l, rounded to bf16, and p . V
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256, 1)
mla_attend_kernel(const __nv_bfloat16* __restrict__ q_lat,
                  const __nv_bfloat16* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ c_kv,
                  const __nv_bfloat16* __restrict__ k_rope,
                  const int* __restrict__ pos,
                  const float2* __restrict__ stats,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int Sq, int H, int S, int kv_len, int split, float c2) {
  const Place pl(pos, Sq, S, kv_len, split);
  if (pl.k_begin >= pl.k_end) return;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;
  unsigned char* base = smem_raw + (q_s - (uint32_t)__cvta_generic_to_shared(
                                               smem_raw));
  uint4* p_s = reinterpret_cast<uint4*>(base + kQBytes +
                                        kStages * kTileBytes);
  float* mc_s = reinterpret_cast<float*>(base + kQBytes +
                                         kStages * kTileBytes + kPBytes);
  float* il_s = mc_s + kRows;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int N = gridDim.z;
  const size_t qrow = (size_t)pl.n * H + pl.h0;
  const __nv_bfloat16* ck = c_kv + (size_t)pl.b * S * kLat;
  const __nv_bfloat16* kr = k_rope + (size_t)pl.b * S * kRope;
  const int nt = (pl.k_end - pl.k_begin + kBK - 1) / kBK;

  load_rows<kRows, 256>(q_s, q_lat + qrow * kLat, q_rope + qrow * kRope, 0,
                        kRows, tid);
  load_rows<kBK, 256>(k_s, ck, kr, pl.k_begin, pl.k_end, tid);
  cp_commit();

  // the row's max and sum over all its splits
  if (tid < kRows) {
    const int n_act = pl.last / split + 1;
    const float2* st = stats + (size_t)pl.n * H + pl.h0 + tid;
    const size_t step = (size_t)N * H;
    float m = kMinM;
    for (int sp = 0; sp < n_act; ++sp) m = fmaxf(m, st[sp * step].x);
    float l = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const float2 v = st[sp * step];
      l += v.y * ex2((v.x - m) * c2);
    }
    mc_s[tid] = m * c2;
    il_s[tid] = 1.f / l;
  }

  float o[32][4];  // 4 panels of 64 columns: this warpgroup's 256
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  const int ra = warp * 16 + (lane >> 2);  // rows ra, ra + 8
  float mc[2] = {0.f, 0.f}, il[2] = {0.f, 0.f};

  for (int t = 0; t < nt; ++t) {
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile t landed for all; tile t-1's readers are done
    if (t + 1 < nt)
      load_rows<kBK, 256>(k_s + ((t + 1) % kStages) * kTileBytes, ck, kr,
                          pl.k_begin + (t + 1) * kBK, pl.k_end, tid);
    cp_commit();
    const uint32_t ks = k_s + (t % kStages) * kTileBytes;

    uint32_t a[kBK / 16][4];  // P's A fragments, 16 keys each
    if (wg == 0) {
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mc[i] = mc_s[ra + 8 * i];
          il[i] = il_s[ra + 8 * i];
        }
      }
      float s[32];
      scores(s, q_s, ks);
      mask(s, pl.k_begin + t * kBK, pl.k_end, lane);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] =
              ex2(fmaf(s[4 * j + e], c2, -mc[e >> 1])) * il[e >> 1];
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        a[i][0] = as_u32(__floats2bfloat162_rn(s[8 * i], s[8 * i + 1]));
        a[i][1] = as_u32(__floats2bfloat162_rn(s[8 * i + 2], s[8 * i + 3]));
        a[i][2] = as_u32(__floats2bfloat162_rn(s[8 * i + 4], s[8 * i + 5]));
        a[i][3] = as_u32(__floats2bfloat162_rn(s[8 * i + 6], s[8 * i + 7]));
        p_s[i * 128 + wtid] = make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]);
      }
    }
    // P is in shared memory: warpgroup 1 takes the same fragments
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        const uint4 v = p_s[i * 128 + wtid];
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
    }
    float(&of)[128] = reinterpret_cast<float(&)[128]>(o);
    pin(of);
    wg_fence();
#pragma unroll
    for (int i = 0; i < kBK / 16; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float(&op)[32] = reinterpret_cast<float(&)[32]>(o[8 * p]);
        wgmma_rs64<1>(op, a[i],
                      desc(ks + (wg * 4 + p) * kBK * kPanel + i * 16 * kPanel));
      }
    wg_commit_wait();
    pin(of);
  }
  cp_wait<0>();

  // element e of 8-column group c of this warpgroup: row ra + 8 (e >> 1),
  // column 256 wg + 8 c + 2 (lane & 3) + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = qrow + ra + 8 * i;
    const int col = wg * 256 + 2 * (lane & 3);
    if (part == nullptr) {
      __nv_bfloat16* orow = out + row * kLat + col;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[c][2 * i], o[c][2 * i + 1]);
    } else {
      float* prow =
          part + ((size_t)blockIdx.x * N * H + row) * kLat + col;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        *reinterpret_cast<float2*>(prow + 8 * c) =
            make_float2(o[c][2 * i], o[c][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// split decodes: ctx = the sum of the splits' partials, rounded to bf16
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
mla_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int N, int H, int S,
                   int kv_len, int split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;  // 4 cols
  if (i >= (size_t)N * H * (kLat / 4)) return;
  const int n = (int)(i / ((size_t)H * (kLat / 4)));
  const int last = max(0, min(min(pos[n], kv_len - 1), S - 1));
  const int n_act = last / split + 1;
  const size_t step = (size_t)N * H * kLat;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < n_act; ++sp) {
    const float4 v = reinterpret_cast<const float4*>(part + sp * step)[i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  o[0] = __floats2bfloat162_rn(acc.x, acc.y);
  o[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`, all bf16 but pos (N int32), stats (n_split * N
// * H float2) and part (n_split * N * H * 512 f32, null when n_split is
// 1).  Query n reads cache row n / Sq up to key min(pos[n], kv_len - 1),
// in n_split pieces of `split` keys.  Returns the cudaError_t of the
// launches.
extern "C" int mla_attention_launch(int device, const void* q_lat,
                                    const void* q_rope, const void* c_kv,
                                    const void* k_rope, const int* pos,
                                    void* out, void* stats, void* part, int N,
                                    int Sq, int H, int S, int kv_len,
                                    int split, int n_split, float scale,
                                    void* stream) {
  using namespace repro_torch;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || Sq <= 0 || N % Sq || H <= 0 || H % kRows || S <= 0 ||
      kv_len <= 0 || split <= 0 || split % kBK || n_split <= 0 ||
      (n_split > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  static size_t allowed_stats[kMaxDevices] = {};
  static size_t allowed_attend[kMaxDevices] = {};
  err = allow_smem(reinterpret_cast<const void*>(mla_stats_kernel),
                   kStatsSmem, allowed_stats);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(reinterpret_cast<const void*>(mla_attend_kernel),
                   kAttendSmem, allowed_attend);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c2 = scale * kLog2e;
  const dim3 grid(n_split, H / kRows, N);
  const auto* ql = static_cast<const __nv_bfloat16*>(q_lat);
  const auto* qr = static_cast<const __nv_bfloat16*>(q_rope);
  const auto* ck = static_cast<const __nv_bfloat16*>(c_kv);
  const auto* kr = static_cast<const __nv_bfloat16*>(k_rope);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const dim3 grid_stats(n_split, (H / kRows + 1) / 2, N);
  mla_stats_kernel<<<grid_stats, 256, kStatsSmem, st>>>(
      ql, qr, ck, kr, pos, static_cast<float2*>(stats), Sq, H, S, kv_len,
      split, c2);
  mla_attend_kernel<<<grid, 256, kAttendSmem, st>>>(
      ql, qr, ck, kr, pos, static_cast<const float2*>(stats), o,
      static_cast<float*>(part), Sq, H, S, kv_len, split, c2);
  if (n_split > 1) {
    const size_t n4 = (size_t)N * H * (kLat / 4);
    mla_combine_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), pos, o, N, H, S, kv_len, split);
  }
  return (int)cudaGetLastError();
}
