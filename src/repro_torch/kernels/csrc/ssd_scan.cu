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
// Chunking is exact, so the chunk is a tiling choice only; the last chunk
// may be ragged, so any S works.
//
// What bounds it: operations.  Per token and head a chunk of Q tokens
// does about 2QN/H + 2QP + 4PN FLOPs on a few bytes.  Two routes, one per
// element type:
//
// bf16: the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate),
//   after Mamba-2's own GPU decomposition: chunks of kQ = 128 tokens run in
//   parallel and only the state carry is sequential.
//     1. chunk kernel, state mode, per (b, chunk, head group, p slice):
//        the chunk's own state s_c = sum_s exp(cum_last - cum_s) x_s B_s^T
//        (P x Q . Q x N) into scratch, and exp(cum_last) per head;
//     2. carry kernel, elementwise over the B*H*P*N lanes: walks the
//        chunks in order, h_c = exp(cum_last) h_{c-1} + s_c, leaves the
//        state entering each chunk in place of s_c and writes the final
//        state;
//     3. chunk kernel, y mode: y = ((C B^T) o L) x + exp(cum_t) C h_in.
//   A call of one chunk from a zero state (the serving engine's) is one
//   launch of the chunk kernel in both modes, with the state written
//   straight to the output and no carried term.  C B^T depends only on
//   (b, chunk) (one group), so a block takes several heads and forms it
//   once, in registers, where its accumulator tiles are already the A
//   operand of W x; only L (through cum) is per head.  A warp owns 16 rows
//   of y; warps w and w + 4 share a scheduler and take row tiles w and
//   7 - w, so the causal work is even across schedulers.  C, B and x are
//   bf16 and go in exactly; the f32 operands are split into bf16 terms,
//   since one rounding of any of them misses the gates
//   (tests/test_torch_ssd_design.py), and two (hi + lo, about 16 bits)
//   leave y's error tail at the gate over 10^8 outputs: W = (C B^T) o L,
//   the carried state h and x o seg (seg = exp(cum_last - cum_s)) go in as
//   three bf16 terms each, about 24 bits, as accurate as the f32 plain
//   version.  cum is kept in base 2, so each exp is one ex2; it is taken
//   only where s <= t (above the diagonal exp(cum_t - cum_s) can
//   overflow, and inf * 0 is NaN).  Operands are staged by cp.async into padded rows of shared
//   memory (16 bytes per row of padding: ldmatrix reads them without bank
//   conflicts); the next head's x and h_in load while this head computes.
// f32: the FP32 pipes.  Tensor cores would take f32 as TF32, about three
//   decimal digits, not the 3e-5 of the f32 gate.  One block per (b, h,
//   16 columns of P) walks 32-token chunks in order with the state slice
//   in shared memory.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kQ = 128;       // tokens per chunk (ops.py, _CHUNK)
constexpr int kWarps = 8;     // each owns a 16-row tile of y (see tt)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPB = 64;    // columns p per block (ops.py, _MAX_PB)
constexpr int kPad = 8;       // bf16 elements of padding per staged row

enum Mode : int { kState = 1, kY = 2, kInter = 4 };

// Shared-memory layout of one launch; qr rows of a chunk are staged (qr a
// multiple of 16, zeros past the chunk's end).  x has two buffers: the
// next head's load overlaps this head's products.  ops.py (_smem) repeats
// it.
struct Layout {
  int np, ldb, ldx, ldt;                // N rounded up to 16; row strides
  uint32_t cum, seg, bs, cs, xs, hraw, hh, xt, bytes;
};

__host__ __device__ inline Layout layout(int qr, int N, int PB, int HB,
                                         int mode) {
  Layout L;
  L.np = (N + 15) / 16 * 16;
  L.ldb = L.np + kPad;
  L.ldx = PB + kPad;
  L.ldt = qr + kPad;
  uint32_t o = 0;
  L.cum = o;                                    // f32 cum of each head
  o += 4 * kQ * HB;
  L.seg = o;                                    // exp(cum_last - cum), state
  if (mode & kState) o += 4 * kQ * HB;
  L.bs = o;                                     // B: qr x np
  o += 2 * qr * L.ldb;
  L.cs = o;                                     // C: qr x np (y mode)
  if (mode & kY) o += 2 * qr * L.ldb;
  L.xs = o;                                     // x of a head: qr x PB, 2
  o += 2 * 2 * qr * L.ldx;
  L.hraw = o;                                   // h_in as loaded: PB x N f32
  if (mode & kInter) o += 4 * PB * N;
  L.hh = o;                                     // h_in, 3 terms: PB x np
  if (mode & kInter) o += 3 * 2 * PB * L.ldb;
  L.xt = o;                                     // x o seg, 3 terms: PB x qr
  if (mode & kState) o += 3 * 2 * PB * L.ldt;
  L.bytes = o;
  return L;
}

// rows [0, qr) of a (rows, N) bf16 matrix into a staged tile of row
// stride ld; rows past q and columns past N read as zeros
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src,
                                           size_t stride, int q, int qr,
                                           int cols, int ncols, int ld,
                                           int tid) {
  const int cpr = cols / 8;  // 16-byte chunks per staged row
  for (int i = tid; i < qr * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 8;
    const bool ok = r < q && c < ncols;
    cp_async16(dst + 2 * (r * ld + c), src + (ok ? r * stride + c : 0), ok);
  }
}

// cum[t] = (log_a[0] + ... + log_a[t]) log2(e) over the chunk (zeros past
// q), by one warp: 4 tokens a lane, then a warp scan of the lanes' sums.
// In base 2, each exp below is one ex2.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* la,
                                             int H, int q, int lane) {
  constexpr float kLog2e = 1.4426950408889634f;
  float v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * lane + i;
    run += t < q ? la[(size_t)t * H] : 0.f;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    cum[4 * lane + i] = (v[i] + (incl - run)) * kLog2e;
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ log_a,
                 bf16* __restrict__ y, float* __restrict__ st,
                 float* __restrict__ dec, int S, int H, int P, int N, int HB,
                 int PB, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const int n_ps = P / PB;
  const int h_begin = (blockIdx.x / n_ps) * HB, p0 = (blockIdx.x % n_ps) * PB;
  const int h_end = min(H, h_begin + HB);
  const int c = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const int c0 = c * kQ, q = min(kQ, S - c0), qr = (q + 15) & ~15;
  const Layout L = layout(qr, N, PB, HB, mode);
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t xs_bytes = 2 * qr * L.ldx;  // one buffer of x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // this warp's 16 rows of y, tile tt: warps w and w + 4 share a
  // scheduler, so they take tiles w and 7 - w, whose causal work (tt + 1
  // tiles of s) sums to the same for every scheduler
  const int tt = warp < 4 ? warp : 11 - warp, t0 = 16 * tt;
  const bool rows = (mode & kY) && t0 < qr;
  // ldmatrix row addresses, by lane: rows 0-15 at columns 0 / 8 (an A
  // operand), and the two 8-row halves of a B operand's 16-row k-slice
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3),
            b_col = ((lane >> 3) & 1) * 8;   // non-transposed B
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8,
            t_col = (lane >> 4) * 8;         // transposed B
  // row of head h's state slice in st: (b, chunk, h, p0)
  auto st_row = [&](int h) {
    return (((size_t)b * nch + c) * H + h) * P + p0;
  };
  // x, and the state entering the chunk, of head h into buffer buf
  const uint32_t h_term = 2 * PB * L.ldb;  // bytes of one term of h_in
  auto prefetch = [&](int h, int buf) {
    stage_rows(base + L.xs + buf * xs_bytes,
               x + (((size_t)b * S + c0) * H + h) * P + p0, (size_t)H * P, q,
               qr, PB, PB, L.ldx, tid);
    if (mode & kInter) {
      const float* hin = st + st_row(h) * N;
      for (int i = tid; i < PB * N / 4; i += kThreads)
        cp_async16(base + L.hraw + 16 * i, hin + 4 * i, true);
    }
    cp_commit();
  };

  stage_rows(base + L.bs, Bm + ((size_t)b * S + c0) * N, N, q, qr, L.np, N,
             L.ldb, tid);
  if (mode & kY)
    stage_rows(base + L.cs, Cm + ((size_t)b * S + c0) * N, N, q, qr, L.np,
               N, L.ldb, tid);
  prefetch(h_begin, 0);
  // while those land: cum of every head of the block, a warp a head, and
  // (state mode) seg = exp(cum_last - cum)
  for (int i = warp; i < h_end - h_begin; i += kWarps) {
    float* cum = reinterpret_cast<float*>(smem + L.cum) + i * kQ;
    chunk_cumsum(cum, log_a + ((size_t)b * S + c0) * H + h_begin + i, H, q,
                 lane);
    if (mode & kState) {
      __syncwarp();
      float* seg = reinterpret_cast<float*>(smem + L.seg) + i * kQ;
      const float clast = cum[q - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        seg[4 * lane + k] = ex2(clast - cum[4 * lane + k]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // G = C B^T for this warp's 16 rows and every s <= t: 16 tiles of 8
  // columns, accumulated over N in 16-column steps.  Shared by the heads.
  float G[kQ / 8][4];
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
  if (rows && tt == 0) {
    // one tile of s: two accumulators would chain every product over N,
    // so four partial sums take turns (the serving engine's chunk)
    float g4[4][2][4] = {};
    for (int k0 = 0; k0 < L.np / 16; k0 += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        if (k < L.np / 16) {
          uint32_t a[4], bb[4];
          ldsm_x4(a, base + L.cs + 2 * (a_row * L.ldb + 16 * k + a_col));
          ldsm_x4(bb, base + L.bs + 2 * (b_row * L.ldb + 16 * k + b_col));
          mma16816(g4[i][0], a, bb[0], bb[1]);
          mma16816(g4[i][1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        G[t][e] = (g4[0][t][e] + g4[1][t][e]) + (g4[2][t][e] + g4[3][t][e]);
  } else if (rows) {
#pragma unroll 4
    for (int k = 0; k < L.np / 16; ++k) {
      uint32_t a[4];
      ldsm_x4(a, base + L.cs + 2 * ((t0 + a_row) * L.ldb + 16 * k + a_col));
#pragma unroll
      for (int j = 0; j < kQ / 16; ++j) {
        if (j <= tt) {
          uint32_t bb[4];
          ldsm_x4(bb, base + L.bs +
                          2 * ((16 * j + b_row) * L.ldb + 16 * k + b_col));
          mma16816(G[2 * j], a, bb[0], bb[1]);
          mma16816(G[2 * j + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

  for (int h = h_begin; h < h_end; ++h) {
    const int buf = (h - h_begin) & 1;
    const float* cum =
        reinterpret_cast<const float*>(smem + L.cum) + (h - h_begin) * kQ;
    const uint32_t xsb = base + L.xs + buf * xs_bytes;
    if (mode & kInter) {  // the state entering the chunk, as three terms
      const float* hraw = reinterpret_cast<const float*>(smem + L.hraw);
      uint32_t* hw = reinterpret_cast<uint32_t*>(smem + L.hh);
      const int half = L.np / 2, tw = h_term / 4;  // words of one term
#pragma unroll 4
      for (int i = tid; i < PB * half; i += kThreads) {
        const int p = i / half, n = 2 * (i % half);
        const float2 v = n < N ? *reinterpret_cast<const float2*>(
                                     hraw + p * N + n)
                               : make_float2(0.f, 0.f);
        const int o = (p * L.ldb + n) / 2;
        split3_bf16(v.x, v.y, hw[o], hw[tw + o], hw[2 * tw + o]);
      }
      __syncthreads();  // the terms are staged; the raw buffer is free
    }
    if (h + 1 < h_end) prefetch(h + 1, buf ^ 1);

    if (rows) {
      // y = W x + exp(cum_t) C h_in over this warp's rows, PB columns
      float acc[kMaxPB / 8][4], inter[kMaxPB / 8][4];
#pragma unroll
      for (int j = 0; j < kMaxPB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = inter[j][e] = 0.f;
      const int ta = t0 + g, tb = ta + 8;
      const float ca = cum[ta], cb = cum[tb];
#pragma unroll
      for (int j = 0; j < kQ / 16; ++j) {
        if (j > tt) continue;
        // W on columns s = 16j + 2tq (+1, +8, +9): G's accumulator tiles
        // 2j and 2j+1 are the A operand's fragments
        const int s = 16 * j + 2 * tq;
        const float cs[4] = {cum[s], cum[s + 1], cum[s + 8], cum[s + 9]};
        float w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int tile = 2 * j + (e >> 2), r = e & 3;  // G[tile][r]
          const int t = (r >> 1) ? tb : ta;
          const int si = ((e >> 2) << 1) | (r & 1);      // index into cs
          const int sv = s + ((e >> 2) << 3) + (r & 1);
          w[e] = sv <= t ? G[tile][r] * ex2((t == ta ? ca : cb) - cs[si])
                         : 0.f;
        }
        uint32_t wt[3][4];  // W as three bf16 terms
        split3_bf16(w[0], w[1], wt[0][0], wt[1][0], wt[2][0]);  // row g, k 2tq
        split3_bf16(w[2], w[3], wt[0][1], wt[1][1], wt[2][1]);  // row g+8
        split3_bf16(w[4], w[5], wt[0][2], wt[1][2], wt[2][2]);  // row g, k+8
        split3_bf16(w[6], w[7], wt[0][3], wt[1][3], wt[2][3]);  // row g+8
#pragma unroll
        for (int n = 0; n < kMaxPB / 16; ++n) {
          if (16 * n >= PB) break;
          uint32_t bx[4];
          ldsm_x4_t(bx, xsb + 2 * ((16 * j + t_row) * L.ldx + 16 * n + t_col));
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            mma16816(acc[2 * n], wt[term], bx[0], bx[1]);
            mma16816(acc[2 * n + 1], wt[term], bx[2], bx[3]);
          }
        }
      }
      if (mode & kInter) {
#pragma unroll 2
        for (int k = 0; k < L.np / 16; ++k) {
          uint32_t a[4];
          ldsm_x4(a,
                  base + L.cs + 2 * ((t0 + a_row) * L.ldb + 16 * k + a_col));
#pragma unroll
          for (int n = 0; n < kMaxPB / 16; ++n) {
            if (16 * n >= PB) break;
            const uint32_t off =
                base + L.hh + 2 * ((16 * n + b_row) * L.ldb + 16 * k + b_col);
#pragma unroll
            for (int term = 0; term < 3; ++term) {
              uint32_t bh[4];
              ldsm_x4(bh, off + term * h_term);
              mma16816(inter[2 * n], a, bh[0], bh[1]);
              mma16816(inter[2 * n + 1], a, bh[2], bh[3]);
            }
          }
        }
      }
      const float ea = ex2(ca), eb = ex2(cb);
      bf16* yr = y + (((size_t)b * S + c0) * H + h) * P + p0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kMaxPB / 8; ++j) {
        if (8 * j >= PB) break;
        if (ta < q)
          *reinterpret_cast<__nv_bfloat162*>(yr + (size_t)ta * H * P + 8 * j) =
              __floats2bfloat162_rn(fmaf(inter[j][0], ea, acc[j][0]),
                                    fmaf(inter[j][1], ea, acc[j][1]));
        if (tb < q)
          *reinterpret_cast<__nv_bfloat162*>(yr + (size_t)tb * H * P + 8 * j) =
              __floats2bfloat162_rn(fmaf(inter[j][2], eb, acc[j][2]),
                                    fmaf(inter[j][3], eb, acc[j][3]));
      }
    }

    if (mode & kState) {
      // x o seg as three bf16 terms, transposed: xt[term][p][s], a 16 x 16
      // tile at a time (ldmatrix.trans in, stmatrix out), from the last
      // warp down: the first warps own the most rows of y
      const float* seg =
          reinterpret_cast<const float*>(smem + L.seg) + (h - h_begin) * kQ;
      const int mt = PB / 16;
      for (int u = kWarps - 1 - warp; u < mt * (qr / 16); u += kWarps) {
        const int pt = 16 * (u % mt), st0 = 16 * (u / mt);
        uint32_t r[4];
        ldsm_x4_t(r, xsb + 2 * ((st0 + b_row) * L.ldx + pt + b_col));
        // r[i]: p = pt + g (+8 for i odd), s = st0 + 2tq (+8 for i >= 2)
        uint32_t t[3][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int sv = st0 + 2 * tq + (i >> 1) * 8;
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r[i]));
          split3_bf16(v.x * seg[sv], v.y * seg[sv + 1], t[0][i], t[1][i],
                      t[2][i]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
          stsm_x4(base + L.xt +
                      2 * (term * PB * L.ldt + (pt + a_row) * L.ldt + st0 +
                           a_col),
                  t[term]);
      }
      __syncthreads();
      // s_c = (x o seg)^T B: M = p, N = n, K = s.  A warp takes one 16-row
      // tile of p and ng 8-column tiles of n (ng as wide as still gives
      // every warp work), so each A fragment feeds ng products.
      float* so = st + st_row(h) * N;
      const int nt = L.np / 8;
      int ng = 8;
      while (ng > 2 && mt * ((nt + ng - 1) / ng) < kWarps) ng >>= 1;
      for (int u = warp; u < mt * ((nt + ng - 1) / ng); u += kWarps) {
        const int m = u % mt, n0 = (u / mt) * ng;
        float sacc[8][4];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[jn][e] = 0.f;
        for (int k = 0; k < qr / 16; ++k) {
          uint32_t a[3][4], bb[4][4];
#pragma unroll
          for (int term = 0; term < 3; ++term)
            ldsm_x4(a[term], base + L.xt +
                                 2 * (term * PB * L.ldt +
                                      (16 * m + a_row) * L.ldt + 16 * k +
                                      a_col));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (2 * jj < ng && n0 + 2 * jj < nt)
              ldsm_x4_t(bb[jj], base + L.bs +
                                    2 * ((16 * k + t_row) * L.ldb +
                                         8 * (n0 + 2 * jj) + t_col));
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (2 * jj < ng && n0 + 2 * jj < nt) {
                mma16816(sacc[2 * jj], a[term], bb[jj][0], bb[jj][1]);
                mma16816(sacc[2 * jj + 1], a[term], bb[jj][2], bb[jj][3]);
              }
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int n = 8 * (n0 + jn) + 2 * tq;
          if (jn >= ng || 8 * (n0 + jn) >= N) continue;
          const int p = 16 * m + g;
          *reinterpret_cast<float2*>(so + (size_t)p * N + n) =
              make_float2(sacc[jn][0], sacc[jn][1]);
          *reinterpret_cast<float2*>(so + (size_t)(p + 8) * N + n) =
              make_float2(sacc[jn][2], sacc[jn][3]);
        }
      }
      if (dec != nullptr && p0 == 0 && tid == 0)
        dec[((size_t)b * nch + c) * H + h] = ex2(cum[q - 1]);
    }
    if (h + 1 < h_end) {
      cp_wait<0>();     // the next head's x (and state) have landed
      __syncthreads();  // and this head's readers are done
    }
  }
}

// The carry over chunks, one lane per 4 consecutive (p, n) of a (b, h):
// st holds each chunk's own state s_c and leaves with the state entering
// it.
__global__ void __launch_bounds__(256)
ssd_carry_kernel(float* __restrict__ st, const float* __restrict__ dec,
                 const float* __restrict__ h0, float* __restrict__ h_out,
                 int nch, int H, int PN, size_t lanes) {
  constexpr int kU = 8;  // chunks loaded ahead of the dependent updates
  const size_t e4 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e4 >= lanes) return;
  const size_t e = 4 * e4, bh = e / PN;
  const size_t b = bh / H, h = bh % H, pn = e % PN;
  float4 hp = h0 != nullptr ? *reinterpret_cast<const float4*>(h0 + e)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nch; c += kU) {
    float4 s[kU];
    float d[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      if (c + i < nch) {
        const size_t row = (b * nch + c + i) * H + h;
        s[i] = *reinterpret_cast<const float4*>(st + row * PN + pn);
        d[i] = dec[row];
      }
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      if (c + i < nch) {
        *reinterpret_cast<float4*>(st + ((b * nch + c + i) * H + h) * PN +
                                   pn) = hp;
        hp = make_float4(fmaf(hp.x, d[i], s[i].x), fmaf(hp.y, d[i], s[i].y),
                         fmaf(hp.z, d[i], s[i].z), fmaf(hp.w, d[i], s[i].w));
      }
    }
  }
  *reinterpret_cast<float4*>(h_out + e) = hp;
}

int launch_chunk(const bf16* x, const bf16* Bm, const bf16* Cm,
                 const float* log_a, bf16* y, float* st, float* dec, int B,
                 int S, int H, int P, int N, int HB, int PB, int mode,
                 cudaStream_t stream) {
  const int nch = (S + kQ - 1) / kQ;
  const int qr = min(kQ, (S + 15) / 16 * 16);
  const size_t smem = layout(qr, N, PB, HB, mode).bytes;
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ssd_chunk_kernel), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + HB - 1) / HB * (P / PB), nch, B);
  ssd_chunk_kernel<<<grid, kThreads, smem, stream>>>(
      x, Bm, Cm, log_a, y, st, dec, S, H, P, N, HB, PB, mode);
  return (int)cudaGetLastError();
}

// st and dec null: one chunk from a zero state, one launch.  Otherwise st
// (B, chunks, H, P, N) and dec (B, chunks, H) are f32 scratch: state
// launch, carry, y launch.
int launch(const void* xv, const void* Bv, const void* Cv,
           const float* log_a, const float* h0, void* yv, float* h_out,
           float* st, float* dec, int B, int S, int H, int P, int N, int HB,
           int PB, cudaStream_t stream) {
  const bf16* x = static_cast<const bf16*>(xv);
  const bf16* Bm = static_cast<const bf16*>(Bv);
  const bf16* Cm = static_cast<const bf16*>(Cv);
  bf16* y = static_cast<bf16*>(yv);
  if (HB < 1 || PB < 16 || PB > kMaxPB || PB % 16 || P % PB)
    return (int)cudaErrorInvalidValue;
  if (st == nullptr) {
    if (S > kQ || h0 != nullptr) return (int)cudaErrorInvalidValue;
    return launch_chunk(x, Bm, Cm, log_a, y, h_out, nullptr, B, S, H, P, N,
                        HB, PB, kState | kY, stream);
  }
  if (dec == nullptr) return (int)cudaErrorInvalidValue;
  int err = launch_chunk(x, Bm, Cm, log_a, y, st, dec, B, S, H, P, N, HB,
                         PB, kState, stream);
  if (err != 0) return err;
  const int nch = (S + kQ - 1) / kQ;
  const size_t lanes = (size_t)B * H * P * N / 4;
  ssd_carry_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(
      st, dec, h0, h_out, nch, H, P * N, lanes);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_chunk(x, Bm, Cm, log_a, y, st, dec, B, S, H, P, N, HB, PB,
                      kY | kInter, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 route: FP32 pipes
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kQ = 32;        // tokens per chunk; one warp scans a chunk
constexpr int kPB = 16;       // columns p of y (rows of the state) per block
constexpr int kThreads = 256;
constexpr int kWP = kQ + 1;   // padded row of W

size_t smem_bytes(int N) {
  const size_t NP = (size_t)N + 1;
  return sizeof(float) * (2 * kQ * NP + kPB * NP + kQ * kPB + kQ * kWP + kQ);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ log_a,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int N) {
  using T = float;
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

int launch(const void* x, const void* Bm, const void* Cm, const float* log_a,
           const float* h0, void* y, float* h_out, int B, int S, int H, int P,
           int N, cudaStream_t stream) {
  if (P % kPB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N);
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(ssd_scan_kernel), smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / kPB, H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), log_a, h0, static_cast<float*>(y), h_out,
      S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace fp32

}  // namespace
}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  Pointers are device pointers
// on CUDA device `device`; h0 may be null (zero initial state).  Needs
// P % 16 == 0 and N % 8 == 0, N <= 256 (the wrapper checks).  f32 runs the
// FP32-pipe kernel and ignores the rest.  bf16 runs the tensor-core
// kernels as ops.py's ssd_plan sets them: hb heads and pb columns of P a
// block; st and dec are its scratch, null for one chunk from a zero
// state.  Returns the cudaError_t of the launches.
extern "C" int ssd_scan_launch(int device, int dtype, const void* x,
                               const void* Bm, const void* Cm,
                               const void* log_a, const void* h0, void* y,
                               void* h_out, void* st, void* dec, int B,
                               int S, int H, int P, int N, int hb, int pb,
                               void* stream) {
  using namespace repro_torch;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P % 16 != 0 || N % 8 != 0 || N <= 0 || N > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* h_in = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h_out);
  if (dtype == kFloat32)
    return fp32::launch(x, Bm, Cm, la, h_in, y, ho, B, S, H, P, N, st_);
  if (dtype == kBFloat16)
    return tc::launch(x, Bm, Cm, la, h_in, y, ho, static_cast<float*>(st),
                      static_cast<float*>(dec), B, S, H, P, N, hb, pb, st_);
  return (int)cudaErrorInvalidValue;
}
