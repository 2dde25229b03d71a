// Flash attention (forward) for Hopper (sm_90a), f32 SIMT: the route of
// f32 inputs, and of bf16 ones whose head dim the tensor-core kernel
// (flash_attention_tc.cu) does not take (kernels/flash_attention/ops.py::
// route: D not a multiple of 16 in [64, 256], as the SMOKE configs' 8 and
// 16). f32 is held to 2e-5, which bf16 tensor-core products cannot meet,
// so both products are full f32 FFMA (no TF32).
//
// Replaces the JAX package's Pallas kernel
//   kernels/flash_attention/kernel.py::flash_attention (_fa_kernel)
// Function: out = softmax(mask(softcap(scale * q k^T))) v per head, with
// GQA (query head h reads kv head h / G, G = H / KVH), a causal mask, a
// sliding window (attend iff q - k < window when window > 0), a logit
// softcap (softcap * tanh(s / softcap) when softcap != 0) and the ragged
// tails masked. Scores, weights and the p.v sums are f32; masked weights
// are exactly 0, the running max starts at -0.7 * FLT_MAX, a row with
// nothing to attend comes out as 0, and the output is in q's dtype.
//
// Bound: operations, 4 D flops per live (q, k) pair. In f32 the SIMT
// pipes' 67 TFLOP/s are the peak there is: at gemma2-9b's f32 check
// shapes (B = 1, S = 4500, D = 256, 16 query heads) a global layer needs
// 2.5 ms at that peak. An SM issues 128 FFMA a cycle and reads 128 bytes
// of shared memory a cycle, so a thread must do 16 FFMA per 16-byte
// shared load (each float it loads serves 4 FFMA), or shared memory, not
// the FFMA pipe, sets the pace.
//
// Design, against that (tools/flash_probe.py splits the time by phase):
// - Work items of (batch x head, 64-row q tile), heaviest causal tiles
//   first, pulled by a persistent grid of one 256-thread CTA per SM from
//   an atomic counter (zeroed by the caller): the causal triangle's
//   unequal items leave no tail of a few long CTAs.
// - kv tiles of 256 rows. Warp w owns q rows 8w..8w+7 and lane t the
//   tile's kv columns t + 32j (j < 8): an 8 x 8 register tile of scores
//   per thread, so per 4 d a thread loads 8 q and 8 k float4s for 256
//   FFMA. For p.v it owns the same 8 rows and output columns 4t..4t+3
//   (and 128 + 4t.. at D > 128): per kv row, 2 float4s of weights and
//   2 of v for 64 FFMA. The running max m, sum l and the (8, D) slice of
//   the accumulator stay in registers, the rows' max and sum are warp
//   xor-shuffles.
// - The copies run off the critical path and off the compute threads: k
//   and v stream through a 3-stage ring of 32 KB chunks by TMA (thread 0
//   issues one box a chunk through per-call tensor maps, an mbarrier a
//   stage signals it landed), in the order the math takes them: k in
//   d-slices (256 rows x 32 d) for q.k^T, then v in row slices (32 rows x
//   D) for p.v. Chunk c + 2 is issued while chunk c is in use; one block
//   barrier a chunk frees a stage. (cp.async by every thread cost 11-16%
//   of the time in issue stalls, tools/flash_probe.py.) Shared memory: q
//   (64 x D) + the weights (256 x 64) + the ring = 224 KB at D = 256, one
//   CTA per SM, hence the opt-in above 48 KB.
// - No bank conflicts: k rows are 128 B, loaded with TMA's 128-byte
//   swizzle (16-byte quad x of row r at x ^ r % 8), so the eight lanes of
//   a quarter-warp read eight rows on distinct banks; the weights are
//   stored k-major (rows of 64 q rows) with the same swizzle on their q
//   quads; q and v are read row-major (broadcast, and contiguous across
//   lanes) at a power-of-two pitch >= D.
// - Rows past S and columns past D arrive as 0 (TMA's fill), so padding d
//   changes no sum; tiles wholly outside the causal / window band are
//   never loaded (exact: such a tile leaves m, l and acc unchanged), and
//   the last tile loads only the v rows the band reaches.
// - bf16 inputs (D 8 / 16 on the route; any D when called by name) are
//   staged through registers by every thread and widened to f32 into the
//   same layouts, a synchronous copy at the same point of the pipeline.
// - The softmax keeps IEEE tanhf and expf (a cheaper tanh would spend part
//   of the 2e-5 budget); x / softcap is x * (1 / softcap), within an ulp
//   of the quotient. The mask runs only on tiles that cross the band's
//   edges or a ragged tail.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using namespace tma;

#ifdef FLASH_PROBE
// tools/flash_probe.py: thread 0 of each CTA adds the clock64() cycles
// since its previous mark to phase i (0 copy wait, 1 q.k^T, 2 softmax,
// 3 p.v, 4 copy issue, 5 the rest); [6] counts CTAs, [7] 64-row kv tiles
__device__ unsigned long long g_probe[8];
#define PROBE_BEGIN long long probe_t = clock64(), probe_c[6] = {};
#define PROBE_MARK(i)                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long n_ = clock64();                                  \
      probe_c[i] += n_ - probe_t;                                      \
      probe_t = n_;                                                    \
    }                                                                  \
  } while (0)
#define PROBE_TILES(n)                                                 \
  do {                                                                 \
    if (threadIdx.x == 0) atomicAdd(&g_probe[7], 0ull + (n));          \
  } while (0)
#define PROBE_END                                                      \
  if (threadIdx.x == 0) {                                              \
    for (int i_ = 0; i_ < 6; ++i_)                                     \
      atomicAdd(&g_probe[i_], 0ull + probe_c[i_]);                     \
    atomicAdd(&g_probe[6], 1ull);                                      \
  }
#else
#define PROBE_BEGIN
#define PROBE_MARK(i)
#define PROBE_TILES(n)
#define PROBE_END
#endif

constexpr int kBQ = 64;        // q rows per work item
constexpr int kBK = 256;       // kv rows per tile
constexpr int kDC = 32;        // d per k chunk; kv rows per v chunk
constexpr int kThreads = 256;  // 8 warps x 8 q rows
constexpr int kStages = 3;     // chunks in the ring
constexpr int kChunk = kBK * kDC;  // floats per stage (32 KB)
constexpr float kNeg = -0.7f * 3.402823466e38f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                         __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// 8 bf16 from global memory (zeros where !valid; src is then not read),
// widened to f32 into the shared-memory quads dst0 (values 0-3) and dst1
// (4-7)
__device__ __forceinline__ void put(float* dst0, float* dst1,
                                    const __nv_bfloat16* src, bool valid) {
  float x[8] = {};
  if (valid) load8(src, x);
  *reinterpret_cast<float4*>(dst0) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst1) = make_float4(x[4], x[5], x[6], x[7]);
}

// the shared-memory row pitch of q and v: a power of two >= max(D, 32),
// so a row's 16-byte pieces are found by shifts (a v stage holds 32 rows)
__host__ __device__ __forceinline__ int pitch(int D) {
  int p = kDC;
  while (p < D) p *= 2;
  return p;
}

// where a tensor (B, S, NH, D) keeps row r of head `head`
template <typename T>
__device__ __forceinline__ const T* row_ptr(const T* base, long long b,
                                            int r, int S, int NH, int head,
                                            int D) {
  return base + ((b * S + r) * NH + head) * static_cast<long long>(D);
}

// bf16 (the f32 route loads by TMA into the same layouts):
// rows [r0, r0 + n) of one head into shared memory at pitch Dv (a power
// of two >= D; 2^lg 16-byte pieces a row), zeros past S and at d >= D.
// Thread t copies piece t % 2^lg of rows t / 2^lg, + 256 / 2^lg, ...
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* __restrict__ src,
                                          float* dst, long long b, int r0,
                                          int n, int S, int NH, int head,
                                          int D, int Dv, int lg) {
  constexpr int kPer = 8;
  const int r = threadIdx.x >> lg;
  const int d = (threadIdx.x & ((1 << lg) - 1)) * kPer;
  const int step = kThreads >> lg;
  const long long pitch = static_cast<long long>(step) * NH * D;
  const __nv_bfloat16* from = row_ptr(src, b, r0 + r, S, NH, head, D) + d;
  float* to = dst + r * Dv + d;
  for (int i = r; i < n; i += step) {
    const bool ok = d < D && r0 + i < S;
    put(to, to + 4, ok ? from : src, ok);
    from += pitch;
    to += step * Dv;
  }
}

// bf16: k rows [k0, k0 + 256), d in [d0, d0 + 32) into a stage as TMA's
// 128-byte swizzle lays them out: row r's quad x (d0 + 4x..) at r * 32 +
// 4 (x ^ (r % 8)). Thread t copies piece t % P of rows t / P, + 256 / P,
// ... (P 16-byte pieces a row)
__device__ __forceinline__ void copy_k(const __nv_bfloat16* __restrict__ k,
                                       float* buf, long long b, int k0,
                                       int Skv, int KVH, int kvh, int D,
                                       int d0) {
  constexpr int kPer = 8;
  constexpr int kPieces = kDC / kPer;
  constexpr int kStep = kThreads / kPieces;
  const int r = threadIdx.x / kPieces;
  const int x = (threadIdx.x % kPieces) * (kPer / 4);
  const int d = d0 + 4 * x;
  const long long pitch = static_cast<long long>(kStep) * KVH * D;
  const __nv_bfloat16* from = row_ptr(k, b, k0 + r, Skv, KVH, kvh, D) + d;
  // (r + kStep i) % 8 == r % 8: one swizzle for all the thread's rows
  float* dst0 = buf + r * kDC + ((x ^ (r & 7)) << 2);
  float* dst1 = buf + r * kDC + (((x + 1) ^ (r & 7)) << 2);
#pragma unroll
  for (int i = 0; i < kBK / kStep; ++i) {
    const bool ok = d < D && k0 + r + kStep * i < Skv;
    put(dst0 + kStep * kDC * i, dst1 + kStep * kDC * i, ok ? from : k, ok);
    from += pitch;
  }
}

// s[i][j] += q[8w + i, d] * k[t + 32j, d] over one k chunk's 32 d
__device__ __forceinline__ void qk_chunk(const float* Qc, int Dv,
                                         const float* Kc, int w, int lane,
                                         float (&s)[8][8]) {
#pragma unroll 2
  for (int x = 0; x < kDC / 4; ++x) {
    float4 qf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qf[i] = *reinterpret_cast<const float4*>(Qc + (8 * w + i) * Dv + 4 * x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      const float4 kf = *reinterpret_cast<const float4*>(
          Kc + c * kDC + ((x ^ (lane & 7)) << 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][j] = fmaf(qf[i].x, kf.x, s[i][j]);
        s[i][j] = fmaf(qf[i].y, kf.y, s[i][j]);
        s[i][j] = fmaf(qf[i].z, kf.z, s[i][j]);
        s[i][j] = fmaf(qf[i].w, kf.w, s[i][j]);
      }
    }
  }
}

// acc[i][4n + e] += p[8w + i, kk] * v[kk, 128n + 4t + e] over one v
// chunk's 32 kv rows (tile rows 32 rs ..)
template <int kNC>
__device__ __forceinline__ void pv_chunk(const float* Pt, const float* Vc,
                                         int Dv, int rs, int w, int lane,
                                         float (&acc)[8][4 * kNC]) {
#pragma unroll 4
  for (int kk = 0; kk < kDC; ++kk) {
    const int kr = rs * kDC + kk;
    const float* prow = Pt + kr * kBQ;
    const float4 p0 = *reinterpret_cast<const float4*>(
        prow + (((2 * w) ^ (kr & 7)) << 2));
    const float4 p1 = *reinterpret_cast<const float4*>(
        prow + (((2 * w + 1) ^ (kr & 7)) << 2));
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int n = 0; n < kNC; ++n) {
      const float4 vf = *reinterpret_cast<const float4*>(
          Vc + kk * Dv + 128 * n + 4 * lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][4 * n] = fmaf(pv[i], vf.x, acc[i][4 * n]);
        acc[i][4 * n + 1] = fmaf(pv[i], vf.y, acc[i][4 * n + 1]);
        acc[i][4 * n + 2] = fmaf(pv[i], vf.z, acc[i][4 * n + 2]);
        acc[i][4 * n + 3] = fmaf(pv[i], vf.w, acc[i][4 * n + 3]);
      }
    }
  }
}

// a thread's rows q0w + i and columns k0l + 32 j, and the mask's terms
struct Band {
  int q0w, k0l, Sq, Skv, causal, window;
};

// the online softmax of one tile: s (scores) -> p (weights, 0 where
// masked), m, l and acc rescaled; kMasked = false where every pair of the
// tile is live
template <bool kMasked, int kNC>
__device__ __forceinline__ void softmax_tile(float (&s)[8][8], float (&m)[8],
                                             float (&l)[8],
                                             float (&acc)[8][4 * kNC],
                                             const Band& bd, float softcap,
                                             float inv_softcap, float scale) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = bd.q0w + i;
    float row_max = kNeg;
    bool ok[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kp = bd.k0l + 32 * j;
      float x = s[i][j] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x * inv_softcap);
      s[i][j] = x;
      ok[j] = !kMasked ||
              (qp < bd.Sq && kp < bd.Skv && (!bd.causal || kp <= qp) &&
               (bd.window <= 0 || qp - kp < bd.window));
      row_max = fmaxf(row_max, ok[j] ? x : kNeg);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    const float m_new = fmaxf(m[i], row_max);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
      row_sum += s[i][j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
    const float corr = expf(m[i] - m_new);
    l[i] = l[i] * corr + row_sum;
#pragma unroll
    for (int c = 0; c < 4 * kNC; ++c) acc[i][c] *= corr;
    m[i] = m_new;
  }
}

// kNC: float4 output columns per thread (D <= 128 * kNC)
template <typename T, int kNC>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 int* __restrict__ next_item, int BH, int Sq, int Skv, int H,
                 int KVH, int D, int causal, int window, float softcap,
                 float scale) {
  // f32 tiles arrive by TMA (thread 0 issues, mbarriers signal); bf16 ones
  // are widened through registers by every thread, behind the barriers
  constexpr bool kTma = sizeof(T) == 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_item;
  PROBE_BEGIN
  const int Dv = pitch(D);
  const int lg = __ffs(Dv / 8) - 1;  // log2(a bf16 row's 16-byte pieces)
  // 1024-byte aligned, as the 128-byte swizzle of the k stages needs
  float* Qs = reinterpret_cast<float*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  float* Pt = Qs + kBQ * Dv;                    // (256, 64): weights
  float* ring = Pt + kBK * kBQ;                 // kStages x kChunk
  // mbarriers: q's, then one per stage
  const uint32_t qbar = smem_u32(ring + kStages * kChunk);
  auto full = [&](int st) { return qbar + 8 + 8 * st; };
  if (kTma && threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the phases the next waits on q and on each stage complete
  uint32_t q_phase = 0, phases = 0;  // bit st: stage st
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int n_items = nq * BH;
  const int nd = (D + kDC - 1) / kDC;  // k chunks per tile
  const int cpt = nd + kBK / kDC;     // chunks per full tile
  const float inv_softcap = softcap != 0.f ? 1.f / softcap : 0.f;

  if (threadIdx.x == 0) s_item = atomicAdd(next_item, 1);
  __syncthreads();
  for (int item = s_item; item < n_items;) {
    const int qi = nq - 1 - item / BH;  // heaviest causal tiles first
    const int bh = item % BH;
    const long long b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KVH);
    const int q0 = qi * kBQ;
    // the kv rows that hold a live pair for some row of this q tile
    int kv_end = Skv;
    if (causal) kv_end = min(Skv, min(q0 + kBQ, Sq));
    const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
    const int len = max(kv_end - kv_begin, 0);
    const int nt = (len + kBK - 1) / kBK;
    const int n_chunks =
        nt == 0 ? 0
                : (nt - 1) * cpt + nd + (len - (nt - 1) * kBK + kDC - 1) / kDC;
    PROBE_TILES((len + 63) / 64);

    // the chunks of tile t: its k d-slices (r < nd), then its v row
    // slices; the producer's next one is chunk pr of tile pt, to stage ps
    // (f32: thread 0 issues, bf16: every thread copies)
    int pt = 0, pr = 0, ps = 0;
    auto issue = [&]() {
      const int k0 = kv_begin + pt * kBK;
      float* buf = ring + ps * kChunk;
      if constexpr (kTma) {
        if (pr < nd) {
          mbar_expect_tx(full(ps), kChunk * 4);
          tma_load_4d(smem_u32(buf), &tk, full(ps), pr * kDC, kvh, k0,
                      static_cast<int>(b));
        } else {
          mbar_expect_tx(full(ps), kDC * Dv * 4);
          tma_load_4d(smem_u32(buf), &tv, full(ps), 0, kvh,
                      k0 + (pr - nd) * kDC, static_cast<int>(b));
        }
      } else if (pr < nd) {
        copy_k(k, buf, b, k0, Skv, KVH, kvh, D, pr * kDC);
      } else {
        copy_rows(v, buf, b, k0 + (pr - nd) * kDC, kDC, Skv, KVH, kvh, D, Dv,
                  lg);
      }
      if (++pr == cpt) pr = 0, ++pt;
      if (++ps == kStages) ps = 0;
    };
    if (n_chunks > 0) {
      if constexpr (kTma) {
        if (threadIdx.x == 0) {
          mbar_expect_tx(qbar, kBQ * Dv * 4);
          tma_load_4d(smem_u32(Qs), &tq, qbar, 0, h, q0,
                      static_cast<int>(b));
          for (int c = 0; c < kStages - 1 && c < n_chunks; ++c) issue();
        }
        mbar_wait(qbar, q_phase);
        q_phase ^= 1;
      } else {
        copy_rows(q, Qs, b, q0, kBQ, Sq, H, h, D, Dv, lg);
        for (int c = 0; c < kStages - 1 && c < n_chunks; ++c) issue();
      }
    }

    float m[8], l[8], acc[8][4 * kNC], s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = kNeg;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * kNC; ++c) acc[i][c] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    PROBE_MARK(5);

    // the consumer's chunk c is chunk r of tile t, in stage cs
    for (int c = 0, t = 0, r = 0, cs = 0; c < n_chunks; ++c) {
      if constexpr (kTma) {
        mbar_wait(full(cs), (phases >> cs) & 1);  // chunk c has landed
        phases ^= 1u << cs;
      }
      __syncthreads();  // every thread is done with chunk c - 1's stage
      PROBE_MARK(0);
      if (c + kStages - 1 < n_chunks && (!kTma || threadIdx.x == 0)) issue();
      PROBE_MARK(4);
      const float* buf = ring + cs * kChunk;
      const int tile = t, part = r;
      if (++r == cpt) r = 0, ++t;
      if (++cs == kStages) cs = 0;
      if (part >= nd) {
        pv_chunk<kNC>(Pt, buf, Dv, part - nd, w, lane, acc);
        PROBE_MARK(3);
        continue;
      }
      qk_chunk(Qs + part * kDC, Dv, buf, w, lane, s);
      PROBE_MARK(1);
      if (part != nd - 1) continue;
      // the tile's scores are complete: online softmax, weights to Pt
      // (read after the next chunk's barrier); the mask only where the
      // tile crosses the band's edges or a ragged tail
      const int k0 = kv_begin + tile * kBK;
      const bool inside = q0 + kBQ <= Sq && k0 + kBK <= Skv &&
                          (!causal || k0 + kBK - 1 <= q0) &&
                          (window <= 0 || q0 + kBQ - 1 - k0 < window);
      const Band band{q0 + 8 * w, k0 + lane, Sq, Skv, causal, window};
      if (inside)
        softmax_tile<false, kNC>(s, m, l, acc, band, softcap, inv_softcap,
                                 scale);
      else
        softmax_tile<true, kNC>(s, m, l, acc, band, softcap, inv_softcap,
                                scale);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = lane + 32 * j;
        float* prow = Pt + kc * kBQ;
        *reinterpret_cast<float4*>(prow + (((2 * w) ^ (lane & 7)) << 2)) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(prow + (((2 * w + 1) ^ (lane & 7)) << 2)) =
            make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = 0.f;
      }
      PROBE_MARK(2);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qp = q0 + 8 * w + i;
      if (qp >= Sq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < kNC; ++n) {
        const int col = 128 * n + 4 * lane;
        if (col < D) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = acc[i][4 * n + e] / denom;
          store4(out + ((b * Sq + qp) * H + h) * static_cast<long long>(D)
                     + col, o);
        }
      }
    }
    __syncthreads();  // every thread is done with this item's buffers
    if (threadIdx.x == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();
    item = s_item;
    PROBE_MARK(5);
  }
  PROBE_END
}

template <typename T, int kNC>
int launch(const void* q, const void* k, const void* v, void* out,
           int* next_item, int B, int Sq, int Skv, int H, int KVH, int D,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int Dv = pitch(D);
  CUtensorMap tq{}, tk{}, tv{};
  if (sizeof(T) == 4 && Skv > 0) {
    // q: 64 rows x Dv columns; k: 256 rows x 32 columns, 128-byte swizzle;
    // v: 32 rows x Dv columns; columns past D and rows past S read as 0
    int rc = map_4d(&tq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, B, Sq, H, D,
                    Dv, kBQ, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc == 0)
      rc = map_4d(&tk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, B, Skv, KVH, D,
                  kDC, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = map_4d(&tv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, v, B, Skv, KVH, D,
                  Dv, kDC, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  // + 1024 bytes of alignment slack, + the 4 mbarriers
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ) * Dv + kBK * kBQ
                       + kStages * kChunk) + 1024 + 8 * (1 + kStages);
  auto kern = flash_fwd_kernel<T, kNC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms * per_sm == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long items =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * B * H;
  const long long grid = items < sms * per_sm ? items : sms * per_sm;
  kern<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), next_item, B * H, Sq,
      Skv, H, KVH, D, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int* next_item, int B, int Sq, int Skv, int H, int KVH, int D,
             int causal, int window, float softcap, float scale,
             cudaStream_t stream) {
  if (D <= 128)
    return launch<T, 1>(q, k, v, out, next_item, B, Sq, Skv, H, KVH, D,
                        causal, window, softcap, scale, stream);
  return launch<T, 2>(q, k, v, out, next_item, B, Sq, Skv, H, KVH, D,
                      causal, window, softcap, scale, stream);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, KVH, D), out like q; contiguous, 16-byte
// aligned, f32 (is_bf16 = 0) or bf16 (1); D a multiple of 8, <= 256;
// H a multiple of KVH; Sq >= 1; next_item one int32 set to 0 (the work
// counter). The caller checks all of it. Returns cudaGetLastError() after
// the launch, or tma::kNoEncode / kEncodeFailed + CUresult when a tensor
// map cannot be made.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* next_item,
                                   int B, int Sq, int Skv, int H, int KVH,
                                   int D, int causal, int window,
                                   float softcap, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counter = static_cast<int*>(next_item);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, counter, B, Sq, Skv, H,
                                   KVH, D, causal, window, softcap, scale, s);
  return dispatch<float>(q, k, v, out, counter, B, Sq, Skv, H, KVH, D,
                         causal, window, softcap, scale, s);
}

#ifdef FLASH_PROBE
// -> the 8 probe counters, then zeroes them
extern "C" int flash_probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, zero, sizeof(zero)));
}
#endif
