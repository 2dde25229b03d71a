// Flash attention (forward) for Hopper (sm_90a), f32 SIMT: the route of
// f32 inputs, and of bf16 ones whose head dim the tensor-core kernel
// (flash_attention_tc.cu) does not take (kernels/flash_attention/ops.py::
// route: D not a multiple of 16 in [64, 256], as the SMOKE configs' 8 and
// 16). f32 is held to 2e-5, which bf16 tensor-core products cannot meet.
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
// pipes' 67 TFLOP/s are the peak there is: at gemma2-9b's prefill shapes
// (B = 4, S = 8192, D = 256) a global layer needs ~33 ms at that peak.
//
// Design: one 256-thread CTA per (batch x query head, 64-row q tile). The
// Pallas grid's sequential kv axis becomes a loop over 64-row kv tiles in
// the CTA, with the running max m, sum l and the (64, D) accumulator in
// registers; tiles wholly outside the causal / window band are skipped
// (exact: such a tile leaves m, l and acc unchanged). Q and K are staged
// transposed in shared memory (d-major, 68-float rows keep float4
// alignment), V row-major, all as f32 whatever the input dtype, so the
// inner loops read float4s: per d, a thread takes 4 q rows and 4 k
// columns (a 4x4 score tile, explicit fmaf); per kv row, 4 weights and
// D/16 columns of v. A row's 16 score columns live in 16 lanes of one
// half-warp, so its max and sum are four xor shuffles. At D = 256 the
// tiles take 222,208 bytes of shared memory (one CTA per SM), hence the
// opt-in above 48 KB. The heaviest q tiles of a causal head are launched
// first.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // q rows per CTA
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 256; // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr int kPad = 68;      // row stride of the transposed tiles
constexpr float kNeg = -0.7f * 3.402823466e38f;

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

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

// rows [row0, row0 + 64) of one head of a (B, S, NH, D) tensor into
// smem: transposed (dst[d * kPad + r]) or row-major (dst[r * D + d]);
// rows at or past S are zero
template <typename T, bool kTransposed>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* __restrict__ dst,
                                          long long b, int row0, int S,
                                          int NH, int head, int D) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < 64 * chunks; idx += kThreads) {
    // transposed: a warp takes 32 consecutive rows of one 8-wide chunk,
    // so its smem stores hit 32 banks; row-major: consecutive chunks
    const int r = kTransposed ? idx % 64 : idx / chunks;
    const int c = kTransposed ? idx / 64 : idx % chunks;
    float x[8];
    if (row0 + r < S) {
      load8(src + ((b * S + row0 + r) * NH + head) * D + c * 8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    if (kTransposed) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(c * 8 + e) * kPad + r] = x[e];
    } else {
      float* row = dst + r * D + c * 8;
      *reinterpret_cast<float4*>(row) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// kNJ: float4 column groups per thread (D <= 64 * kNJ)
template <typename T, int kNJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Skv, int H, int KVH, int D, int causal, int window,
                 float softcap, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                 // (D, kPad)
  float* Kt = Qt + D * kPad;        // (D, kPad)
  float* Vs = Kt + D * kPad;        // (kBK, D)
  float* Pt = Vs + kBK * D;         // (kBK, kPad): weights, k-major

  const int nq = gridDim.x;
  const int qi = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const long long b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = qi * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, true>(q, Qt, b, q0, Sq, H, h, D);

  // the kv tiles that hold a live pair for some row of this q tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + kBQ, Sq));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_lo = kv_begin / kBK;
  const int kt_hi = (kv_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][4 * kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    load_tile<T, true>(k, Kt, b, k0, Skv, KVH, kvh, D);
    load_tile<T, false>(v, Vs, b, k0, Skv, KVH, kvh, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kPad + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kPad + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float row_max = kNeg;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = x;
        ok[j] = qp < Sq && kp < Skv && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        row_max = fmaxf(row_max, ok[j] ? x : kNeg);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max,
                        __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kPad + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(Pt + kk * kPad + ty * 4);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int g = 0; g < kNJ; ++g) {
        const int col = g * 64 + tx * 4;
        if (col < D) {
          const float4 x = *reinterpret_cast<const float4*>(Vs + kk * D + col);
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][g * 4 + e] = fmaf(wv[i], xv[e], acc[i][g * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kNJ; ++g) {
      const int col = g * 64 + tx * 4;
      if (col < D) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[i][g * 4 + e] / denom;
        store4(out + ((b * Sq + qp) * H + h) * D + col, o);
      }
    }
  }
}

template <typename T, int kNJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KVH, int D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * D * kPad + kBK * D + kBK * kPad);
  auto kern = flash_fwd_kernel<T, kNJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KVH, D,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Skv, int H, int KVH, int D, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 1>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window,
                        softcap, scale, stream);
  if (D <= 128)
    return launch<T, 2>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window,
                        softcap, scale, stream);
  return launch<T, 4>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window,
                      softcap, scale, stream);
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, KVH, D), out like q; contiguous, 16-byte
// aligned, f32 (is_bf16 = 0) or bf16 (1); D a multiple of 8, <= 256;
// H a multiple of KVH; B * H <= 65535. The caller checks all of it.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int KVH, int D,
                                   int causal, int window, float softcap,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KVH, D,
                                   causal, window, softcap, scale, s);
  return dispatch<float>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal,
                         window, softcap, scale, s);
}
