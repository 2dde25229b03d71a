// Flash attention (forward) for Hopper (sm_90a) on the bf16 tensor cores:
// wgmma for both products, TMA loads through mbarrier rings.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py:74 flash_attention
//   (its body _fa_kernel, kernel.py:25)
// for bf16 inputs whose head dim D is a multiple of 16 in [64, 256]
// (kernels/flash_attention/ops.py::route; f32 inputs and other D run the
// SIMT kernel of flash_attention.cu). Function: out = softmax(mask(
// softcap(scale * q k^T))) v per head, GQA (query head h reads kv head
// h / G), a causal mask, a sliding window (attend iff q - k < window when
// window > 0), a logit softcap (softcap * tanh(s / softcap)), ragged
// tails masked; the running max starts at -0.7 * FLT_MAX, a row with
// nothing to attend comes out as 0, the output is bf16.
//
// Bound: operations. 4 D flops per live (q, k) pair per head (q k^T and
// p v), at the card's 989 TFLOP/s bf16 dense peak: at the LM path's
// shapes (gemma2-9b prefill, B = 4, S = 8192, D = 256, 16 query heads)
// 2.2 ms for a global layer and 1.7 ms for a local one (window 4096),
// against 0.24 ms to move q, k, v and out once at 3.35 TB/s.
//
// Design, against that bound:
// - One CTA per (batch x query head, 128-row q tile), the heaviest causal
//   tiles first; two warpgroups take 64 q rows each. There is no producer
//   warpgroup: with a third one a thread may hold at most 168 registers
//   at launch, and setmaxnreg's 240 for the two that compute still
//   spilled the D = 256 accumulators (ptxas, CUDA 12.9), while 256
//   threads get 255 and no spill. One thread of each warpgroup issues
//   TMA loads instead (k from warpgroup 0, v from warpgroup 1), at the
//   top of each iteration, when no wgmma is in flight.
// - TMA reads q, k and v where they lie, through 4-D tensor maps over
//   (B, S, heads, D) with their real strides (made per call on the host),
//   as 64-column boxes (128 bytes) with the 128-byte swizzle: D = 256 is
//   four boxes a row. Shared memory holds the q tile, a 3-stage ring of k
//   tiles and a 2-stage ring of v tiles (64 kv rows each at D > 128, 128
//   below), each stage with a full and an empty mbarrier: at D = 256, 64
//   + 3 x 32 + 2 x 32 KB. Iteration j loads k_{j+1} and v_j into stages
//   both warpgroups had released well before. Rows past S and columns
//   past D arrive as 0; the mask still removes the rows (a zero k row
//   scores 0, not -inf).
// - S = q k^T: wgmma m64nBNk16, both operands from shared memory through
//   128B-swizzled K-major descriptors (D / 16 k-steps), f32 accumulators.
// - O += P V: P is rounded to bf16 in registers, where the accumulator's
//   layout is already the A operand's (wgmma m64nDk16, A from registers);
//   V is d-contiguous, so it is the B operand in its MN-major
//   (transposed) form. O stays in registers: 64 x D f32 per warpgroup.
// - Overlap inside a warpgroup: iteration j issues q k_j^T and then
//   p_{j-1} v_{j-1} (two wgmma groups), waits for the first only, and
//   runs tile j's softmax while the second is on the tensor cores. The
//   first and last products are peeled off the loop, so no branch stands
//   between a wgmma and its wait (ptxas serialises the wgmmas otherwise).
// - Overlap across warpgroups (ping-pong): two named barriers make the
//   warpgroups take turns issuing their products, so one's softmax runs
//   under the other's. Each of these steps, and v loads issued by the
//   warpgroup that runs behind, was kept because it made the LM path's
//   layers faster on the card.
// - Softmax in registers, in log2 units: y = s * scale * log2(e), or with
//   a softcap y = softcap * log2(e) * tanh(s * scale / softcap), tanh
//   written as 1 - 2 / (1 + 2^(2u log2 e)) on ex2 and rcp (tanh.approx's
//   2^-11 relative error, times the softcap of 50, would show in the
//   logits). The mask runs only on tiles that cross the diagonal, the
//   window's edge or the ragged tail. Tiles a warpgroup cannot see are
//   computed and masked to p = 0 (m, l and o stay as they are); a branch
//   around them would serialise the wgmmas. Each thread's share of the
//   row sum is reduced across its quad once, at the end.
// - P in bf16 departs from the Pallas kernel, which keeps p in f32; the
//   JAX model's own blockwise attention rounds p to v's dtype before p v
//   (src/repro/models/transformer.py:241). Held within 2e-2 of the plain
//   version (kernels/flash_attention/ref.py), as every bf16 flash output.
// - Finalisation: O / max(l, 1e-30), rounded to bf16, stored from the
//   accumulators' registers.
// Not yet done (later work): a cheaper softcap (three MUFU operations an
// element; tanh.approx would take one fewer, at the cost above), wider kv
// tiles (the 227 KB of shared memory hold five 64-row tiles beside q
// at D = 256), and a TMA store of the output.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int kBM = 128;          // q rows per CTA, 64 per warpgroup
constexpr int kThreads = 256;     // two warpgroups
constexpr int kKStages = 3;       // k ring depth
constexpr int kVStages = 2;       // v ring depth
constexpr float kNeg = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// after a wgmma wait: the compiler may neither read an accumulator
// before it nor reuse an A operand's registers (read by the tensor cores
// until then) for anything else
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma m64nNk16, bf16 x bf16 -> f32. ss: A and B from shared memory
// (K-major descriptors), D = A B (acc = 0) or D += A B; rs: A from
// registers, B MN-major (transposed) from shared memory, D += A B.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma_s(float (&d)[kBN / 2], uint64_t a,
                                        uint64_t b, int acc) {
  if constexpr (kBN == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

template <int kDP>
__device__ __forceinline__ void wgmma_o(float (&d)[kDP / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kDP == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (kDP == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (kDP == 192) wgmma_rs_n192(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// tile j's softmax on this thread's scores sc (2 rows x kBN / 4 columns):
// scores to log2 units y (softcap via tanh on ex2 and rcp), the mask on
// tiles that cross the diagonal, the window's edge or the ragged tail,
// the running max m, the correction corr = 2^(m_old - m_new) (l is
// rescaled here, o by the caller), then sc = 2^(y - m) and l += its sum
template <int kBN>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    const int (&row)[2], int qa, int k0, int lane, int Skv, int causal,
    int window, bool soft, float ys, float ue, float yc) {
  const bool edge = k0 + kBN > Skv || (causal && k0 + kBN - 1 > qa) ||
                    (window > 0 && qa + 63 - k0 >= window);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    float y;
    if (soft) {
      const float e = ex2(sc[i] * ue);
      y = yc * (1.f - 2.f * rcp(1.f + e));
    } else {
      y = sc[i] * ys;
    }
    if (edge) {
      const int qp = row[(i / 2) % 2];
      const int kp = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const bool ok = kp < Skv && (!causal || kp <= qp) &&
                      (window <= 0 || qp - kp < window);
      y = ok ? y : -INFINITY;
    }
    sc[i] = y;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], y);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const float pv = ex2(sc[i] - m[(i / 2) % 2]);
    l[(i / 2) % 2] += pv;
    sc[i] = pv;
  }
}

// p (bf16, the A operand of p v) from the weights in sc
template <int kBN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBN / 16][4],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// shared memory of one CTA, in bytes from a 1024-aligned base: q (kBM x
// kDP), then kKStages k tiles and kVStages v tiles (kBN x kDP each), each
// a run of 64-column chunks of rows x 128 bytes (one TMA box each); then
// the barriers. At D = 256: 64 + 3 x 32 + 2 x 32 KB.
template <int kDP, int kBN>
struct Layout {
  static constexpr int kChunks = kDP / 64;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kTile = kBN * kDP * 2;   // one k or v tile
  static constexpr uint32_t kQBytes = kBM * kDP * 2;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kKStages * kTile;
  static constexpr uint32_t kBar = kV + kVStages * kTile;
  static constexpr uint32_t kBytes = kBar + 128 + 1024;  // + align slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may opt into");
};

template <int kDP, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                int KVH, int D, int causal, int window, float softcap,
                float scale) {
  using L = Layout<kDP, kBN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  // barriers: q full; per k stage full and empty; per v stage the same
  const uint32_t qfull = base + L::kBar;
  auto kfull = [&](int s) { return qfull + 8 + 8 * s; };
  auto kempty = [&](int s) { return qfull + 8 + 8 * (kKStages + s); };
  auto vfull = [&](int s) { return qfull + 8 + 8 * (2 * kKStages + s); };
  auto vempty = [&](int s) {
    return qfull + 8 + 8 * (2 * kKStages + kVStages + s);
  };

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int q0 = qi * kBM;
  // the kv tiles that hold a live pair for some row of this q tile
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + kBM, Sq));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int kt_lo = kv_begin / kBN;
  const int n_tiles = max(0, (kv_end + kBN - 1) / kBN - kt_lo);

  // k tile t (0-based in this CTA's walk) lies in stage t % kKStages, v
  // tile t in t % kVStages. Thread 0 loads q and the k tiles, thread 128
  // (warpgroup 1) the v tiles; a stage is refilled once all 8 warps have
  // released the tile in it (one arrival each on its empty barrier)
  auto load_k = [&](int t) {
    const int s = t % kKStages;
    mbar_wait(kempty(s), ((t / kKStages) & 1) ^ 1);
    mbar_expect_tx(kfull(s), L::kTile);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sK + s * L::kTile + c * kBN * 128, &tk, kfull(s), c * 64,
                  kvh, (kt_lo + t) * kBN, b);
  };
  auto load_v = [&](int t) {
    const int s = t % kVStages;
    mbar_wait(vempty(s), ((t / kVStages) & 1) ^ 1);
    mbar_expect_tx(vfull(s), L::kTile);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sV + s * L::kTile + c * kBN * 128, &tv, vfull(s), c * 64,
                  kvh, (kt_lo + t) * kBN, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kempty(s), 8);  // one arrival per warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(qfull, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(sQ + c * kBM * 128, &tq, qfull, c * 64, h, q0, b);
    load_k(0);
  }

  {
    // the warpgroup (broadcast from lane 0: warp-uniform to the compiler)
    const int wg = __shfl_sync(0xffffffffu,
                               static_cast<int>(threadIdx.x) / 128, 0);
    const int lane = threadIdx.x % 32;
    // this thread's rows of the warpgroup's 64 (the accumulator layout):
    // r0 and r0 + 8; its columns of each 8-wide block: 2 (lane % 4) + {0, 1}
    const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int qa = q0 + wg * 64;          // the warpgroup's first q row
    const int row[2] = {qa + r0, qa + r0 + 8};
    const bool soft = softcap != 0.f;
    // with a softcap, u = s * scale / softcap, 2^(s * ue) = e^(2u) and
    // y = yc * tanh(u); without one, y = s * ys
    const float ys = scale * kLog2e;
    const float ue = soft ? 2.f * kLog2e * scale / softcap : 0.f;
    const float yc = softcap * kLog2e;

    float o[kDP / 2];
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

    // Iteration j issues q k_j^T, then p_{j-1} v_{j-1} behind it, as two
    // wgmma groups, and runs tile j's softmax while the second is on the
    // tensor cores; then rescales o and packs p_j for iteration j + 1. The
    // first and last products are peeled off, so no branch stands between
    // a wgmma and its wait (ptxas serialises them otherwise). Tiles this
    // warpgroup cannot see (its rows above the diagonal or behind the
    // window) are computed all the same and masked to p = 0, which leaves
    // m, l and o as they are.
    float sc[kBN / 2];
    uint32_t p[kBN / 16][4];
    // at the top of iteration j, while nothing is in flight: thread 0
    // loads k_{j+1} (into k_{j-2}'s stage) and thread 128 v_j (into
    // v_{j-2}'s). Warpgroup 1 runs about half an iteration behind
    // warpgroup 0 (ping-pong, below), so each waits only for releases the
    // other made well before: warpgroup 1 released k_{j-2} in its
    // iteration j - 2, warpgroup 0 v_{j-2} at the end of its j - 1
    auto loads = [&](int j) {
      if (threadIdx.x == 0 && j + 1 < n_tiles) load_k(j + 1);
      if (threadIdx.x == 128) load_v(j);
      __syncwarp();  // converged again before the next .aligned op
    };
    auto issue_s = [&](int j) {
      const int sk = j % kKStages;
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns, in the chunk
        const uint64_t a = sw128_desc(
            sQ + (kk / 4) * kBM * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t bk = sw128_desc(
            sK + sk * L::kTile + (kk / 4) * kBN * 128 + off, 16, 1024);
        wgmma_s<kBN>(sc, a, bk, kk > 0);
      }
    };
    auto issue_pv = [&](int j) {  // p_j v_j
      const int sv = j % kVStages;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t bv = sw128_desc(sV + sv * L::kTile + kk * 16 * 128,
                                       kBN * 128, 1024);
        wgmma_o<kDP>(o, p[kk], bv);
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float corr[2];
    // ping-pong: warpgroup w issues its products after bar.sync 1 + w and
    // lets the other go with bar.arrive 2 - w (warpgroup 0 goes first), so
    // one warpgroup's softmax runs while the other's products do; the
    // last product of warpgroup 1 passes to nobody
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
    };
    if (n_tiles > 0 && wg == 1) turn_pass();
    if (n_tiles > 0) {
      loads(0);
      mbar_wait(qfull, 0);
      mbar_wait(kfull(0), 0);
      turn_wait();
      wg_fence();
      issue_s(0);
      wg_commit();
      turn_pass();
      wg_wait<0>();
      pin(sc);
      release(kempty(0));
      softmax_tile<kBN>(sc, m, l, corr, row, qa, kt_lo * kBN, lane, Skv,
                        causal, window, soft, ys, ue, yc);
      pack_p<kBN>(p, sc);
    }
    for (int j = 1; j < n_tiles; ++j) {
      loads(j);
      const int sk = j % kKStages, sv = (j - 1) % kVStages;
      mbar_wait(kfull(sk), (j / kKStages) & 1);
      mbar_wait(vfull(sv), ((j - 1) / kVStages) & 1);
      turn_wait();
      wg_fence();
      issue_s(j);
      wg_commit();
      wg_fence();
      issue_pv(j - 1);
      wg_commit();
      turn_pass();
      wg_wait<1>();  // q k_j^T done; p_{j-1} v_{j-1} runs on
      pin(sc);
      release(kempty(sk));
      softmax_tile<kBN>(sc, m, l, corr, row, qa, (kt_lo + j) * kBN, lane,
                        Skv, causal, window, soft, ys, ue, yc);
      wg_wait<0>();  // p_{j-1} v_{j-1} done: o and p may change
      pin(o);
      pin(p);
      release(vempty(sv));
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) o[i] *= corr[(i / 2) % 2];
      pack_p<kBN>(p, sc);
    }
    if (n_tiles > 0) {
      const int j = n_tiles - 1;
      mbar_wait(vfull(j % kVStages), (j / kVStages) & 1);
      turn_wait();
      wg_fence();
      issue_pv(j);
      wg_commit();
      if (wg == 0) turn_pass();
      wg_wait<0>();
      pin(o);
    }

    // finalise: the quad's shares of l, then o / max(l, 1e-30) in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    const long long b64 = b;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
      __nv_bfloat16* dst = out + ((b64 * Sq + row[r]) * H + h) * D;
#pragma unroll
      for (int jb = 0; jb < kDP / 8; ++jb) {
        const int col = jb * 8 + (lane % 4) * 2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(
              o[4 * jb + 2 * r] / l[r], o[4 * jb + 2 * r + 1] / l[r]);
      }
    }
  }
}

// a (B, S, NH, D) bf16 tensor as a 4-D map (D, NH, S, B) with its real
// strides; boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle,
// zeros outside the tensor
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int NH, int D,
             int rows) {
  return tma::map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, B, S, NH,
                     D, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int kDP, int kBN>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KVH, int D, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, Sq, H, D, kBM);
  if (rc == 0) rc = make_map(&tk, k, B, Skv, KVH, D, kBN);
  if (rc == 0) rc = make_map(&tv, v, B, Skv, KVH, D, kBN);
  if (rc != 0) return rc;
  using L = Layout<kDP, kBN>;
  auto kern = flash_tc_kernel<kDP, kBN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBM - 1) / kBM, B * H);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KVH, D,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, KVH, D), out like q: contiguous bf16,
// 16-byte aligned; D a multiple of 16 in [64, 256]; H a multiple of KVH;
// B * H <= 65535; Sq >= 1. The caller checks all of it. Returns
// cudaGetLastError() after the launch, or kNoEncode / kEncodeFailed +
// CUresult when a tensor map cannot be made. With Skv = 0 no row has
// anything to attend: out is zeroed.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int KVH, int D,
                                      int causal, int window, float softcap,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Sq * H * D * 2, s));
  if (D <= 64)
    return launch<64, 128>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal,
                           window, softcap, scale, s);
  if (D <= 128)
    return launch<128, 128>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal,
                            window, softcap, scale, s);
  if (D <= 192)
    return launch<192, 64>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal,
                           window, softcap, scale, s);
  return launch<256, 64>(q, k, v, out, B, Sq, Skv, H, KVH, D, causal, window,
                         softcap, scale, s);
}
