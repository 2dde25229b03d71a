// Shared by the kernels that give each 128-lane postings block one warp:
// postings_pack.cu (pack, unpack) and bm25_blockmax.cu (compact).
//
// A block's 128 values are 4 words of 32 lanes; its bit planes are 32
// planes of 4 words, bit t of word w of plane p being bit p of value
// 32w + t. transpose32x4 turns one form into the other across a warp.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace warp_block {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;

// one butterfly stage of the 32x32 bit transpose on four independent
// words: rows (lanes) t and t ^ S swap the S-bit groups that sit off the
// diagonal of their 2x2 block of S x S sub-matrices
template <int S, uint32_t M>
__device__ __forceinline__ void transpose_stage(uint32_t (&x)[4], bool hi) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t keep = hi ? (x[w] & ~M) : (x[w] & M);
    const uint32_t send = hi ? ((x[w] & M) << S) : ((x[w] & ~M) >> S);
    x[w] = keep | __shfl_xor_sync(kFull, send, S);
  }
}

// bit t of lane p's word w <-> bit p of lane t's word w, in five
// __shfl_xor_sync stages. Its own inverse: lane t holding value 32w + t
// in word w -> lane p holding plane p's word w, and back.
__device__ __forceinline__ void transpose32x4(uint32_t (&x)[4], int lane) {
  transpose_stage<16, 0x0000ffffu>(x, lane & 16);
  transpose_stage<8, 0x00ff00ffu>(x, lane & 8);
  transpose_stage<4, 0x0f0f0f0fu>(x, lane & 4);
  transpose_stage<2, 0x33333333u>(x, lane & 2);
  transpose_stage<1, 0x55555555u>(x, lane & 1);
}

// CTAs of `threads` threads (a block per warp) to launch for n blocks:
// as many as stay resident on the card (counted once, into *resident),
// or fewer for a short stream; the kernel's grid-stride loop takes the
// rest.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, long long n, int* resident,
                     unsigned* grid) {
  if (*resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (e != cudaSuccess) return e;
    if (sms * per_sm == 0) return cudaErrorInvalidValue;
    *resident = sms * per_sm;
  }
  const int warps = threads / 32;
  const long long need = (n + warps - 1) / warps;
  *grid = static_cast<unsigned>(need < *resident ? need : *resident);
  return cudaSuccess;
}

}  // namespace warp_block
