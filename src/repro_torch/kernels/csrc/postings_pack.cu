// Lane-blocked PFor pack / unpack for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   kernels/postings_pack/kernel.py::pack_pallas   (_pack_kernel)
//   kernels/postings_pack/kernel.py::unpack_pallas (_unpack_kernel)
// Format: per 128-lane block, bw = 32 - clz(max); 32 bit-planes x 4 words,
// bit t of word w of plane p is bit p of lane 32w+t; planes >= bw are 0.
//
// Bound: bytes. Pack reads 512 B and writes 516 B per block, so at 3.35
// TB/s a block costs ~0.31 ns; unpack reads 16 B per live plane and 4 B
// of bw and writes 512 B. The bit work must stay under that.
//
// pack: one warp per block, a grid sized to the SMs (occupancy x SM
// count) and a grid-stride loop over the blocks. Lane t loads values t,
// 32+t, 64+t and 96+t (four coalesced 128-byte loads), and loads the next
// block's four values before it transposes this one, so each warp keeps
// two blocks (1 KB) in flight: 64 KB per SM at full occupancy. Chunk w
// (one value per lane) is a 32x32 bit matrix, row t in lane t; five
// __shfl_xor_sync butterfly stages (strides 16, 8, 4, 2, 1: each lane
// keeps its half of the pair's 2s-bit groups and swaps the other half
// with lane ^ s) transpose it, so that lane p ends up holding bit p of
// all 32 values: plane p's word w. A stage is one shuffle and a few masks
// and shifts, against 32 ballots and 32 selects a word. Planes >= bw
// come out 0 with no mask: no value has a bit there. Lane p stores
// plane p's four words as one 16-byte store, so the warp writes its 512
// bytes in one coalesced store; bw is a warp __reduce_max_sync. No
// shared memory, no block barrier; the ragged tail is the loop's bound.
//
// unpack: pack run backwards, on the same grid. Lane p loads plane p's
// four words as one 16-byte load, and only if p < bw: the kernel reads
// the live planes alone (the bytes the bound counts) and a dead plane
// holding garbage unpacks as zero, as the TPU kernel's mask makes it.
// The same five-stage transpose (its own inverse) leaves value 32w + t
// in lane t's word w, and the warp stores its 512 bytes as four
// coalesced 128-byte stores. Each warp loads the next block's planes
// before it transposes this one, and that block's bw one block earlier
// still, so a plane load never waits on its bw. No shared memory, no
// block barrier. The loads need a 16-byte aligned packed array; the
// wrapper checks it.
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_block.cuh"

namespace {

using warp_block::kBlock;
using warp_block::kFull;
using warp_block::transpose32x4;
constexpr int kThreads = 256;                 // 8 warps, a block each
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load_block(const uint32_t* __restrict__ d,
                                           long long b, int lane,
                                           uint32_t (&x)[4]) {
  const uint32_t* p = d + b * kBlock + lane;
#pragma unroll
  for (int w = 0; w < 4; ++w) x[w] = __ldcs(p + 32 * w);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ deltas, uint4* __restrict__ packed,
            int32_t* __restrict__ bw_out, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long b = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  uint32_t cur[4] = {0u, 0u, 0u, 0u}, nxt[4] = {0u, 0u, 0u, 0u};
  if (b < nb) load_block(deltas, b, lane, cur);
  for (; b < nb; b += stride) {  // b is uniform over the warp
    if (b + stride < nb) load_block(deltas, b + stride, lane, nxt);
    const uint32_t m = __reduce_max_sync(
        kFull, max(max(cur[0], cur[1]), max(cur[2], cur[3])));
    transpose32x4(cur, lane);
    __stcs(packed + b * 32 + lane,
           make_uint4(cur[0], cur[1], cur[2], cur[3]));
    if (lane == 0) bw_out[b] = 32 - __clz(static_cast<int>(m));
#pragma unroll
    for (int w = 0; w < 4; ++w) cur[w] = nxt[w];
  }
}

// lane p: plane p's four words of block b if the plane is live, else 0
__device__ __forceinline__ void load_planes(const uint4* __restrict__ packed,
                                            long long b, int32_t bw,
                                            int lane, uint32_t (&x)[4]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (lane < bw) v = __ldcs(packed + b * 32 + lane);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint4* __restrict__ packed,
              const int32_t* __restrict__ bw, uint32_t* __restrict__ out,
              long long nb) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long b = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  uint32_t cur[4] = {0u, 0u, 0u, 0u}, nxt[4] = {0u, 0u, 0u, 0u};
  int32_t bw_nxt = 0;  // bw of block b + stride
  if (b < nb) {
    load_planes(packed, b, bw[b], lane, cur);
    if (b + stride < nb) bw_nxt = bw[b + stride];
  }
  for (; b < nb; b += stride) {  // b is uniform over the warp
    const long long b1 = b + stride;
    if (b1 < nb) {
      load_planes(packed, b1, bw_nxt, lane, nxt);
      if (b1 + stride < nb) bw_nxt = bw[b1 + stride];
    }
    transpose32x4(cur, lane);
    uint32_t* o = out + b * kBlock + lane;
#pragma unroll
    for (int w = 0; w < 4; ++w) __stcs(o + 32 * w, cur[w]);
#pragma unroll
    for (int w = 0; w < 4; ++w) cur[w] = nxt[w];
  }
}

}  // namespace

extern "C" {

// deltas (nb, 128) u32 -> packed (nb, 32, 4) u32, bw (nb,) i32
int pp_pack(const void* deltas, void* packed, void* bw, long long nb,
            void* stream) {
  if (nb > 0) {
    static int resident = 0;
    unsigned grid = 0;
    const cudaError_t e = warp_block::grid_for(pack_kernel, kThreads, nb,
                                               &resident, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(deltas), static_cast<uint4*>(packed),
        static_cast<int32_t*>(bw), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed (nb, 32, 4) u32, 16-byte aligned, bw (nb,) i32 -> out (nb, 128)
// u32
int pp_unpack(const void* packed, const void* bw, void* out, long long nb,
              void* stream) {
  if (nb > 0) {
    static int resident = 0;
    unsigned grid = 0;
    const cudaError_t e = warp_block::grid_for(unpack_kernel, kThreads, nb,
                                               &resident, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(packed), static_cast<const int32_t*>(bw),
        static_cast<uint32_t*>(out), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
