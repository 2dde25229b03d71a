// Lane-blocked PFor pack / unpack for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   kernels/postings_pack/kernel.py::pack_pallas   (_pack_kernel)
//   kernels/postings_pack/kernel.py::unpack_pallas (_unpack_kernel)
// Format: per 128-lane block, bw = 32 - clz(max); 32 bit-planes x 4 words,
// bit t of word w of plane p is bit p of lane 32w+t; planes >= bw are 0.
//
// Bound: bytes. Pack reads 512 B and writes 516 B per block, unpack the
// reverse, so at 3.35 TB/s a block costs ~0.31 ns; the bit work must stay
// under that.
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
// unpack: one 128-thread CTA per block, the words staged through shared
// memory; thread t rebuilds lane t from bit t % 32 of word t / 32 of each
// live plane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackThreads = 256;                 // 8 warps, a block each
constexpr int kPackWarps = kPackThreads / 32;

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

// lane t holds value t of each chunk -> lane p holds plane p's word of it
__device__ __forceinline__ void transpose32x4(uint32_t (&x)[4], int lane) {
  transpose_stage<16, 0x0000ffffu>(x, lane & 16);
  transpose_stage<8, 0x00ff00ffu>(x, lane & 8);
  transpose_stage<4, 0x0f0f0f0fu>(x, lane & 4);
  transpose_stage<2, 0x33333333u>(x, lane & 2);
  transpose_stage<1, 0x55555555u>(x, lane & 1);
}

__device__ __forceinline__ void load_block(const uint32_t* __restrict__ d,
                                           long long b, int lane,
                                           uint32_t (&x)[4]) {
  const uint32_t* p = d + b * kBlock + lane;
#pragma unroll
  for (int w = 0; w < 4; ++w) x[w] = __ldcs(p + 32 * w);
}

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const uint32_t* __restrict__ deltas, uint4* __restrict__ packed,
            int32_t* __restrict__ bw_out, long long nb) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kPackWarps;
  long long b = static_cast<long long>(blockIdx.x) * kPackWarps
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

__global__ void unpack_kernel(const uint32_t* __restrict__ packed,
                              const int32_t* __restrict__ bw,
                              uint32_t* __restrict__ out) {
  __shared__ uint32_t words[kBlock];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  words[t] = packed[b * kBlock + t];
  __syncthreads();
  const int w = t >> 5, j = t & 31;
  const int nbits = bw[b];
  uint32_t v = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    // p <= 31, so the shift never forms 1u << 32
    if (p < nbits) v |= ((words[p * 4 + w] >> j) & 1u) << p;
  }
  out[b * kBlock + t] = v;
}

}  // namespace

extern "C" {

// deltas (nb, 128) u32 -> packed (nb, 32, 4) u32, bw (nb,) i32
int pp_pack(const void* deltas, void* packed, void* bw, long long nb,
            void* stream) {
  if (nb > 0) {
    // grid: as many CTAs as stay resident, or fewer for a short stream
    static int resident = 0;
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pack_kernel, kPackThreads, 0);
      if (e != cudaSuccess || sms * per_sm == 0)
        return static_cast<int>(e != cudaSuccess ? e
                                                 : cudaErrorInvalidValue);
      resident = sms * per_sm;
    }
    const long long need = (nb + kPackWarps - 1) / kPackWarps;
    const long long grid = need < resident ? need : resident;
    pack_kernel<<<static_cast<unsigned>(grid), kPackThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(deltas), static_cast<uint4*>(packed),
        static_cast<int32_t*>(bw), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed (nb, 32, 4) u32, bw (nb,) i32 -> out (nb, 128) u32
int pp_unpack(const void* packed, const void* bw, void* out, long long nb,
              void* stream) {
  if (nb > 0) {
    unpack_kernel<<<static_cast<unsigned>(nb), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const int32_t*>(bw), static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
