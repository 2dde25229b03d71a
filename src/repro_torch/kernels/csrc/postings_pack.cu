// Lane-blocked PFor pack / unpack for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   kernels/postings_pack/kernel.py::pack_pallas   (_pack_kernel)
//   kernels/postings_pack/kernel.py::unpack_pallas (_unpack_kernel)
// Format: per 128-lane block, bw = 32 - clz(max); 32 bit-planes x 4 words,
// bit t of word w of plane p is bit p of lane 32w+t; planes >= bw are 0.
//
// Bound: bytes. Pack reads 512 B and writes 516 B per block, unpack the
// reverse; the bit work is a few dozen integer ops per lane. Design: one
// 128-thread CTA per block, one warp per 32 lanes. Plane p's word w is
// exactly __ballot_sync over warp w of bit p — the reference's bit layout
// with no shifting or summing — and the block max is a warp
// __reduce_max_sync plus four shared-memory slots. Consecutive threads
// touch consecutive words, so loads and stores coalesce.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void pack_kernel(const uint32_t* __restrict__ deltas,
                            uint32_t* __restrict__ packed,
                            int32_t* __restrict__ bw_out) {
  __shared__ uint32_t warp_max[4];
  const long long b = blockIdx.x;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const uint32_t x = deltas[b * kBlock + t];
  const uint32_t wm = __reduce_max_sync(0xffffffffu, x);
  if (lane == 0) warp_max[w] = wm;
  __syncthreads();
  const uint32_t m = max(max(warp_max[0], warp_max[1]),
                         max(warp_max[2], warp_max[3]));
  const int bw = 32 - __clz(static_cast<int>(m));  // __clz(0) == 32
  uint32_t mine = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    const uint32_t word = __ballot_sync(0xffffffffu, (x >> p) & 1u);
    if (lane == p) mine = word;
  }
  // thread (w, lane) writes plane `lane`, word w: offset lane*4 + w
  packed[b * kBlock + lane * 4 + w] = lane < bw ? mine : 0u;
  if (t == 0) bw_out[b] = bw;
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
    pack_kernel<<<static_cast<unsigned>(nb), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(deltas), static_cast<uint32_t*>(packed),
        static_cast<int32_t*>(bw));
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
