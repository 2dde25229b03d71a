// Fused unpack + prefix-sum + BM25 numerator over compacted postings
// blocks, and its mid-grid theta-tightening variant, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   kernels/bm25_blockmax/kernel.py::bm25_blocks_pallas
//       (_bm25_kernel, and _bm25_kernel_partials with partials=True)
//   kernels/bm25_blockmax/kernel.py::bm25_blocks_midgrid_pallas
//       (_bm25_kernel_midgrid)
//   kernels/bm25_blockmax/kernel.py::bm25_blocks_compact_pallas
//       (_bm25_compact_kernel, _expand_rows)
//
// Per block of 128 lanes: unpack the doc-gap and tf bit-planes, inclusive
// int32 prefix sum of the gaps onto first_doc, tf as f32, and
// num = (idf * c) * tf with c = f32(k1 + 1) rounded once on the host (how
// JAX evaluates idf[:, None] * (k1 + 1.0) * tf). Inactive blocks emit 0.
//
// Bound: bytes. A block reads 2 x 512 B of planes plus 20 B of metadata and
// writes 3 x 512 B of lanes; the arithmetic is a few dozen ops per lane.
// Design: one 128-thread CTA per block; the planes are staged through
// shared memory (one coalesced 512 B load each), the scan is a warp
// __shfl_up_sync scan plus a 4-slot cross-warp pass, added as unsigned so
// wraparound matches two's-complement JAX. All float math is IEEE
// round-to-nearest (__fmul_rn/__fadd_rn/__fdiv_rn, built with
// --fmad=false), so outputs are bit-identical to the plain version.
//
// partials: the per-lane max over every block of num / (tf + k1(1-b)) —
// order-free, so each block writes its row and one more small kernel
// reduces the rows.
//
// midgrid: the TPU kernel walks its grid in order, carrying a per-row
// k-th-best lower bound L (lane j = query row j, seeded from theta). Each
// step of block_rows blocks first flags every active block whose stored
// full-score bound ubf is below L[row] (L from before the step), then
// folds each kept block's k-th largest num / (tf + norm_max) into L. A
// block's k-th value does not depend on L (a skipped block folds 0, which
// cannot raise L >= 0), so the work splits in three launches:
//   1. one CTA per block, in parallel: decode (as above) and the block's
//      k-th value by k-1 rounds of block-wide max + retire-all-ties;
//   2. one CTA walking the steps in order: skip flags and the carry L in
//      shared memory — only the sequential part stays sequential;
//   3. one CTA per block: zero the outputs of skipped blocks.
//
// compact: the same per-block work, but each selected block's planes come
// straight from the COMPACT rows (only the live planes of every block,
// back to back: the bytes the storage codec writes) at its row offset
// coff. The TPU kernel loads a fixed 32-row window at coff, because
// Pallas needs static shapes, and masks the next block's rows with
// plane < bw. Here thread t of the 128-thread CTA loads word t % 4 of
// plane t / 4 only when that plane is live, so exactly bw rows are read
// (coalesced, 16 B per row), dead planes stage as zero, and no row past
// the array is touched. Then the same unpack, scan and f32 order as
// bm25_blocks. Inactive blocks (bucket padding) read nothing and write 0.
// Bound: bytes, as bm25_blocks, but the planes cost 16 B per live plane
// instead of 512 B per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStepRows = 128;

__device__ __forceinline__ uint32_t unpack_lane(const uint32_t* words,
                                                int nbits, int t) {
  const int w = t >> 5, j = t & 31;
  uint32_t v = 0;
#pragma unroll
  for (int p = 0; p < 32; ++p) {
    if (p < nbits) v |= ((words[p * 4 + w] >> j) & 1u) << p;
  }
  return v;
}

// inclusive scan of v over the CTA's 128 threads (unsigned, mod 2^32)
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* slots) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) slots[w] = v;
  __syncthreads();
  uint32_t off = 0;
  for (int i = 0; i < w; ++i) off += slots[i];
  return v + off;
}

// max of v over the CTA's 128 threads; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* slots) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // slots may still be read from the previous call
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(fmaxf(slots[0], slots[1]), fmaxf(slots[2], slots[3]));
}

struct Lane {
  int32_t doc;
  float tf;
  float num;
  bool act;
};

// one block's lanes from its staged planes (wd, wt: 32 planes x 4 words
// in shared memory, staged and synchronized by the caller)
__device__ __forceinline__ Lane score_lane(const uint32_t* wd,
                                           const uint32_t* wt, int bwd,
                                           int bwt, int32_t first, float idf,
                                           int32_t active, float c,
                                           uint32_t* slots) {
  const int t = threadIdx.x;
  const uint32_t gap = unpack_lane(wd, bwd, t);
  const uint32_t tfu = unpack_lane(wt, bwt, t);
  const uint32_t scan = block_scan(gap, slots);
  Lane r;
  r.doc = static_cast<int32_t>(static_cast<uint32_t>(first) + scan);
  r.tf = __uint2float_rn(tfu);
  r.num = __fmul_rn(__fmul_rn(idf, c), r.tf);
  r.act = active > 0;
  return r;
}

__device__ __forceinline__ Lane decode_lane(
    const uint32_t* __restrict__ pd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ pt,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, float c, long long b) {
  __shared__ uint32_t wd[kBlock], wt[kBlock], slots[4];
  const int t = threadIdx.x;
  wd[t] = pd[b * kBlock + t];
  wt[t] = pt[b * kBlock + t];
  __syncthreads();
  return score_lane(wd, wt, bwd[b], bwt[b], first[b], idf[b], active[b], c,
                    slots);
}

// stage one block's live planes from compact rows: word t % 4 of plane
// t / 4, zero past the block's width (and past the rows array)
__device__ __forceinline__ void stage_compact(
    const uint32_t* __restrict__ rows, long long n_rows, int32_t coff,
    int32_t bw, uint32_t* w) {
  const int t = threadIdx.x;
  const int p = t >> 2;
  const long long row = static_cast<long long>(coff) + p;
  w[t] = (p < bw && row >= 0 && row < n_rows) ? rows[row * 4 + (t & 3)]
                                              : 0u;
}

__global__ void bm25_kernel(
    const uint32_t* __restrict__ pd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ pt,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, float c, float min_norm,
    int32_t* __restrict__ doc_out, float* __restrict__ tf_out,
    float* __restrict__ num_out, float* __restrict__ part_rows) {
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const Lane r = decode_lane(pd, bwd, first, pt, bwt, idf, active, c, b);
  const long long o = b * kBlock + t;
  doc_out[o] = r.act ? r.doc : 0;
  tf_out[o] = r.act ? r.tf : 0.0f;
  num_out[o] = r.act ? r.num : 0.0f;
  if (part_rows != nullptr) {
    part_rows[o] = (r.act && r.tf > 0.0f)
        ? __fdiv_rn(r.num, __fadd_rn(r.tf, min_norm)) : 0.0f;
  }
}

__global__ void bm25_compact_kernel(
    const uint32_t* __restrict__ cpd, long long n_rows_d,
    const int32_t* __restrict__ coffd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ cpt,
    long long n_rows_t, const int32_t* __restrict__ cofft,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, float c,
    int32_t* __restrict__ doc_out, float* __restrict__ tf_out,
    float* __restrict__ num_out) {
  __shared__ uint32_t wd[kBlock], wt[kBlock], slots[4];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const long long o = b * kBlock + t;
  if (active[b] <= 0) {  // uniform over the CTA: no barrier is skipped
    doc_out[o] = 0;
    tf_out[o] = 0.0f;
    num_out[o] = 0.0f;
    return;
  }
  const int32_t nd = bwd[b], nt = bwt[b];
  stage_compact(cpd, n_rows_d, coffd[b], nd, wd);
  stage_compact(cpt, n_rows_t, cofft[b], nt, wt);
  __syncthreads();
  const Lane r = score_lane(wd, wt, nd, nt, first[b], idf[b], 1, c, slots);
  doc_out[o] = r.doc;
  tf_out[o] = r.tf;
  num_out[o] = r.num;
}

// per-lane max over the S rows, starting from 0 (the Pallas carry's init)
__global__ void lane_max_kernel(const float* __restrict__ rows,
                                float* __restrict__ out, long long S) {
  const int t = threadIdx.x;
  float m = 0.0f;
  for (long long s = 0; s < S; ++s) m = fmaxf(m, rows[s * kBlock + t]);
  out[t] = m;
}

__global__ void midgrid_decode_kernel(
    const uint32_t* __restrict__ pd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ pt,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, const float* __restrict__ nmax,
    float c, int k, int32_t* __restrict__ doc_out,
    float* __restrict__ tf_out, float* __restrict__ num_out,
    float* __restrict__ kth_out) {
  __shared__ float slots[4];
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const Lane r = decode_lane(pd, bwd, first, pt, bwt, idf, active, c, b);
  const long long o = b * kBlock + t;
  doc_out[o] = r.act ? r.doc : 0;
  tf_out[o] = r.act ? r.tf : 0.0f;
  num_out[o] = r.act ? r.num : 0.0f;
  // k-th largest pessimistic partial: k-1 rounds of (max, retire every
  // lane equal to it), then the max of what is left, floored at 0
  float cur = (r.act && r.tf > 0.0f)
      ? __fdiv_rn(r.num, __fadd_rn(r.tf, *nmax)) : 0.0f;
  for (int i = 0; i < k - 1; ++i) {
    const float m = block_max(cur, slots);
    if (cur == m) cur = -1.0f;
  }
  const float kth = fmaxf(block_max(cur, slots), 0.0f);
  if (t == 0) kth_out[b] = kth;
}

// the sequential part: skip flags and the per-row carry, step by step
__global__ void midgrid_skip_kernel(
    const int32_t* __restrict__ active, const int32_t* __restrict__ rows,
    const float* __restrict__ ubf, const float* __restrict__ theta,
    const float* __restrict__ kth, int block_rows,
    int32_t* __restrict__ skip, long long S) {
  __shared__ float L[kBlock];
  __shared__ float kth_eff[kMaxStepRows];
  __shared__ int row_s[kMaxStepRows];
  const int t = threadIdx.x;
  L[t] = theta[t];
  __syncthreads();
  for (long long s0 = 0; s0 < S; s0 += block_rows) {
    if (t < block_rows) {
      const long long b = s0 + t;
      const int row = rows[b];
      const float l_row = (row >= 0 && row < kBlock) ? L[row] : 0.0f;
      const bool sk = active[b] > 0 && ubf[b] < l_row;
      skip[b] = sk ? 1 : 0;
      kth_eff[t] = sk ? 0.0f : kth[b];
      row_s[t] = row;
    }
    __syncthreads();
    float m = 0.0f;
    for (int r = 0; r < block_rows; ++r) {
      if (row_s[r] == t) m = fmaxf(m, kth_eff[r]);
    }
    L[t] = fmaxf(L[t], m);
    __syncthreads();
  }
}

__global__ void midgrid_zero_kernel(const int32_t* __restrict__ skip,
                                    int32_t* __restrict__ doc_out,
                                    float* __restrict__ tf_out,
                                    float* __restrict__ num_out) {
  const long long b = blockIdx.x;
  if (skip[b] == 0) return;
  const long long o = b * kBlock + threadIdx.x;
  doc_out[o] = 0;
  tf_out[o] = 0.0f;
  num_out[o] = 0.0f;
}

}  // namespace

extern "C" {

// -> doc_out (S,128) i32, tf_out/num_out (S,128) f32; with part_rows
// (S,128) f32 scratch and part_out (128,) f32 non-null, also the partials
int bm25_blocks(const void* pd, const void* bwd, const void* first,
                const void* pt, const void* bwt, const void* idf,
                const void* active, float c, float min_norm, void* doc_out,
                void* tf_out, void* num_out, void* part_rows, void* part_out,
                long long S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > 0) {
    bm25_kernel<<<static_cast<unsigned>(S), kBlock, 0, st>>>(
        static_cast<const uint32_t*>(pd), static_cast<const int32_t*>(bwd),
        static_cast<const int32_t*>(first), static_cast<const uint32_t*>(pt),
        static_cast<const int32_t*>(bwt), static_cast<const float*>(idf),
        static_cast<const int32_t*>(active), c, min_norm,
        static_cast<int32_t*>(doc_out), static_cast<float*>(tf_out),
        static_cast<float*>(num_out), static_cast<float*>(part_rows));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (part_out != nullptr) {
    lane_max_kernel<<<1, kBlock, 0, st>>>(
        static_cast<const float*>(part_rows), static_cast<float*>(part_out),
        S);
  }
  return static_cast<int>(cudaGetLastError());
}

// -> doc_out (S,128) i32, tf_out/num_out (S,128) f32 for the S selected
// blocks, their planes read from the compact rows cpd (n_rows_d, 4) and
// cpt (n_rows_t, 4) at the blocks' offsets coffd/cofft
int bm25_compact(const void* cpd, long long n_rows_d, const void* coffd,
                 const void* bwd, const void* first, const void* cpt,
                 long long n_rows_t, const void* cofft, const void* bwt,
                 const void* idf, const void* active, float c, void* doc_out,
                 void* tf_out, void* num_out, long long S, void* stream) {
  if (S > 0) {
    bm25_compact_kernel<<<static_cast<unsigned>(S), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(cpd), n_rows_d,
        static_cast<const int32_t*>(coffd), static_cast<const int32_t*>(bwd),
        static_cast<const int32_t*>(first), static_cast<const uint32_t*>(cpt),
        n_rows_t, static_cast<const int32_t*>(cofft),
        static_cast<const int32_t*>(bwt), static_cast<const float*>(idf),
        static_cast<const int32_t*>(active), c,
        static_cast<int32_t*>(doc_out), static_cast<float*>(tf_out),
        static_cast<float*>(num_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// -> doc_out, tf_out, num_out as bm25_blocks with skipped blocks zeroed,
// skip_out (S,) i32; kth (S,) f32 is scratch
int bm25_midgrid(const void* pd, const void* bwd, const void* first,
                 const void* pt, const void* bwt, const void* idf,
                 const void* active, const void* rows, const void* ubf,
                 const void* theta, const void* nmax, float c, int k,
                 int block_rows, void* kth, void* doc_out, void* tf_out,
                 void* num_out, void* skip_out, long long S, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (block_rows < 1 || block_rows > kMaxStepRows || S % block_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(S);
  midgrid_decode_kernel<<<grid, kBlock, 0, st>>>(
      static_cast<const uint32_t*>(pd), static_cast<const int32_t*>(bwd),
      static_cast<const int32_t*>(first), static_cast<const uint32_t*>(pt),
      static_cast<const int32_t*>(bwt), static_cast<const float*>(idf),
      static_cast<const int32_t*>(active), static_cast<const float*>(nmax),
      c, k, static_cast<int32_t*>(doc_out), static_cast<float*>(tf_out),
      static_cast<float*>(num_out), static_cast<float*>(kth));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  midgrid_skip_kernel<<<1, kBlock, 0, st>>>(
      static_cast<const int32_t*>(active), static_cast<const int32_t*>(rows),
      static_cast<const float*>(ubf), static_cast<const float*>(theta),
      static_cast<const float*>(kth), block_rows,
      static_cast<int32_t*>(skip_out), S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  midgrid_zero_kernel<<<grid, kBlock, 0, st>>>(
      static_cast<const int32_t*>(skip_out), static_cast<int32_t*>(doc_out),
      static_cast<float*>(tf_out), static_cast<float*>(num_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
