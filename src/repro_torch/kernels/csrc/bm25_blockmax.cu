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
// Bound: bytes. A block reads its live planes (16 B each, at most 2 x 512
// B) plus 20 B of metadata and writes 3 x 512 B of lanes; the arithmetic
// is a few dozen ops per lane.
// Design (bm25_blocks; compact below shares it): one warp takes a block,
// in a grid-stride loop over a grid of resident CTAs (pack's design,
// warp_block.cuh). Lane p loads plane p of each stream as one 16-byte
// load from the dense (S, 32, 4) arrays, only if p < bw: dead planes are
// never read, as the TPU kernel's plane < bw mask ignores them. Each warp
// loads the next block's metadata while this block's planes are in
// flight. The five-stage shuffle transpose leaves gap and tf 32w + t in
// lane t's word w; the prefix sum is four warp __shfl_up_sync scans (one
// per word) plus the earlier words' totals, broadcast from lane 31, all in
// uint32: addition mod 2^32 is exact in any order, so the doc ids wrap as
// JAX's int32 do. Each output is written as four coalesced 128-byte
// stores. Inactive blocks (active <= 0, uniform over the warp) read no
// planes and write 0. No shared memory, no block barrier on the main
// loop. The loads need 16-byte aligned plane arrays; the wrapper checks
// it. All float math is IEEE round-to-nearest (__fmul_rn/__fadd_rn/
// __fdiv_rn, built with --fmad=false), so outputs are bit-identical to the
// plain version.
//
// partials: the per-lane max, from a +0.0 start, over every block of
// num / (tf + k1(1-b)) (0 where the block is inactive or tf is 0), in
// the same launch. Each thread keeps the running max of its four lanes
// (t, 32 + t, 64 + t, 96 + t) in registers as int32 bits; at the end the
// CTA's warps fold theirs into shared memory and the CTA folds its 128
// into the output, both by integer atomicMax, on an output the entry
// point zeroes first. That is
// exact: only values above +0.0 can raise the max, and positive floats
// order as their int32 bits do (finite idf, so no NaN); a negative value
// or -0.0 (whose bits are negative ints) never beats the +0.0 start, as
// under the TPU kernel's jnp.maximum from zeros, which orders -0.0 below
// +0.0, so an all-zero or all -0.0 lane comes out as +0.0.
//
// midgrid: the TPU kernel walks its grid in order, carrying a per-row
// k-th-best lower bound L (lane j = query row j, seeded from theta). Each
// step of block_rows blocks first flags every active block whose stored
// full-score bound ubf is below L[row] (L from before the step), then
// folds each kept block's k-th largest num / (tf + norm_max) into L. A
// block's k-th value does not depend on L (a skipped block folds 0, which
// cannot raise L >= 0), so the work splits in three launches:
//   1. one 128-thread CTA per block, in parallel: decode (the planes
//      staged through shared memory, a 32-step unpack per lane, the scan
//      a warp scan plus a 4-slot cross-warp pass, in uint32) and the
//      block's k-th value by k-1 rounds of block-wide max + retire-all-
//      ties;
//   2. the walk, one CTA: only the carry's chain stays sequential;
//   3. one CTA per block: zero the outputs of skipped blocks.
// The walk is bound by latency, not bytes: S / block_rows dependent
// steps, each a read of L and a fold into it, against 16 B of metadata
// and 4 B of flag per block. So nothing on the chain touches global
// memory. All four warps stage the metadata (rows, active, ubf, kth) into
// shared memory with cp.async, in chunks of up to 4096 blocks, double
// buffered: chunk c + 1 loads while warp 0 walks chunk c, so any S works.
// Warp 0 walks with __syncwarp between phases and no block barrier: per
// step, lane j (and j + 32, ... for block_rows > 32) reads L[row] for its
// block and flags it; after a __syncwarp the lanes fold the kept blocks'
// k-th values into L with a shared-memory atomicMax on the float's bits;
// after another __syncwarp the next step reads L. The next step's
// metadata is read from shared memory into registers before the chain's
// read of L. The flags go to shared memory and are written back,
// coalesced, by all four warps at the end of each chunk. The fold is
// exact whatever order the lanes take: the reference starts each step's
// update at 0, so after the first step (whose decisions read theta as
// given, then L = max(L, 0)) every L and every folded value is >= 0, and
// non-negative floats order as their int32 bits do (-0.0, whose bits are
// the least int, compares equal to +0.0 in every decision). Rows outside
// [0, 128) read 0 and fold nowhere. bm25_midgrid_walk launches the walk
// alone, to time it.
//
// compact: bm25_blocks' work and design, but each selected block's planes
// come straight from the COMPACT rows (only the live planes of every
// block, back to back: the bytes the storage codec writes) at its row
// offset coff. The TPU kernel loads a fixed 32-row window at coff,
// because Pallas needs static shapes, and masks the next block's rows
// with plane < bw. Here lane p loads row coff + p of each stream as one
// 16-byte load, only if p < bw and the row lies in the array: exactly bw
// rows are read, dead planes are zero, and no row past the array is
// touched. The transpose, scans, stores and metadata a block ahead are
// bm25_blocks' (score_block). Plain stores: the next kernel on the path
// reads them. The rows arrays must be 16-byte aligned; the wrapper checks
// it. Bound: bytes, as bm25_blocks.
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_block.cuh"

namespace {

using warp_block::kBlock;
constexpr int kWarpThreads = 256;   // bm25_blocks, compact: 8 warps, a
constexpr int kWarps = kWarpThreads / 32;  // block each
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

struct BlockMeta {
  int32_t act, bwd, bwt, first;
  float idf;
};

// lane p: plane p (16 B) of block b of a dense (S, 32, 4) array if the
// plane is live, else 0
__device__ __forceinline__ uint4 load_plane(const uint4* __restrict__ planes,
                                            long long b, int32_t bw,
                                            int lane) {
  return lane < bw ? planes[b * 32 + lane] : make_uint4(0u, 0u, 0u, 0u);
}

// one active block from its planes in lanes (rd, rt: lane p holds plane
// p's four words): transpose, scan onto first, write the block's doc, tf
// and num (lane t: values t, 32 + t, 64 + t, 96 + t at o + 32 w); its tf
// and num stay in tf[], num[] for the caller
__device__ __forceinline__ void score_block(
    uint4 rd, uint4 rt, int32_t first, float idf, float c, int lane,
    long long o, int32_t* __restrict__ doc_out, float* __restrict__ tf_out,
    float* __restrict__ num_out, float (&tf)[4], float (&num)[4]) {
  uint32_t gap[4] = {rd.x, rd.y, rd.z, rd.w};
  uint32_t tfu[4] = {rt.x, rt.y, rt.z, rt.w};
  warp_block::transpose32x4(gap, lane);
  warp_block::transpose32x4(tfu, lane);
  // inclusive scan of each word across the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t n = __shfl_up_sync(warp_block::kFull, gap[w], off);
      if (lane >= off) gap[w] += n;
    }
  }
  const float ic = __fmul_rn(idf, c);
  uint32_t carry = static_cast<uint32_t>(first);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t total = __shfl_sync(warp_block::kFull, gap[w], 31);
    tf[w] = __uint2float_rn(tfu[w]);
    num[w] = __fmul_rn(ic, tf[w]);
    doc_out[o + 32 * w] = static_cast<int32_t>(carry + gap[w]);
    tf_out[o + 32 * w] = tf[w];
    num_out[o + 32 * w] = num[w];
    carry += total;
  }
}

__device__ __forceinline__ void zero_block(long long o, int32_t* doc_out,
                                           float* tf_out, float* num_out) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    doc_out[o + 32 * w] = 0;
    tf_out[o + 32 * w] = 0.0f;
    num_out[o + 32 * w] = 0.0f;
  }
}

template <bool kPartials>
__global__ void __launch_bounds__(kWarpThreads) bm25_kernel(
    const uint4* __restrict__ pd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint4* __restrict__ pt,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, float c, float min_norm,
    int32_t* __restrict__ doc_out, float* __restrict__ tf_out,
    float* __restrict__ num_out, int* __restrict__ part_out, long long S) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long b = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  int part[4] = {0, 0, 0, 0};  // this lane's running max, as int32 bits
  BlockMeta m{};
  if (b < S) m = {active[b], bwd[b], bwt[b], first[b], idf[b]};
  for (; b < S; b += stride) {  // b is uniform over the warp
    uint4 rd = make_uint4(0u, 0u, 0u, 0u), rt = rd;
    if (m.act > 0) {
      rd = load_plane(pd, b, m.bwd, lane);
      rt = load_plane(pt, b, m.bwt, lane);
    }
    BlockMeta nm{};
    const long long nb = b + stride;
    if (nb < S) nm = {active[nb], bwd[nb], bwt[nb], first[nb], idf[nb]};
    const long long o = b * kBlock + lane;
    if (m.act <= 0) {
      zero_block(o, doc_out, tf_out, num_out);
    } else {
      float tf[4], num[4];
      score_block(rd, rt, m.first, m.idf, c, lane, o, doc_out, tf_out,
                  num_out, tf, num);
      if (kPartials) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float p = tf[w] > 0.0f
              ? __fdiv_rn(num[w], __fadd_rn(tf[w], min_norm)) : 0.0f;
          part[w] = max(part[w], __float_as_int(p));
        }
      }
    }
    m = nm;
  }
  if (kPartials) {
    __shared__ int cta[kBlock];
    for (int i = threadIdx.x; i < kBlock; i += kWarpThreads) cta[i] = 0;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (part[w] > 0) atomicMax(&cta[32 * w + lane], part[w]);
    __syncthreads();
    for (int i = threadIdx.x; i < kBlock; i += kWarpThreads)
      if (cta[i] > 0) atomicMax(&part_out[i], cta[i]);
  }
}

struct CompactMeta {
  int32_t act, coffd, cofft, bwd, bwt, first;
  float idf;
};

__device__ __forceinline__ CompactMeta load_meta(
    const int32_t* __restrict__ active, const int32_t* __restrict__ coffd,
    const int32_t* __restrict__ cofft, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ bwt, const int32_t* __restrict__ first,
    const float* __restrict__ idf, long long b) {
  return {active[b], coffd[b], cofft[b], bwd[b], bwt[b], first[b], idf[b]};
}

// lane p: compact row coff + p (plane p of the block) if the plane is
// live and the row lies in the array, else 0
__device__ __forceinline__ uint4 load_row(const uint4* __restrict__ rows,
                                          long long n_rows, int32_t coff,
                                          int32_t bw, int lane) {
  const long long row = static_cast<long long>(coff) + lane;
  return (lane < bw && row >= 0 && row < n_rows) ? rows[row]
                                                 : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kWarpThreads) bm25_compact_kernel(
    const uint4* __restrict__ cpd, long long n_rows_d,
    const int32_t* __restrict__ coffd, const int32_t* __restrict__ bwd,
    const int32_t* __restrict__ first, const uint4* __restrict__ cpt,
    long long n_rows_t, const int32_t* __restrict__ cofft,
    const int32_t* __restrict__ bwt, const float* __restrict__ idf,
    const int32_t* __restrict__ active, float c,
    int32_t* __restrict__ doc_out, float* __restrict__ tf_out,
    float* __restrict__ num_out, long long S) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long b = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  CompactMeta m{};
  if (b < S) m = load_meta(active, coffd, cofft, bwd, bwt, first, idf, b);
  for (; b < S; b += stride) {  // b is uniform over the warp
    uint4 rd = make_uint4(0u, 0u, 0u, 0u), rt = rd;
    if (m.act > 0) {
      rd = load_row(cpd, n_rows_d, m.coffd, m.bwd, lane);
      rt = load_row(cpt, n_rows_t, m.cofft, m.bwt, lane);
    }
    CompactMeta nm{};
    if (b + stride < S)
      nm = load_meta(active, coffd, cofft, bwd, bwt, first, idf, b + stride);
    const long long o = b * kBlock + lane;
    if (m.act <= 0) {
      zero_block(o, doc_out, tf_out, num_out);
    } else {
      float tf[4], num[4];
      score_block(rd, rt, m.first, m.idf, c, lane, o, doc_out, tf_out,
                  num_out, tf, num);
    }
    m = nm;
  }
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

constexpr int kWalkThreads = 128;   // 4 warps stage and write back
constexpr int kWalkChunk = 4096;    // blocks per staged chunk, at most
// two chunks of (rows, active, ubf, kth) and one chunk of flags
constexpr int kWalkSmem = (2 * 4 + 1) * kWalkChunk * 4;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies, all but the newest group, have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct WalkBuf {
  int32_t* row;
  int32_t* act;
  float* ubf;
  float* kth;
};

__device__ __forceinline__ WalkBuf walk_buf(uint32_t* smem, long long c,
                                            int chunk) {
  uint32_t* base = smem + (c & 1) * 4 * chunk;
  return {reinterpret_cast<int32_t*>(base),
          reinterpret_cast<int32_t*>(base + chunk),
          reinterpret_cast<float*>(base + 2 * chunk),
          reinterpret_cast<float*>(base + 3 * chunk)};
}

// every thread of the CTA: cp.async blocks [b0, b0 + n) into buf
__device__ __forceinline__ void stage_chunk(
    const WalkBuf& buf, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ active, const float* __restrict__ ubf,
    const float* __restrict__ kth, long long b0, int n) {
  for (int i = threadIdx.x; i < n; i += kWalkThreads) {
    cp_async4(buf.row + i, rows + b0 + i);
    cp_async4(buf.act + i, active + b0 + i);
    cp_async4(buf.ubf + i, ubf + b0 + i);
    cp_async4(buf.kth + i, kth + b0 + i);
  }
}

struct Meta {
  int32_t row, act;
  float ubf, kth;
};

// lane's blocks of step st: j = lane + 32 i (clamped to the step's first
// block past block_rows; those lanes neither flag nor fold)
template <int NPL>
__device__ __forceinline__ void load_step(const WalkBuf& buf, int st,
                                          int block_rows, int lane,
                                          Meta (&m)[NPL]) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int j = lane + 32 * i;
    const int o = st * block_rows + (j < block_rows ? j : 0);
    m[i] = {buf.row[o], buf.act[o], buf.ubf[o], buf.kth[o]};
  }
}

// warp 0 walks one staged chunk of `steps` steps; L in shared memory
template <int NPL>
__device__ __forceinline__ void walk_chunk(const WalkBuf& buf,
                                           int32_t* flags, float* L,
                                           int block_rows, int steps,
                                           bool first_chunk) {
  const int lane = threadIdx.x;
  Meta cur[NPL], nxt[NPL];
  load_step<NPL>(buf, 0, block_rows, lane, cur);
  for (int st = 0; st < steps; ++st) {
    // the next step's metadata, off the carry's chain
    load_step<NPL>(buf, st + 1 < steps ? st + 1 : st, block_rows, lane, nxt);
    float fold[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int j = lane + 32 * i;
      const bool in = cur[i].row >= 0 && cur[i].row < kBlock;
      const float l = in ? L[cur[i].row] : 0.0f;
      const bool sk = cur[i].act > 0 && cur[i].ubf < l;
      if (j < block_rows) flags[st * block_rows + j] = sk ? 1 : 0;
      fold[i] = sk ? 0.0f : cur[i].kth;
    }
    __syncwarp();  // every decision of the step has read L
    if (first_chunk && st == 0) {
      // the reference's fold starts from 0: L >= 0 from here on
      for (int r = lane; r < kBlock; r += 32) L[r] = fmaxf(L[r], 0.0f);
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int j = lane + 32 * i;
      if (j < block_rows && cur[i].row >= 0 && cur[i].row < kBlock)
        atomicMax(reinterpret_cast<int*>(L + cur[i].row),
                  __float_as_int(fold[i]));
    }
    __syncwarp();  // the step's folds land before the next step reads L
#pragma unroll
    for (int i = 0; i < NPL; ++i) cur[i] = nxt[i];
  }
}

// the sequential part: skip flags and the per-row carry, chunk by chunk
// (chunk: a multiple of block_rows, at most kWalkChunk)
template <int NPL>
__global__ void __launch_bounds__(kWalkThreads) midgrid_walk_kernel(
    const int32_t* __restrict__ active, const int32_t* __restrict__ rows,
    const float* __restrict__ ubf, const float* __restrict__ theta,
    const float* __restrict__ kth, int block_rows, int chunk,
    int32_t* __restrict__ skip, long long S) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float L[kBlock];
  const int t = threadIdx.x;
  int32_t* flags = reinterpret_cast<int32_t*>(smem + 8 * chunk);
  L[t] = theta[t];
  const long long n_chunks = (S + chunk - 1) / chunk;
  stage_chunk(walk_buf(smem, 0, chunk), rows, active, ubf, kth, 0,
              static_cast<int>(min(S, static_cast<long long>(chunk))));
  cp_async_commit();
  for (long long c = 0; c < n_chunks; ++c) {
    const long long b0 = c * chunk;
    const int n = static_cast<int>(min(S - b0, static_cast<long long>(chunk)));
    if (c + 1 < n_chunks) {
      const long long b1 = b0 + chunk;
      stage_chunk(walk_buf(smem, c + 1, chunk), rows, active, ubf, kth, b1,
                  static_cast<int>(min(S - b1, static_cast<long long>(chunk))));
    }
    cp_async_commit();      // (an empty group past the last chunk)
    cp_async_wait_prior();  // this thread's copies of chunk c landed
    __syncthreads();        // and every thread's; L's seed too
    if (t < 32)
      walk_chunk<NPL>(walk_buf(smem, c, chunk), flags, L, block_rows,
                      n / block_rows, c == 0);
    __syncthreads();        // the chunk's flags are final
    for (int i = t; i < n; i += kWalkThreads) skip[b0 + i] = flags[i];
  }
}

template <int NPL>
cudaError_t launch_walk(const int32_t* active, const int32_t* rows,
                        const float* ubf, const float* theta,
                        const float* kth, int block_rows, int32_t* skip,
                        long long S, cudaStream_t st) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        midgrid_walk_kernel<NPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWalkSmem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const long long full = (kWalkChunk / block_rows) * block_rows;
  const int chunk = static_cast<int>(S < full ? S : full);
  midgrid_walk_kernel<NPL><<<1, kWalkThreads, (2 * 4 + 1) * chunk * 4, st>>>(
      active, rows, ubf, theta, kth, block_rows, chunk, skip, S);
  return cudaGetLastError();
}

// the walk for S > 0 blocks and a valid block_rows
cudaError_t walk(const void* active, const void* rows, const void* ubf,
                 const void* theta, const void* kth, int block_rows,
                 void* skip_out, long long S, cudaStream_t st) {
  const int32_t* act = static_cast<const int32_t*>(active);
  const int32_t* rws = static_cast<const int32_t*>(rows);
  const float* ub = static_cast<const float*>(ubf);
  const float* th = static_cast<const float*>(theta);
  const float* kt = static_cast<const float*>(kth);
  int32_t* sk = static_cast<int32_t*>(skip_out);
  switch ((block_rows + 31) / 32) {  // blocks per lane per step
    case 1: return launch_walk<1>(act, rws, ub, th, kt, block_rows, sk, S, st);
    case 2: return launch_walk<2>(act, rws, ub, th, kt, block_rows, sk, S, st);
    case 3: return launch_walk<3>(act, rws, ub, th, kt, block_rows, sk, S, st);
    default: return launch_walk<4>(act, rws, ub, th, kt, block_rows, sk, S,
                                   st);
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

// -> doc_out (S,128) i32, tf_out/num_out (S,128) f32 from the dense
// planes pd, pt (S, 32, 4), both 16-byte aligned; with part_out (128,)
// non-null, also the partials there (as f32 bits)
int bm25_blocks(const void* pd, const void* bwd, const void* first,
                const void* pt, const void* bwt, const void* idf,
                const void* active, float c, float min_norm, void* doc_out,
                void* tf_out, void* num_out, void* part_out, long long S,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* part = static_cast<int*>(part_out);
  if (part != nullptr) {
    const cudaError_t e = cudaMemsetAsync(part, 0, kBlock * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  static int resident[2] = {0, 0};
  const auto kern = part != nullptr ? bm25_kernel<true> : bm25_kernel<false>;
  unsigned grid = 0;
  const cudaError_t e = warp_block::grid_for(
      kern, kWarpThreads, S, &resident[part != nullptr], &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kWarpThreads, 0, st>>>(
      static_cast<const uint4*>(pd), static_cast<const int32_t*>(bwd),
      static_cast<const int32_t*>(first), static_cast<const uint4*>(pt),
      static_cast<const int32_t*>(bwt), static_cast<const float*>(idf),
      static_cast<const int32_t*>(active), c, min_norm,
      static_cast<int32_t*>(doc_out), static_cast<float*>(tf_out),
      static_cast<float*>(num_out), part, S);
  return static_cast<int>(cudaGetLastError());
}

// -> doc_out (S,128) i32, tf_out/num_out (S,128) f32 for the S selected
// blocks, their planes read from the compact rows cpd (n_rows_d, 4) and
// cpt (n_rows_t, 4), both 16-byte aligned, at the blocks' offsets
// coffd/cofft
int bm25_compact(const void* cpd, long long n_rows_d, const void* coffd,
                 const void* bwd, const void* first, const void* cpt,
                 long long n_rows_t, const void* cofft, const void* bwt,
                 const void* idf, const void* active, float c, void* doc_out,
                 void* tf_out, void* num_out, long long S, void* stream) {
  if (S > 0) {
    static int resident = 0;
    unsigned grid = 0;
    const cudaError_t e = warp_block::grid_for(
        bm25_compact_kernel, kWarpThreads, S, &resident, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    bm25_compact_kernel<<<grid, kWarpThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(cpd), n_rows_d,
        static_cast<const int32_t*>(coffd), static_cast<const int32_t*>(bwd),
        static_cast<const int32_t*>(first), static_cast<const uint4*>(cpt),
        n_rows_t, static_cast<const int32_t*>(cofft),
        static_cast<const int32_t*>(bwt), static_cast<const float*>(idf),
        static_cast<const int32_t*>(active), c,
        static_cast<int32_t*>(doc_out), static_cast<float*>(tf_out),
        static_cast<float*>(num_out), S);
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
  e = walk(active, rows, ubf, theta, kth, block_rows, skip_out, S, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  midgrid_zero_kernel<<<grid, kBlock, 0, st>>>(
      static_cast<const int32_t*>(skip_out), static_cast<int32_t*>(doc_out),
      static_cast<float*>(tf_out), static_cast<float*>(num_out));
  return static_cast<int>(cudaGetLastError());
}

// bm25_midgrid's second launch alone, for timing it: skip_out (S,) i32
// from the blocks' k-th values kth (S,) f32
int bm25_midgrid_walk(const void* active, const void* rows, const void* ubf,
                      const void* theta, const void* kth, int block_rows,
                      void* skip_out, long long S, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (block_rows < 1 || block_rows > kMaxStepRows || S % block_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(walk(active, rows, ubf, theta, kth, block_rows,
                               skip_out, S,
                               static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
