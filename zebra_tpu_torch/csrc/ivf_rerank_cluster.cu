// IVF probe re-rank for Hopper (sm_90a), cluster-major form: the (query,
// probe) pairs of a batch are grouped by the cluster block they probe, each
// block is read ONCE for all the queries that probe it and scored against
// them as one product on the tensor cores, and a second kernel selects each
// query's top k from the scores.
//
// Replaces, beside the per-query kernels that keep every other shape:
//   zebra_tpu/ops/pallas_ivf.py:72 (_kernel_factory), as csrc/ivf_rerank.cu
//     does, on int8 slabs with scales (with or without the residual scan),
//     on bf16 slabs and on f32 slabs, with the f32 query;
//   zebra_tpu/ops/experimental_ivf.py:34 (_kernel_factory_v2), as
//     csrc/ivf_rerank_wave.cu does, on int8 + scales and bf16 slabs with the
//     query rounded to bf16 (round_q), and on f32 slabs with the f32 query;
//   zebra_tpu/ops/experimental_ivf.py:178 (_kernel_factory_v3), as
//     csrc/ivf_rerank_aug.cu does, on augmented bf16 and f32 slabs (aug: one
//     raw dot per row, min(d, BIG), positions on the flat probe axis).
// Reached through zebra_tpu_torch/ops/ivf_cluster.py::cluster_rerank and
// ::aug_rerank, which the wrappers ops/ivf_rerank.py and
// ops/experimental_ivf.py call where ivf_cluster.takes_cluster_form says so.
//
// Bound: device-memory reads. On the refine=4 path at 1M x 768 int8
// (B=16384, P=4) the 65,536 pairs probe ~15.7k distinct blocks, each read
// ~4.2 times by a per-query kernel; read once, the distinct live rows are
// ~0.76 GB, 0.23 ms at 3.35 TB/s. The products cost microseconds on the
// tensor cores. So the design reads each live row once per work item and
// spends as few instructions per byte as it can: a per-query kernel turns
// every int8 code into a float once per query that probes it (I2F), this
// form never does.
//
// Design:
//   * the wrapper sorts the B*P probes stably by cluster (a library sort);
//     the items kernel cuts the sorted pairs into work items of up to 8
//     pairs of one cluster (a hot cluster becomes several items),
//     a thread per pair, and counts them on the card: the scoring grid is
//     the most items there can be, and blocks past the count exit;
//   * stage kernel, a warp per query, once per query (not per pair): the
//     query as the product takes it, in the layout of its shared-memory
//     rows. On int8 slabs four int8 digits, q = u*(d0 + d1/2^7 + d2/2^14 +
//     d3/2^21) with u = 2^(e-6) from the query's largest |q| (exact to f32's
//     24 bits at its largest entries; the error is under u*2^-22); on bf16
//     slabs bf16 parts, hi + mid + lo == q exactly, or the one bf16-rounded
//     part (round_q); on f32 slabs two TF32 parts, hi = tf32(q) and lo = q -
//     hi. Also |q|^2 (of the rounded query with round_q);
//   * score kernel, one block of 4 warps per item: the item's staged queries
//     are copied to shared memory (only those the item has); warp w takes
//     the 16-row tiles w, w+4, ... of the block's live prefix (counts[c];
//     tiles past it are never read) as one stream of steps, 256 contiguous
//     bytes of each of its rows a step, which each lane copies with cp.async
//     into its own slots of a per-warp ring three steps ahead (the first
//     ones while the queries are staged); a lane reads back only what it
//     copied, so no barrier guards the ring. The K
//     order inside a chunk is permuted so that a lane's 16 contiguous bytes
//     ARE its mma.sync A fragments and the staged rows are read in the same
//     order. int8 codes enter the tensor cores as they are: m16n8k32 int8
//     products against each digit, summed exactly in int32 over the whole
//     row (the residual against the first three digits); the digits' sums
//     are combined in f32 at the end. bf16 rows: m16n8k16 products against
//     each part into fresh f32 accumulators per chunk (short independent
//     chains), added on the CUDA cores. f32 rows: 3xTF32 on m16n8k8, each
//     element split hi + lo on the CUDA cores as it leaves the ring, hi*hi
//     into one fresh accumulator per k-step parity and hi*lo + lo*hi into
//     another, per 64-column chunk (the tensor core truncates as it
//     accumulates; lsh_rerank_slab.cu:93-134), added on the CUDA cores:
//     about f32's accuracy at 3 products, where three bf16 parts of the row
//     would take 6-9 products and 3 roundings an element. mma.sync rather
//     than wgmma: a tile is 16 live rows x the item's 8 queries (the path's
//     blocks are probed by ~2-4 queries of a batch of 16384), the A operand
//     comes straight from the ring, and the product is not what bounds the
//     kernel;
//   * epilogue: dequantise after the dot (scale, plus rscale times the
//     residual dot), the distance from the stored norm and |q|^2, +inf for
//     rows past counts[c] or tombstoned, written at the pair's own place of
//     dist [B, P*C] (query b, probe position p, row r: b*P*C + p*C + r). Every
//     entry of dist is written once. The aug epilogue (kernel 3): every one
//     of the C rows is read whatever counts[c] says (a dead or empty row
//     carries PEN = 3.2e38 in lane D and the query 1 there), the distance is
//     the raw dot, and min(d, BIG) is written (fminf: an overflow to +inf, or
//     a NaN, comes out BIG too);
//   * select kernel, one warp per query over its P*C entries held in
//     registers: a radix select on the order-preserving bits of the distance
//     finds the kk-th smallest (kk = min(k, live entries)), the entries below
//     it and the lowest-positioned ties at it are collected, and each one's
//     rank is counted against the others by (distance, position). Entries
//     >= BIG are missing; the aug form returns positions on the flat [P*C]
//     axis instead of slab slots.
//
// Contract: that of csrc/ivf_rerank.cu / csrc/ivf_rerank_wave.cu
// (ivf_rerank.cu:22-31, ivf_rerank_wave.cu:27-37): dequantise after the dot;
// cosine 1 - dot * rsqrt(max(|q|^2 n2, 1e-30)) and 1 where |q|^2 n2 == 0; l2
// sqrt(max(|q|^2 + n2 - 2 dot, 0)), sql2 without the sqrt; invalid rows never
// selected, (+inf, -1) past a query's live rows; ties to the lowest position
// of the flattened [P*C] probe axis; k <= 128, any P >= 1. The aug form has
// that of csrc/ivf_rerank_aug.cu (experimental_ivf.py:178-360): d = min(<w,
// row>, BIG) over all C rows of each probed block, f32 w (three bf16 parts on
// a bf16 slab, two TF32 parts on an f32 one) or w rounded to bf16 (round_q),
// values >= BIG never selected, positions on the flat [P*C] axis. Taken for D
// (the stored row width) a multiple of 16, C a multiple of 16 and P*C <= 2048
// (the wrapper's rule). Row offsets are 64-bit.

#include <type_traits>

#include "rerank_common.cuh"

namespace {

using namespace zt;

constexpr int kCWarps = 4;             // warps per scoring block
constexpr int kItem = 8;               // queries per work item: one n=8 tile
constexpr int kCThreads = kCWarps * 32;
constexpr int kChunk = 64;             // columns per chunk: 2 int8, 4 bf16 or 8 tf32 k-steps
constexpr int kSelWarps = 8;           // queries per selection block
constexpr int kMaxEntries = 2048;      // P*C a selection warp holds

// d = a * b + d, one m16n8k16 bf16 product with f32 accumulation. a: rows
// g and g+8 at k 2c..2c+1 and 2c+8..2c+9 (g = lane/4, c = lane%4); b: query
// g at k 2c..2c+1 and 2c+8..2c+9; d: rows g and g+8 at queries 2c, 2c+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a * b + d, one m16n8k32 int8 product with exact int32 accumulation. a:
// rows g and g+8 at k 4c..4c+3 and 16+4c..16+4c+3; b: query g at the same k;
// d as in mma_bf16.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a * b + d, one m16n8k8 TF32 product with f32 accumulation. a: rows g
// and g+8 at k c and c+4 (a0: g,c; a1: g+8,c; a2: g,c+4; a3: g+8,c+4); b:
// query g at k c and c+4; d as in mma_bf16. The tensor core reads the
// leading 10 mantissa bits of each operand.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi = x rounded to TF32 (10 mantissa bits, half away from zero); lo = x -
// hi, exact in f32, of which the tensor core reads the leading 10 bits. A
// finite x stays finite: PEN = 3.2e38 rounds to below 2^128.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ float metric_distance(int metric, float dot, float qn2, float n2) {
  if (metric == 0) {
    const float d = 1.f - dot * rsqrtf(fmaxf(qn2 * n2, 1e-30f));
    return n2 * qn2 > 0.f ? d : 1.f;
  }
  const float d2 = fmaxf(qn2 + n2 - 2.f * dot, 0.f);
  return metric == 1 ? sqrtf(d2) : d2;
}

// int8 slabs: the query as kDigits int8 digits, q * 2^(6-e) = d0 + d1/2^7 +
// d2/2^14 + d3/2^21 (+ under 2^-22), e the binary exponent of max|q|, so
// |d0| < 64 and every digit fits an int8; the residual takes the first
// kResDigits (the rest moves the residual term by ~2^-20 of itself).
constexpr int kDigits = 4;
constexpr int kResDigits = 3;

template <class E>
constexpr bool kIsI8 = std::is_same_v<E, ElemI8>;
template <class E>
constexpr bool kIsF32 = std::is_same_v<E, ElemF32>;

// Query rows staged per query, and the bytes between two: an int8 digit row
// holds Dpad bytes, a bf16 part row 2*Dpad, an f32 (TF32 part) row 4*Dpad
// (Dpad a multiple of 64), padded so that the 16-byte B loads of a quarter
// warp (lanes g = 0, 1 at c = 0..3) hit distinct banks: the stride between
// queries is 64 mod 128 bytes (int8: lane c reads bytes 16c..16c+15 of a
// 64-byte chunk; bf16: 16c and 64+16c of a 128-byte chunk; f32: 64j+16c of
// a 256-byte chunk, j = 0..3).
template <class E, bool kRound>
constexpr int kQRows = kIsI8<E> ? kDigits : kIsF32<E> ? 2 : (kRound ? 1 : 3);
template <class E>
__host__ __device__ constexpr int query_row_bytes(int dpad) {
  // 4 * (Dpad + 16), 3 * (2 Dpad + 64) or 2 * (4 Dpad + 32) = 64 mod 128
  return kIsI8<E> ? dpad + 16 : kIsF32<E> ? 4 * dpad + 32 : 2 * dpad + 64;
}

// 16 bytes global -> shared, or 16 zero bytes when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's slab bytes for one 64-column chunk, as 16-byte pieces: int8 rows
// g and g+8 at columns 16c..16c+15 (then the residual's two, when scanned);
// bf16 rows g and g+8 at columns 8c..8c+7, then both at 32+8c..32+8c+7; f32
// rows g and g+8 at columns 16j+4c..16j+4c+3 for j = 0..3.
template <class E, bool kRes>
constexpr int kPieces = kIsF32<E> ? 8 : (kIsI8<E> && !kRes) ? 2 : 4;
constexpr int kMaxPieces = 8;
// the pieces a lane holds for one chunk (int8 without the residual pads its
// two with zeros to four)
template <class E, bool kRes>
constexpr int kHeld = kPieces<E, kRes> > 4 ? kPieces<E, kRes> : 4;
// chunks a step copies: a step reads 256 contiguous bytes of each row (its
// lanes' 64-byte pieces of neighbouring chunks leave together)
template <class E, bool kRes>
constexpr int kSub = kMaxPieces / kPieces<E, kRes>;
// steps a warp keeps in flight, 12 KB of slab: a whole tile of 768 int8
// columns, half of it with the residual or in bf16, a quarter in f32
constexpr int kDepth = 3;
// bytes of one warp's ring: [depth][sub-chunk][piece][lane][16 B]
template <class E, bool kRes>
constexpr int kRingBytes = kDepth * kSub<E, kRes> * kPieces<E, kRes> * 32 * 16;

// The running dots of a warp's tile against the item's (up to) 8 queries:
// int32 per digit (int8 slabs: exact), or f32 (bf16 slabs).
template <bool kI8, bool kRes>
struct Acc {
  int d[kDigits][4];
  int r[kRes ? kResDigits : 1][4];
  float f[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = 0.f;
#pragma unroll
      for (int i = 0; i < kDigits; ++i) d[i][e] = 0;
#pragma unroll
      for (int i = 0; i < (kRes ? kResDigits : 1); ++i) r[i][e] = 0;
    }
  }
};

// One chunk of the product: the lane's pieces `w` (see kPieces) times every
// staged row of the item's queries (`qchunk`: the lane's bytes of this chunk
// in query 0's first row). int8 codes go to the tensor cores as they are, in
// m16n8k32 int8 products against each digit; bf16 rows in m16n8k16 products
// against each bf16 part, through fresh f32 accumulators (one per part and
// k-step parity: short independent chains) that the CUDA cores add to the
// running dot; f32 rows split into TF32 hi + lo, in m16n8k8 products hi*hi
// and hi*lo + lo*hi, through fresh accumulators per k-step parity. The K
// order inside a chunk is permuted so that a lane's 16 contiguous bytes ARE
// its A fragments; the query rows are read in the same order.
template <class E, bool kRound, bool kRes>
__device__ __forceinline__ void multiply_chunk(const uint4 (&w)[kHeld<E, kRes>],
                                               const char* qchunk, int rb,
                                               Acc<kIsI8<E>, kRes>& acc) {
  constexpr int kRows = kQRows<E, kRound>;
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&w[0]);
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&w[1]);
  if constexpr (kIsI8<E>) {
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&w[2]);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&w[3]);
#pragma unroll
    for (int i = 0; i < kDigits; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(qchunk + static_cast<size_t>(i) * rb);
      const uint32_t bw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        mma_s8(acc.d[i], w0[2 * s], w1[2 * s], w0[2 * s + 1], w1[2 * s + 1], bw[2 * s],
               bw[2 * s + 1]);
        if constexpr (kRes) {
          if (i < kResDigits)
            mma_s8(acc.r[i < kResDigits ? i : 0], r0[2 * s], r1[2 * s], r0[2 * s + 1],
                   r1[2 * s + 1], bw[2 * s], bw[2 * s + 1]);
        }
      }
    }
  } else if constexpr (kIsF32<E>) {
    // group j: columns 16j..16j+15 in two k-steps t; a lane's 4 values of
    // row g (piece 2j) at 16j+4c..16j+4c+3 are a0, a2 of step 0 then of
    // step 1, row g+8's (piece 2j+1) a1, a3; the staged query the same way
    float big[2][4], small[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[t][e] = small[t][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* rg = reinterpret_cast<const uint32_t*>(&w[2 * j]);
      const uint32_t* r8 = reinterpret_cast<const uint32_t*>(&w[2 * j + 1]);
      const uint4 uh = *reinterpret_cast<const uint4*>(qchunk + 64 * j);
      const uint4 ul = *reinterpret_cast<const uint4*>(qchunk + rb + 64 * j);
      const uint32_t bh[4] = {uh.x, uh.y, uh.z, uh.w};
      const uint32_t bl[4] = {ul.x, ul.y, ul.z, ul.w};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t ah[4], al[4];
        split_tf32(rg[2 * t], ah[0], al[0]);
        split_tf32(r8[2 * t], ah[1], al[1]);
        split_tf32(rg[2 * t + 1], ah[2], al[2]);
        split_tf32(r8[2 * t + 1], ah[3], al[3]);
        mma_tf32(big[t], ah, bh[2 * t], bh[2 * t + 1]);
        mma_tf32(small[t], ah, bl[2 * t], bl[2 * t + 1]);
        mma_tf32(small[t], al, bh[2 * t], bh[2 * t + 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc.f[e] += (small[0][e] + small[1][e]) + (big[0][e] + big[1][e]);
  } else {
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&w[2]);
    const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&w[3]);
    // A fragments of the four k-steps: [step][a0..a3]
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[s][0] = w0[2 * s];
      a[s][2] = w0[2 * s + 1];
      a[s][1] = w1[2 * s];
      a[s][3] = w1[2 * s + 1];
      a[2 + s][0] = w2[2 * s];
      a[2 + s][2] = w2[2 * s + 1];
      a[2 + s][1] = w3[2 * s];
      a[2 + s][3] = w3[2 * s + 1];
    }
    float part[kRows][2][4];
#pragma unroll
    for (int pp = 0; pp < kRows; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[pp][h][e] = 0.f;
#pragma unroll
    for (int pp = 0; pp < kRows; ++pp) {
      const char* p0 = qchunk + static_cast<size_t>(pp) * rb;
      const uint4 u0 = *reinterpret_cast<const uint4*>(p0);
      const uint4 u1 = *reinterpret_cast<const uint4*>(p0 + 64);
      const uint32_t bw[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_bf16(part[pp][s & 1], a[s][0], a[s][1], a[s][2], a[s][3], bw[2 * s],
                 bw[2 * s + 1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = 0.f;
#pragma unroll
      for (int pp = 0; pp < kRows; ++pp) sum += part[pp][0][e] + part[pp][1][e];
      acc.f[e] += sum;
    }
  }
}

// The work items of the sorted pairs, a thread per sorted position: its
// cluster widened to int32 into sorted_c, and, where a pair opens an item
// (the 0th, nq-th, 2nq-th ... pair of its cluster's run), its position into
// item_start at a slot taken from the counter *n_items (item order is free:
// each item writes its own pairs' places). keys are the sorted cluster ids,
// int16 or int32 (key_bytes).
__global__ void __launch_bounds__(256) cluster_items_kernel(
    const void* __restrict__ keys, int key_bytes, int n, int nq, int32_t* __restrict__ sorted_c,
    int32_t* __restrict__ item_start, int32_t* __restrict__ n_items) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto key = [&](int j) -> int {
    return key_bytes == 2 ? static_cast<int>(static_cast<const int16_t*>(keys)[j])
                          : static_cast<const int32_t*>(keys)[j];
  };
  const int c = key(i);
  sorted_c[i] = c;
  int first = i;  // the run's first position
  if (i > 0 && key(i - 1) == c) {
    // within nq of its run's start only the start opens an item
    if (i < nq || key(i - nq) != c) return;
    int lo = 0, hi = i - nq;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key(mid) < c) lo = mid + 1; else hi = mid;
    }
    first = lo;
  }
  if ((i - first) % nq == 0) item_start[atomicAdd(n_items, 1)] = i;
}

// The queries as the scoring kernel multiplies them, a warp per query,
// written once per query in the layout of its shared-memory rows (kQRows
// rows of query_row_bytes each; pads unwritten), with |q|^2 and, for int8
// slabs, the digits' unit 2^(e-6). int8 slabs: kDigits int8 digits;
// bf16 slabs: the bf16 parts; f32 slabs: the TF32 hi and the f32 lo.
template <class E, bool kRound>
__global__ void __launch_bounds__(kSelWarps * 32) stage_queries_kernel(
    const float* __restrict__ q, int B, int D, char* __restrict__ staged,
    float* __restrict__ qn2, float* __restrict__ qunit) {
  constexpr bool kI8 = kIsI8<E>;
  constexpr int kRows = kQRows<E, kRound>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kSelWarps + warp;
  if (b >= B) return;
  const int dpad = (D + kChunk - 1) / kChunk * kChunk;
  const int rb = query_row_bytes<E>(dpad);
  const float* qb = q + static_cast<int64_t>(b) * D;
  char* row = staged + static_cast<int64_t>(b) * kRows * rb;
  auto value = [&](int d) {  // the query's value at d as the kernel multiplies it
    const float4 v = d < D ? *reinterpret_cast<const float4*>(qb + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kRound)
      return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
    return v;
  };
  float part = 0.f, amax = 0.f;
  for (int d = 4 * lane; d < dpad; d += 128) {
    const float4 v = value(d);
    part = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, part))));
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  part = warp_sum(part);  // |q|^2 (of the rounded query with kRound)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  int ex = 0;
  frexpf(amax, &ex);  // amax in [2^(ex-1), 2^ex)
  const float unit = amax > 0.f ? ldexpf(1.f, ex - 6) : 1.f;
  if (lane == 0) {
    qn2[b] = part;
    qunit[b] = unit;
  }
  for (int d = 4 * lane; d < dpad; d += 128) {
    const float4 v = value(d);
    const float x[4] = {v.x, v.y, v.z, v.w};
    if constexpr (kI8) {
      uint32_t dig[kDigits] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float r = x[i] / unit;  // exact: a power of two
#pragma unroll
        for (int k = 0; k < kDigits; ++k) {
          const float dk = rintf(r);
          dig[k] |= (static_cast<uint32_t>(static_cast<int>(dk)) & 0xffu) << (8 * i);
          r = (r - dk) * 128.f;  // exact
        }
      }
#pragma unroll
      for (int k = 0; k < kDigits; ++k) *reinterpret_cast<uint32_t*>(row + k * rb + d) = dig[k];
    } else if constexpr (kIsF32<E>) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__float_as_uint(x[i]), h[i], l[i]);
      *reinterpret_cast<uint4*>(row + 4 * d) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(row + rb + 4 * d) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hf = round_bf16(x[i]);
        h[i] = __float_as_uint(hf) >> 16;
        if constexpr (!kRound) {
          const float r1 = x[i] - hf;  // exact
          const float mf = round_bf16(r1);
          m[i] = __float_as_uint(mf) >> 16;
          l[i] = __float_as_uint(round_bf16(r1 - mf)) >> 16;  // exact: hi + mid + lo == x
        }
      }
      *reinterpret_cast<uint2*>(row + 2 * d) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
      if constexpr (!kRound) {
        *reinterpret_cast<uint2*>(row + rb + 2 * d) =
            make_uint2(m[0] | (m[1] << 16), m[2] | (m[3] << 16));
        *reinterpret_cast<uint2*>(row + 2 * rb + 2 * d) =
            make_uint2(l[0] | (l[1] << 16), l[2] | (l[3] << 16));
      }
    }
  }
}

// E: ElemI8 (codes with scales, optionally the residual), ElemBF16 or
// ElemF32. kRound: the query rounded to bf16 first (the wave re-rank's
// round_q, the aug re-rank's one-pass form); else the f32 query (bf16 slabs:
// as hi + mid + lo bf16 parts, whose sum is the f32 value exactly; f32 slabs:
// TF32 hi + lo). kAug: the augmented slab's epilogue (counts, norms, valid,
// scales and metric unread).
template <class E, bool kRound, bool kRes, bool kAug>
__global__ void __launch_bounds__(kCThreads) cluster_score_kernel(
    const char* __restrict__ staged, const float* __restrict__ qn2,
    const float* __restrict__ qunit, const int64_t* __restrict__ order,
    const int32_t* __restrict__ sorted_c, const int32_t* __restrict__ item_start,
    const int32_t* __restrict__ n_items, int n_pairs,
    const int32_t* __restrict__ counts, const typename E::T* __restrict__ vec,
    const int8_t* __restrict__ res, const float* __restrict__ scales,
    const float* __restrict__ rscales, const float* __restrict__ norms,
    const uint8_t* __restrict__ valid, float* __restrict__ dist, int P, int C, int D,
    int metric) {
  constexpr bool kI8 = kIsI8<E>;
  constexpr int kRows = kQRows<E, kRound>;
  constexpr int kP = kPieces<E, kRes>;
  constexpr int kS = kSub<E, kRes>;
  constexpr int kD = kDepth;
  constexpr size_t kEl = sizeof(typename E::T);
  extern __shared__ float4 smem4[];
  const int dpad = (D + kChunk - 1) / kChunk * kChunk;
  const int rb = query_row_bytes<E>(dpad);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // [kCWarps] rings of slab pieces, then [kItem * kRows] staged query rows
  uint4* ring = reinterpret_cast<uint4*>(smem4) + warp * (kD * kS * kP * 32);
  char* qs = reinterpret_cast<char*>(smem4) + kCWarps * kRingBytes<E, kRes>;
  __shared__ float qn2s[kItem];
  __shared__ float qsc[kItem];  // int8 slabs: 2^(e-6), the digits' unit
  __shared__ int64_t dsts[kItem];

  if (static_cast<int>(blockIdx.x) >= *n_items) return;
  const int s0 = item_start[blockIdx.x];
  const int c = sorted_c[s0];
  int nq = 1;
  while (nq < kItem && s0 + nq < n_pairs && sorted_c[s0 + nq] == c) ++nq;
  const int cnt = kAug ? C : min(max(counts[c], 0), C);
  const int ntile = (cnt + 15) >> 4;
  const int nchunk = dpad / kChunk;
  const int nstep = (nchunk + kS - 1) / kS;  // steps a tile takes
  const int g = lane >> 2, c4 = lane & 3;

  // The warp's work is the steps of its tiles warp, warp + 4, ... in one
  // stream. A lane copies only the pieces it multiplies, so it waits for its
  // own copies and no barrier is needed around the ring.
  const int my_tiles = ntile > warp ? (ntile - warp + kCWarps - 1) / kCWarps : 0;
  const int steps = my_tiles * nstep;
  // issue side of the stream: the next step's row-g pointers, chunk and slot
  const int64_t tile_step = static_cast<int64_t>(kCWarps) * 16 * D;  // elements
  const char* i_row = reinterpret_cast<const char*>(vec) +
                      (static_cast<int64_t>(c) * C + warp * 16 + g) * D * kEl;
  const char* i_res = kRes ? reinterpret_cast<const char*>(res) +
                                 (static_cast<int64_t>(c) * C + warp * 16 + g) * D
                           : nullptr;
  int i_left = steps, i_ks = 0, i_slot = 0;
  auto issue = [&]() {
    if (i_left > 0) {
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        const int kc = i_ks * kS + u;
        if (kc >= nchunk) break;
        uint4* slot = ring + ((i_slot * kS + u) * kP) * 32 + lane;
        if constexpr (kI8) {
          const int e = kc * kChunk + 16 * c4;
          const int on = e < D ? 16 : 0;
          const int ec = on ? e : 0;
          cp_async16(slot, i_row + ec, on);
          cp_async16(slot + 32, i_row + 8 * D + ec, on);
          if constexpr (kRes) {
            cp_async16(slot + 64, i_res + ec, on);
            cp_async16(slot + 96, i_res + 8 * D + ec, on);
          }
        } else if constexpr (kIsF32<E>) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = kc * kChunk + 16 * j + 4 * c4;
            const int on = e < D ? 16 : 0;
            const int ec = on ? 4 * e : 0;
            cp_async16(slot + 64 * j, i_row + ec, on);
            cp_async16(slot + 64 * j + 32, i_row + 32 * D + ec, on);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = kc * kChunk + 32 * h + 8 * c4;
            const int on = e < D ? 16 : 0;
            const int ec = on ? 2 * e : 0;
            cp_async16(slot + 64 * h, i_row + ec, on);
            cp_async16(slot + 64 * h + 32, i_row + 16 * D + ec, on);
          }
        }
      }
      --i_left;
      i_slot = i_slot + 1 == kD ? 0 : i_slot + 1;
      if (++i_ks == nstep) {
        i_ks = 0;
        i_row += tile_step * kEl;
        if constexpr (kRes) i_res += tile_step;
      }
    }
    cp_async_commit();
  };
  // the first chunks load while the queries are staged: they do not depend
  // on them
#pragma unroll
  for (int st = 0; st < kD - 1; ++st) issue();

  // copy the item's staged queries in, a warp per query; the rows of the
  // tile's missing queries stay unwritten: their output columns are never read
  const int qbytes = kRows * rb;
  for (int j = warp; j < nq; j += kCWarps) {
    const int64_t pair = order[s0 + j];
    const int64_t b = pair / P;
    if (lane == 0) {
      dsts[j] = b * P * C + (pair % P) * C;
      qn2s[j] = qn2[b];
      qsc[j] = qunit[b];
    }
    const uint4* src = reinterpret_cast<const uint4*>(staged + b * qbytes);
    uint4* dst = reinterpret_cast<uint4*>(qs + static_cast<size_t>(j) * qbytes);
#pragma unroll 4
    for (int i = lane; i < qbytes / 16; i += 32) dst[i] = __ldg(src + i);
  }
  __syncthreads();

  // consume side: the step's slot, chunk and tile
  const char* qlane = qs + static_cast<size_t>(g * kRows) * rb + 16 * c4;
  constexpr int chunk_bytes = kChunk * sizeof(typename E::T);
  Acc<kI8, kRes> acc;
  acc.zero();
  int c_slot = 0, c_ks = 0, c_t = warp;
  for (int st = 0; st < steps; ++st) {
    issue();
    cp_async_wait<kD - 1>();  // step st's copies have landed
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int kc = c_ks * kS + u;
      if (kc >= nchunk) break;
      const uint4* slot = ring + ((c_slot * kS + u) * kP) * 32 + lane;
      uint4 w[kHeld<E, kRes>];
#pragma unroll
      for (int p = 0; p < kHeld<E, kRes>; ++p)
        w[p] = p < kP ? slot[32 * p] : make_uint4(0u, 0u, 0u, 0u);
      multiply_chunk<E, kRound, kRes>(w, qlane + chunk_bytes * kc, rb, acc);
    }
    c_slot = c_slot + 1 == kD ? 0 : c_slot + 1;
    if (++c_ks != nstep) continue;
    // epilogue of tile c_t: rows c_t*16 + g (+8), queries 2*c4 (+1)
    const int t = c_t;
    c_ks = 0;
    c_t += kCWarps;
    if constexpr (kAug) {
      // the raw dot, clamped: a dead row's PEN lane keeps it at BIG
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 2 * c4 + e;
          if (j < nq) dist[dsts[j] + t * 16 + g + 8 * h] = fminf(acc.f[2 * h + e], kBig);
        }
      acc.zero();
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = t * 16 + g + 8 * h;
      const int64_t slot_id = static_cast<int64_t>(c) * C + r;
      const bool live = r < cnt && valid[slot_id] != 0;
      const float sc = kI8 ? scales[slot_id] : 1.f;
      const float rsc = kRes ? rscales[slot_id] : 0.f;
      const float n2 = norms[slot_id];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * c4 + e;
        const int x = 2 * h + e;
        if (j < nq) {
          float dot;
          if constexpr (kI8) {
            // the digits' exact sums, smallest first; dequantised after the dot
            float v = 0.f;
#pragma unroll
            for (int k = kDigits - 1; k >= 0; --k)
              v = v * (1.f / 128.f) + static_cast<float>(acc.d[k][x]);
            dot = v * qsc[j] * sc;
            if constexpr (kRes) {
              float u = 0.f;
#pragma unroll
              for (int k = kResDigits - 1; k >= 0; --k)
                u = u * (1.f / 128.f) + static_cast<float>(acc.r[k][x]);
              dot += u * qsc[j] * rsc;
            }
          } else {
            dot = acc.f[x];
          }
          dist[dsts[j] + r] = live ? metric_distance(metric, dot, qn2s[j], n2) : INFINITY;
        }
      }
    }
    acc.zero();
  }
  cp_async_wait<0>();
  // rows past the live tiles are never read
  const int r0 = ntile * 16, rest = C - r0;
  for (int i = tid; i < nq * rest; i += kCThreads) dist[dsts[i / rest] + r0 + i % rest] = INFINITY;
}

// Distance bits in an order-preserving unsigned key (-0 folded onto +0).
__device__ __forceinline__ uint32_t order_key(float d) {
  const uint32_t u = __float_as_uint(d + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int PER>
__global__ void __launch_bounds__(kSelWarps * 32) cluster_select_kernel(
    const float* __restrict__ dist, const int32_t* __restrict__ probes, int B, int P, int C,
    int k, float* __restrict__ out_d, int64_t* __restrict__ out_s) {
  __shared__ uint32_t sel_k[kSelWarps][kMaxK];
  __shared__ int sel_p[kSelWarps][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kSelWarps + warp;
  if (b >= B) return;  // warp-uniform; only warp-level syncs below
  const int n = P * C;
  const float* row = dist + static_cast<int64_t>(b) * n;
  uint32_t key[PER];
  int nv = 0;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int i = lane + 32 * t;
    const float d = i < n ? row[i] : INFINITY;
    const bool ok = d < kBig;
    key[t] = ok ? order_key(d) : 0xFFFFFFFFu;
    nv += ok;
  }
  nv = __reduce_add_sync(0xffffffffu, nv);
  const int kk = min(k, nv);
  if (kk > 0) {
    // the kk-th smallest key, bit by bit from the top; `want` ends as the
    // number of entries equal to it that are taken
    uint32_t prefix = 0u;
    int want = kk;
    for (int bit = 31; bit >= 0; --bit) {
      // keys that share the prefix above `bit` and have a 0 there
      const uint32_t m = 0xFFFFFFFFu << bit;
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < PER; ++t) cnt += (key[t] & m) == prefix;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (want > cnt) {
        prefix |= 1u << bit;
        want -= cnt;
      }
    }
    const unsigned below = (1u << lane) - 1u;
    int base = 0, eq_seen = 0;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const bool eq = key[t] == prefix;
      const unsigned eqm = __ballot_sync(0xffffffffu, eq);
      const bool take = key[t] < prefix || (eq && eq_seen + __popc(eqm & below) < want);
      eq_seen += __popc(eqm);
      const unsigned tm = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int o = base + __popc(tm & below);
        sel_k[warp][o] = key[t];
        sel_p[warp][o] = lane + 32 * t;
      }
      base += __popc(tm);
    }
    __syncwarp();
    for (int e = lane; e < kk; e += 32) {
      const uint32_t ke = sel_k[warp][e];
      const int pe = sel_p[warp][e];
      int rank = 0;
      for (int f = 0; f < kk; ++f) {
        const uint32_t kf = sel_k[warp][f];
        rank += kf < ke || (kf == ke && sel_p[warp][f] < pe);
      }
      const int64_t o = static_cast<int64_t>(b) * k + rank;
      out_d[o] = row[pe];
      // a slab slot; or, without probes (the aug form), the position itself
      out_s[o] = probes == nullptr
                     ? pe
                     : static_cast<int64_t>(probes[static_cast<int64_t>(b) * P + pe / C]) * C +
                           pe % C;
    }
  }
  for (int j = kk + lane; j < k; j += 32) {
    const int64_t o = static_cast<int64_t>(b) * k + j;
    out_d[o] = INFINITY;
    out_s[o] = -1;
  }
}

struct ScoreArgs {
  const float* q;
  char* staged;
  float* qn2;
  float* qunit;
  int B;
  const int64_t* order;
  const int32_t* sorted_c;
  const int32_t* item_start;
  const int32_t* n_items;
  int grid, n_pairs;
  const int32_t* counts;
  const void* vec;
  const int8_t* res;
  const float* scales;
  const float* rscales;
  const float* norms;
  const uint8_t* valid;
  float* dist;
  int P, C, D, metric;
  cudaStream_t stream;
};

template <class E, bool kRound, bool kRes, bool kAug = false>
void launch_score(const ScoreArgs& a) {
  const int dpad = (a.D + kChunk - 1) / kChunk * kChunk;
  const size_t smem = static_cast<size_t>(kCWarps) * kRingBytes<E, kRes> +
                      static_cast<size_t>(kItem * kQRows<E, kRound>) * query_row_bytes<E>(dpad);
  stage_queries_kernel<E, kRound><<<(a.B + kSelWarps - 1) / kSelWarps, kSelWarps * 32, 0,
                                     a.stream>>>(a.q, a.B, a.D, a.staged, a.qn2, a.qunit);
  auto* fn = cluster_score_kernel<E, kRound, kRes, kAug>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  fn<<<a.grid, kCThreads, smem, a.stream>>>(
      a.staged, a.qn2, a.qunit, a.order, a.sorted_c, a.item_start, a.n_items, a.n_pairs,
      a.counts, static_cast<const typename E::T*>(a.vec), a.res, a.scales, a.rscales, a.norms,
      a.valid, a.dist, a.P, a.C, a.D, a.metric);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// shape it does not take.

namespace {

int launch_items(const void* keys, int key_bytes, int n, int nq, int32_t* sorted_c,
                 int32_t* item_start, int32_t* n_items, cudaStream_t stream) {
  if ((key_bytes != 2 && key_bytes != 4) || nq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaMemsetAsync(n_items, 0, sizeof(int32_t), stream);
  if (n > 0)
    cluster_items_kernel<<<(n + 255) / 256, 256, 0, stream>>>(keys, key_bytes, n, nq, sorted_c,
                                                             item_start, n_items);
  return 0;
}

}  // namespace

// zt_ivf_cluster_items: the work items of n sorted cluster ids `keys` (int16
// or int32, key_bytes): sorted_c [n] int32, item starts in item_start (at
// most n // nq + min(n, K) of them, in no order) and their count in
// *n_items.
extern "C" int zt_ivf_cluster_items(const void* keys, int key_bytes, int n, int nq,
                                    int32_t* sorted_c, int32_t* item_start, int32_t* n_items,
                                    void* stream) {
  const int err = launch_items(keys, key_bytes, n, nq, sorted_c, item_start, n_items,
                               static_cast<cudaStream_t>(stream));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// zt_ivf_cluster_score: the work items (as zt_ivf_cluster_items; `order` the
// sorting's int64 pair ids b*P + p, `grid` the most items there can be), the
// staged queries, then the scoring kernel. dtype 0 f32 slab, 1 bf16 slab
// (raw 16-bit patterns), 2 int8 slab (scales required; res/rscales
// optional); round_q: the query rounded to bf16 (bf16 and int8 slabs);
// metric: 0 cosine, 1 l2, 2 sql2. aug: an augmented f32 or bf16 slab of row
// width D, `q` the transformed query w; counts, scales, norms, valid and
// metric are not read. staged (B * rows * row bytes, see query_row_bytes),
// qn2 and qunit ([B] f32), sorted_c [n_pairs], item_start [grid] and
// n_items [1] are the wrapper's scratch. Writes every entry of dist [B, P*C].
extern "C" int zt_ivf_cluster_score(const float* q, char* staged, float* qn2, float* qunit,
                                    int B, const void* keys, int key_bytes,
                                    const int64_t* order, int32_t* sorted_c,
                                    int32_t* item_start, int32_t* n_items, int grid,
                                    int n_pairs, const int32_t* counts,
                                    const void* vec, int dtype, const int8_t* res,
                                    const float* scales, const float* rscales,
                                    const float* norms, const uint8_t* valid, float* dist,
                                    int P, int C, int D, int metric, int round_q, int aug,
                                    void* stream) {
  if (grid <= 0) return 0;
  if (D % 16 != 0 || C % 16 != 0 || (res != nullptr && (dtype != 2 || round_q || aug)) ||
      (dtype == 0 && round_q) || (aug && dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_items(keys, key_bytes, n_pairs, kItem, sorted_c, item_start, n_items, s);
  if (err != 0) return err;
  const ScoreArgs a{q, staged, qn2, qunit, B, order, sorted_c, item_start, n_items, grid,
                    n_pairs, counts, vec, res, scales, rscales, norms, valid, dist, P, C, D,
                    metric, s};
  if (dtype == 2) {
    if (round_q)
      launch_score<ElemI8, true, false>(a);
    else if (res != nullptr)
      launch_score<ElemI8, false, true>(a);
    else
      launch_score<ElemI8, false, false>(a);
  } else if (dtype == 1) {
    if (aug && round_q)
      launch_score<ElemBF16, true, false, true>(a);
    else if (aug)
      launch_score<ElemBF16, false, false, true>(a);
    else if (round_q)
      launch_score<ElemBF16, true, false>(a);
    else
      launch_score<ElemBF16, false, false>(a);
  } else if (dtype == 0) {
    if (aug)
      launch_score<ElemF32, false, false, true>(a);
    else
      launch_score<ElemF32, false, false>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// zt_ivf_cluster_select: each query's k smallest of dist [B, P*C] (entries
// >= 3e38 are missing) as (distance, slot) [B, k], (+inf, -1) past its live
// entries; P*C <= 2048. probes == nullptr: positions on the flat [P*C] axis
// instead of slots.
extern "C" int zt_ivf_cluster_select(const float* dist, const int32_t* probes, int B, int P,
                                     int C, int k, float* out_d, int64_t* out_s, void* stream) {
  const int n = P * C;
  if (B <= 0) return 0;
  if (n > kMaxEntries || k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kSelWarps - 1) / kSelWarps);
  const auto s = static_cast<cudaStream_t>(stream);
  const int per = (n + 31) / 32;
  const dim3 block(kSelWarps * 32);
  if (per <= 4)
    cluster_select_kernel<4><<<grid, block, 0, s>>>(dist, probes, B, P, C, k, out_d, out_s);
  else if (per <= 8)
    cluster_select_kernel<8><<<grid, block, 0, s>>>(dist, probes, B, P, C, k, out_d, out_s);
  else if (per <= 16)
    cluster_select_kernel<16><<<grid, block, 0, s>>>(dist, probes, B, P, C, k, out_d, out_s);
  else if (per <= 32)
    cluster_select_kernel<32><<<grid, block, 0, s>>>(dist, probes, B, P, C, k, out_d, out_s);
  else
    cluster_select_kernel<64><<<grid, block, 0, s>>>(dist, probes, B, P, C, k, out_d, out_s);
  return static_cast<int>(cudaGetLastError());
}
