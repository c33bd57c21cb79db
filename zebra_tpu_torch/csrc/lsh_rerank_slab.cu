// LSH candidate re-rank for Hopper (sm_90a), slab-major form: for a batch
// whose sorted candidate rows hold a large share of the slab, score groups
// of queries against contiguous slab rows on the tensor cores and keep each
// query's top k among the rows it holds.
//
// Replaces zebra_tpu/ops/pallas_rerank.py:48 (_kernel_factory, the Pallas
// fused gather + distance + top-k kernel) for dense candidate sets; the
// gather form csrc/lsh_rerank.cu keeps sparse and unsorted ones. Reached
// through zebra_tpu_torch/ops/lsh_rerank.py::lsh_rerank.
//
// Bound: the card's scarce thing here is bytes per FLOP. On the LSH defaults
// at 1M x 768 f32 each of 1024 queries holds ~20% of the occupied slab and
// each row is held by ~200 queries: a per-query gather moves 0.64 TB
// (190 ms at 3.35 TB/s) for 3.1 GB of distinct rows. Read as a dense
// [queries, D] x [D, rows] product with a 20%-dense mask the same work is
// 1.57 TFLOP, three TF32 passes of it 9.5 ms at the 495 TFLOP/s peak, and
// the slab is read once per GROUP of queries.
//
// Design:
//   grid = query groups (128 queries) x slab chunks (contiguous row ranges,
//   sized from B so that the grid fills the SMs once); a block walks its
//   chunk in tiles of 128 rows.
//   0. a small kernel splits the queries once: hi = tf32(q), lo = q - hi
//      (the tensor core reads lo's leading 10 mantissa bits), into scratch.
//   1. membership by cursor: each query keeps a cursor into its sorted
//      candidate row (a binary search at the chunk's first slot); per tile
//      a warp reads a window of 32 entries per query, coalesced, consumes
//      those below the tile's end, sets bits in a [128, 128] mask in shared
//      memory and leaves each held row's stored norm there. A tile no query
//      holds is skipped unfetched.
//   2. the product, 3xTF32 on wgmma: K streams in chunks of 32 through a
//      3-stage cp.async ring. A stage holds the queries' hi and lo parts as
//      [128][32] f32 tiles in the 128-byte swizzled layout that
//      wgmma.m64n128k8.tf32 reads through a shared-memory descriptor (the B
//      operand), and the tile's slab rows, padded, which each warpgroup
//      loads as A fragments and splits in registers. Two warpgroups take 64
//      slab rows each against all 128 queries: lo*hi + hi*lo + hi*hi, the
//      dropped lo*lo ~2^-22 relative - the counterpart of the TPU kernel's
//      Precision.HIGHEST. Each K chunk's 12 products run into a fresh
//      accumulator that the CUDA cores add to the running sum (see the note
//      in the loop).
//   3. epilogue in registers: for accumulators whose mask bit is set, the
//      distance from the dot, the row's stored norm and |q|^2; those at or
//      under the query's k-th best so far go to a per-query buffer (the
//      idle ring's memory), which is folded into the query's running top-k
//      for this chunk, ordered by (distance, slot): lists of k <= 32 live
//      in shared memory, a thread each; longer ones in the partial output,
//      a warp each.
//   4. a last kernel merges each query's per-chunk lists by
//      (distance, slot) and turns each winning slot into its position in
//      the query's candidate row by binary search.
//
// Contract: that of csrc/lsh_rerank.cu (distances, +inf / -1 tail, k <= 128,
// row stride W >= D, 64-bit row offsets, f32 or bf16 slab; a bf16 row is
// exact in TF32, so it needs no lo part and two passes), with the caller's
// promise that in every candidate row the valid entries ascend strictly by
// slot: either the whole row is non-decreasing (negative pads at the head)
// or its non-negative entries are a non-decreasing prefix followed only by
// negative pads. Then "ties to the lowest position" is "ties to the lowest
// slot". Valid slots lie below `occupied`, and a slot's norm is the same in
// every row that holds it (it belongs to the slab row).

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQg = 128;     // queries per block
constexpr int kR = 128;      // slab rows per tile
constexpr int kKc = 32;      // floats of K per stage
constexpr int kLd = 36;      // padded slab-row stride in a stage, f32 elements
constexpr int kLdH = 40;     // the same for a bf16 slab, bf16 elements
constexpr int kStages = 3;
// a stage: the queries' hi and lo parts, [kQg][kKc] each in the 128-byte
// swizzled layout wgmma reads, then the slab rows [kR][kLd]
constexpr int kQFloats = kQg * kKc;
constexpr int kStageFloats = 2 * kQFloats + kR * kLd;
static_assert(kStageFloats * 4 % 1024 == 0 && kKc * 4 == 128, "swizzle atoms");
constexpr int kMaxK = 128;
constexpr int kWords = kR / 32;  // mask words per query
constexpr int kNearK = 32;       // running lists this short live in shared memory,
constexpr int kNearLd = kNearK + 1;  // a thread per list (odd stride: no bank conflict)

// (d, s) orders before (bd, bs): smaller distance, then lower slot
__device__ __forceinline__ bool before(float d, int s, float bd, int bs) {
  return d < bd || (d == bd && s < bs);
}

// x rounded to TF32 (10 mantissa bits, half away from zero), as f32 bits
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x); lo = x - hi, exact in f32, of which the tensor core reads the
// leading 10 mantissa bits (it ignores the low 13: a truncation)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Shared-memory matrix descriptor of a K-major [rows][32 f32] tile in the
// 128-byte swizzled layout (row r at r * 128 bytes, its 16-byte chunk c at
// position c ^ (r & 7); base 1024-byte aligned): start address, leading
// offset unused (1), 1024 bytes from one 8-row group to the next, layout
// type 1 (128-byte swizzle). A K step of 8 f32 inside the row adds 32 bytes
// to the start address.
__device__ __forceinline__ uint64_t smem_desc(const float* tile, int k8) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile)) + k8 * 32;
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128 over the warpgroup, f32) = a (64 x 8 TF32, registers) times
// the transposed [128][8] TF32 tile behind `desc`, plus d if `add`.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}

// generic-proxy writes to shared memory (cp.async, stores) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when bytes == 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
// the same for 8 bytes (four bf16)
__device__ __forceinline__ void cp_async8(uint16_t* dst, const uint16_t* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A candidate row's search key: negative pads at the tail sort last.
__device__ __forceinline__ int slot_key(int c, bool tail_pads) {
  return (tail_pads && c < 0) ? INT_MAX : c;
}

// first position in row[0, M) whose key is >= slot
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ row, int M,
                                           bool tail_pads, int slot) {
  int lo = 0, hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (slot_key(__ldg(row + mid), tail_pads) < slot) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool has_tail_pads(const int32_t* __restrict__ row, int M) {
  return __ldg(row) >= 0 && __ldg(row + M - 1) < 0;
}

// One K chunk into a stage: the block's queries (their pre-split hi and lo
// parts, swizzled as wgmma reads them) and the tile's slab rows (padded rows
// of XT = float or raw bf16, read back by fragment loads). Thread t owns
// chunk (t & 7), four elements, of rows (t >> 3) + 32 i of each of the three.
// VEC: cp.async (16-byte aligned sources, D and W multiples of 4); else plain
// loads, visible after the next barrier.
template <bool VEC, typename XT>
__device__ __forceinline__ void load_stage(float* st, const float* const (&qsrc)[4],
                                           const XT* const (&xsrc)[4], long long lo_off,
                                           int D, int kc, int tid) {
  constexpr bool kHalf = sizeof(XT) == 2;
  const int ch = tid & 7, col = kc * kKc + ch * 4;
  const bool in = col < D;
  XT* xs = reinterpret_cast<XT*>(st + 2 * kQFloats);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (tid >> 3) + 32 * i;
    float* dq = st + row * kKc + ((ch ^ (row & 7)) << 2);
    XT* dx = xs + row * (kHalf ? kLdH : kLd) + ch * 4;
    if (VEC) {
      cp_async16(dq, qsrc[i] + (in ? col : 0), in ? 16 : 0);
      cp_async16(dq + kQFloats, qsrc[i] + lo_off + (in ? col : 0), in ? 16 : 0);
      if constexpr (kHalf) cp_async8(dx, xsrc[i] + (in ? col : 0), in ? 8 : 0);
      else cp_async16(dx, xsrc[i] + (in ? col : 0), in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dq[j] = col + j < D ? __ldg(qsrc[i] + col + j) : 0.f;
        dq[kQFloats + j] = col + j < D ? __ldg(qsrc[i] + lo_off + col + j) : 0.f;
        dx[j] = col + j < D ? __ldg(xsrc[i] + col + j) : XT(0);
      }
    }
  }
}

// One window of 32 entries of a sorted candidate row, one per lane: those
// below `end` (a prefix of the window: the keys ascend) are consumed, the
// valid ones among them set their bit in the query's mask words and leave
// their norm. Returns the number consumed.
__device__ __forceinline__ int take_window(int key, float v, float n2, int r0, int end,
                                           unsigned* words, float* rownorm, int& found) {
  const bool in = key < end;
  if (in && v > 0.f && key >= r0) {
    const int r = key - r0;
    atomicOr(words + (r >> 5), 1u << (r & 31));
    rownorm[r] = n2;
    found = 1;
  }
  return __popc(__ballot_sync(0xffffffffu, in));
}

// A warp folds `n` buffered (distance, slot) pairs into a running list held
// across its lanes (lane l: entries l, l + 32, ...; entries past k hold
// (-inf, -1) and are never the worst): each pair that orders before the
// list's worst entry replaces it. The worst entry is each lane's own, then
// two hardware warp reductions (the largest distance as an ordered integer,
// the largest slot among the lanes that hold it). Returns the worst distance
// left in the list.
__device__ __forceinline__ float fold_list(float (&ld)[kMaxK / 32], int (&ls)[kMaxK / 32],
                                           const float* buf_d, const int* buf_s, int n,
                                           int lane) {
  float wd;
  int ws, wi;
  auto find_worst = [&]() {
    float d = ld[0];
    int sl = ls[0], j0 = 0;
#pragma unroll
    for (int j = 1; j < kMaxK / 32; ++j)
      if (before(d, sl, ld[j], ls[j])) d = ld[j], sl = ls[j], j0 = j;
    const unsigned bits = __float_as_uint(d);
    const unsigned key = bits ^ ((bits >> 31) ? 0xffffffffu : 0x80000000u);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    ws = __reduce_max_sync(0xffffffffu, key == top ? sl : INT_MIN);
    const int src = __ffs(__ballot_sync(0xffffffffu, key == top && sl == ws)) - 1;
    wd = __shfl_sync(0xffffffffu, d, src);
    wi = __shfl_sync(0xffffffffu, j0, src) * 32 + src;
  };
  find_worst();
  for (int e = 0; e < n; ++e) {
    const float cd = buf_d[e];
    const int cs = buf_s[e];
    if (!before(cd, cs, wd, ws)) continue;
    if (lane == (wi & 31)) {
#pragma unroll
      for (int j = 0; j < kMaxK / 32; ++j)
        if (j == (wi >> 5)) ld[j] = cd, ls[j] = cs;
    }
    find_worst();
  }
  return wd;
}

// XT: float, or uint16_t for a bf16 slab (raw patterns; bf16 -> f32 is the
// pattern shifted into the high half, and exact in TF32: no lo part).
template <bool VEC, typename XT>
__global__ void __launch_bounds__(kThreads, 1) lsh_rerank_slab_kernel(
    const XT* __restrict__ vec, long long S, int W, const float* __restrict__ q,
    const float* __restrict__ qsplit, int D, const int32_t* __restrict__ cand,
    const float* __restrict__ norms, const float* __restrict__ valid, int B, int M, int k,
    int metric, long long occupied, int tiles_per_chunk, int nchunks,
    float* __restrict__ part_d, int32_t* __restrict__ part_s) {
  extern __shared__ float4 smem4[];
  // the K ring (1024-byte aligned for the swizzled tiles) ...
  float* stages = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  float* buf_d = stages;                             // ... or, between products,
  int* buf_s = reinterpret_cast<int*>(stages + kQg * kR);  // the survivors [kQg][kR]
  __shared__ unsigned mask[kQg * kWords];
  __shared__ float rownorm[kR];
  __shared__ float qn2s[kQg];
  __shared__ float thr[kQg];
  __shared__ int cnt[kQg];
  __shared__ int cursor[kQg];
  __shared__ int tail_pads[kQg];
  __shared__ float near_d[kQg * kNearLd];  // the running lists, for k <= kNearK
  __shared__ int near_s[kQg * kNearLd];
  __shared__ int thr_s[kQg], thr_i[kQg];  // with thr: a near list's worst entry

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = 16 * warp + g;  // this thread's tile rows: row_a and row_a + 8
  const int q0 = blockIdx.x * kQg, chunk = blockIdx.y;
  const int ntiles = static_cast<int>((occupied + kR - 1) / kR);
  const int tile_begin = chunk * tiles_per_chunk;
  const int tile_end = min(tile_begin + tiles_per_chunk, ntiles);
  const bool near = k <= kNearK;

  // Warp w owns queries 16 w .. 16 w + 15 outside the product: their |q|^2,
  // their cursors and their running lists (lane l holds list entries l,
  // l + 32, ...; in shared memory for k <= kNearK, else in this chunk's
  // slice of the partial output).
  auto list_d = [&](int ql) {
    return near ? near_d + ql * kNearLd
                : part_d + (static_cast<long long>(q0 + ql) * nchunks + chunk) * k;
  };
  auto list_s = [&](int ql) {
    return near ? near_s + ql * kNearLd
                : part_s + (static_cast<long long>(q0 + ql) * nchunks + chunk) * k;
  };
  for (int i = 0; i < 16; ++i) {
    const int ql = warp * 16 + i, b = q0 + ql;
    float part = 0.f;
    if (b < B) {
      const float* qb = q + static_cast<long long>(b) * D;
      for (int d = lane; d < D; d += 32) {
        const float v = __ldg(qb + d);
        part = fmaf(v, v, part);
      }
      float* ld = list_d(ql);
      int* ls = list_s(ql);
      for (int j = lane; j < k; j += 32) {
        ld[j] = INFINITY;
        ls[j] = INT_MAX;
      }
    }
    part = warp_sum(part);
    if (lane == 0) {
      qn2s[ql] = part;
      thr[ql] = INFINITY;
      thr_s[ql] = INT_MAX;
      thr_i[ql] = 0;
      cnt[ql] = 0;
    }
  }
  if (lane < 16) {  // a lane per query: where its row enters this chunk
    const int ql = warp * 16 + lane, b = q0 + ql;
    int cur = M, tp = 0;
    if (b < B) {
      const int32_t* crow = cand + static_cast<long long>(b) * M;
      tp = has_tail_pads(crow, M);
      cur = lower_bound(crow, M, tp, tile_begin * kR);
    }
    cursor[ql] = cur;
    tail_pads[ql] = tp;
  }

  // the sources of this thread's chunks of a stage: 4 queries now, 4 slab
  // rows per tile
  constexpr bool kHalf = sizeof(XT) == 2;
  const float* qsrc[4];
  const XT* xsrc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qsrc[i] = qsplit + static_cast<long long>(min(q0 + (tid >> 3) + 32 * i, B - 1)) * D;
  const long long lo_off = static_cast<long long>(B) * D;  // qsplit is [2][B][D]: hi, lo
  __syncthreads();

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const long long r0 = static_cast<long long>(tile) * kR;
    // 1. membership: the first window of all 16 rows is loaded before any
    // is looked at, so that their latencies overlap
    int found = 0;
    {
      const int end = static_cast<int>(min(r0 + kR, occupied));
      int key[16];
      float v[16], n2[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ql = warp * 16 + i, idx = cursor[ql] + lane;
        const long long at = static_cast<long long>(min(q0 + ql, B - 1)) * M + idx;
        const bool ok = idx < M;  // a query past B starts at M
        key[i] = ok ? slot_key(__ldg(cand + at), tail_pads[ql]) : INT_MAX;
        v[i] = ok ? __ldg(valid + at) : 0.f;
        n2[i] = ok ? __ldg(norms + at) : 0.f;
        if (lane < kWords) mask[ql * kWords + lane] = 0u;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ql = warp * 16 + i;
        unsigned* words = mask + ql * kWords;
        int cur = cursor[ql];
        int n = take_window(key[i], v[i], n2[i], static_cast<int>(r0), end, words, rownorm,
                            found);
        cur += n;
        while (n == 32) {  // rare: more than a window of the row in one tile
          const int idx = cur + lane;
          const long long at = static_cast<long long>(q0 + ql) * M + idx;
          const bool ok = idx < M;
          n = take_window(ok ? slot_key(__ldg(cand + at), tail_pads[ql]) : INT_MAX,
                          ok ? __ldg(valid + at) : 0.f, ok ? __ldg(norms + at) : 0.f,
                          static_cast<int>(r0), end, words, rownorm, found);
          cur += n;
        }
        __syncwarp();
        if (lane == 0) cursor[ql] = cur;
      }
    }
    if (!__syncthreads_or(found)) continue;

    // 2. the product, 3xTF32: the warpgroup's 64 slab rows (A, split in
    // registers) against the block's 128 queries (B, pre-split, from shared
    // memory); this thread ends with rows row_a / row_a + 8 of queries
    // 8 j + 2 t + e in acc[4 j + e] / acc[4 j + 2 + e]
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xsrc[i] = vec + min(r0 + (tid >> 3) + 32 * i, S - 1) * W;
    float acc[64];
#pragma unroll
    for (int c = 0; c < 64; ++c) acc[c] = 0.f;
    const int nk = (D + kKc - 1) / kKc;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage<VEC>(stages + s * kStageFloats, qsrc, xsrc, lo_off, D, s, tid);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kStages - 2>();
      fence_async_smem();
      __syncthreads();
      const int nx = kc + kStages - 1;
      if (nx < nk)
        load_stage<VEC>(stages + (nx % kStages) * kStageFloats, qsrc, xsrc, lo_off, D, nx,
                        tid);
      cp_async_commit();
      const float* st = stages + (kc % kStages) * kStageFloats;
      constexpr int ld = kHalf ? kLdH : kLd;
      const XT* xs = reinterpret_cast<const XT*>(st + 2 * kQFloats) + row_a * ld + t;
      uint32_t ah[kKc / 8][4], al[kKc / 8][4];
#pragma unroll
      for (int k8 = 0; k8 < kKc / 8; ++k8) {
        const XT x[4] = {xs[k8 * 8], xs[k8 * 8 + 8 * ld], xs[k8 * 8 + 4],
                         xs[k8 * 8 + 8 * ld + 4]};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if constexpr (kHalf) ah[k8][f] = static_cast<uint32_t>(x[f]) << 16;
          else split_tf32(x[f], ah[k8][f], al[k8][f]);
        }
      }
      // The tensor cores truncate when they add into the accumulator, and a
      // chain over all of K lets that bias grow with the sum (measured 1e-6
      // of a cosine distance with mma.sync). A chunk's 12 (bf16: 8) products run into
      // an accumulator that the first of them overwrites, which the CUDA
      // cores then add, rounding to nearest.
      float part[64];
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < kKc / 8; ++k8) {
        const uint64_t qh = smem_desc(st, k8), ql = smem_desc(st + kQFloats, k8);
        if constexpr (kHalf) {
          wgmma_tf32(part, ah[k8], ql, k8 > 0);
        } else {
          wgmma_tf32(part, al[k8], qh, k8 > 0);
          wgmma_tf32(part, ah[k8], ql, 1);
        }
        wgmma_tf32(part, ah[k8], qh, 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[c] += part[c];
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is idle: its memory holds the survivors now

    // 3. epilogue: masked distances against the running k-th best
    int appended = 0;
    auto score = [&](float dot, int ql, int rl, float qn2, float th) {
      const float n2 = rownorm[rl];
      float dd;
      if (metric == 0) {
        dd = 1.f - dot * rsqrtf(fmaxf(qn2 * n2, 1e-30f));
        if (!(n2 * qn2 > 0.f)) dd = 1.f;
      } else {
        const float d2 = fmaxf(qn2 + n2 - 2.f * dot, 0.f);
        dd = metric == 1 ? sqrtf(d2) : d2;
      }
      if (dd <= th) {
        const int j = atomicAdd(&cnt[ql], 1);
        buf_d[ql * kR + j] = dd;
        buf_s[ql * kR + j] = static_cast<int>(r0) + rl;
        appended = 1;
      }
    };
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * t + e;
        const unsigned word = mask[ql * kWords + (row_a >> 5)] >> (row_a & 31);
        if ((word & 0x101u) == 0u) continue;
        const float qn2 = qn2s[ql], th = thr[ql];
        if (word & 1u) score(acc[4 * j + e], ql, row_a, qn2, th);
        if (word & 0x100u) score(acc[4 * j + 2 + e], ql, row_a + 8, qn2, th);
      }
    }
    if (!__syncthreads_or(appended)) continue;

    // fold each query's survivors into its running list: a short list by
    // one thread (all queries at once), a long one by a warp (fold_list)
    if (near) {
      const int n = tid < kQg ? cnt[tid] : 0;
      if (n > 0) {
        float* ld = near_d + tid * kNearLd;
        int* ls = near_s + tid * kNearLd;
        float wd = thr[tid];
        int ws = thr_s[tid], wi = thr_i[tid];
        for (int e = 0; e < n; ++e) {
          const float cd = buf_d[tid * kR + e];
          const int cs = buf_s[tid * kR + e];
          if (!before(cd, cs, wd, ws)) continue;
          ld[wi] = cd;
          ls[wi] = cs;
          wd = ld[0], ws = ls[0], wi = 0;
          for (int j = 1; j < k; ++j)
            if (before(wd, ws, ld[j], ls[j])) wd = ld[j], ws = ls[j], wi = j;
        }
        thr[tid] = wd;  // +inf until the list is full
        thr_s[tid] = ws;
        thr_i[tid] = wi;
        cnt[tid] = 0;
      }
    }
    // a long list lives in the partial output (L2): the lists of 8 queries
    // are loaded before the first is folded, so that their latencies overlap
    for (int h = 0; h < (near ? 0 : 16); h += 8) {
      float ld[8][kMaxK / 32];
      int ls[8][kMaxK / 32], n[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ql = warp * 16 + h + i;
        n[i] = cnt[ql];
        if (n[i] == 0) continue;
        const float* gd = list_d(ql);
        const int* gs = list_s(ql);
#pragma unroll
        for (int j = 0; j < kMaxK / 32; ++j) {
          const int idx = j * 32 + lane;
          ld[i][j] = idx < k ? gd[idx] : -INFINITY;  // never the worst
          ls[i][j] = idx < k ? gs[idx] : -1;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ql = warp * 16 + h + i;
        if (n[i] == 0) continue;
        const float worst =
            fold_list(ld[i], ls[i], buf_d + ql * kR, buf_s + ql * kR, n[i], lane);
        float* gd = list_d(ql);
        int* gs = list_s(ql);
#pragma unroll
        for (int j = 0; j < kMaxK / 32; ++j) {
          const int idx = j * 32 + lane;
          if (idx < k) {
            gd[idx] = ld[i][j];
            gs[idx] = ls[i][j];
          }
        }
        if (lane == 0) {
          thr[ql] = worst;  // +inf until the list is full
          cnt[ql] = 0;
        }
      }
    }
    __syncthreads();
  }

  if (near) {  // the lists leave shared memory (each lane wrote what it reads)
    for (int i = 0; i < 16; ++i) {
      const int ql = warp * 16 + i;
      if (q0 + ql < B && lane < k) {
        const long long at = (static_cast<long long>(q0 + ql) * nchunks + chunk) * k + lane;
        part_d[at] = near_d[ql * kNearLd + lane];
        part_s[at] = near_s[ql * kNearLd + lane];
      }
    }
  }
}

// The queries' TF32 parts, once per launch: out[0 .. n) the hi parts,
// out[n .. 2n) the lo parts (B operands come from shared memory, where
// nothing can split them on the way to the tensor cores).
__global__ void split_queries(const float* __restrict__ q, float* __restrict__ out,
                              long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t hi, lo;
    split_tf32(q[i], hi, lo);
    out[i] = __uint_as_float(hi);
    out[n + i] = __uint_as_float(lo);
  }
}

constexpr int kMergeThreads = 256;

__device__ __forceinline__ void warp_argmin(float& d, int& s, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int os = __shfl_xor_sync(0xffffffffu, s, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(od, os, d, s) || (od == d && os == s && oi < i)) d = od, s = os, i = oi;
  }
}

// One block per query: the k best of its nchunks * k partial entries by
// (distance, slot), then each winner's position in the candidate row.
__global__ void __launch_bounds__(kMergeThreads) lsh_rerank_slab_merge(
    const float* __restrict__ part_d, const int32_t* __restrict__ part_s, int n,
    const int32_t* __restrict__ cand, const float* __restrict__ valid, int M, int k,
    float* __restrict__ out_d, int32_t* __restrict__ out_p) {
  extern __shared__ float4 smem4[];
  float* sd = reinterpret_cast<float*>(smem4);
  int* ss = reinterpret_cast<int*>(sd + n);
  __shared__ float win_d[kMaxK];
  __shared__ int win_s[kMaxK];
  __shared__ float red_d[kMergeThreads / 32];
  __shared__ int red_s[kMergeThreads / 32], red_i[kMergeThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += kMergeThreads) {
    sd[i] = part_d[static_cast<long long>(b) * n + i];
    ss[i] = part_s[static_cast<long long>(b) * n + i];
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    float bd = INFINITY;
    int bs = INT_MAX, bi = INT_MAX;
    for (int i = tid; i < n; i += kMergeThreads)
      if (before(sd[i], ss[i], bd, bs)) bd = sd[i], bs = ss[i], bi = i;
    warp_argmin(bd, bs, bi);
    if (lane == 0) red_d[warp] = bd, red_s[warp] = bs, red_i[warp] = bi;
    __syncthreads();
    if (warp == 0) {
      const bool in = lane < kMergeThreads / 32;
      bd = in ? red_d[lane] : INFINITY;
      bs = in ? red_s[lane] : INT_MAX;
      bi = in ? red_i[lane] : INT_MAX;
      warp_argmin(bd, bs, bi);
      if (lane == 0) {
        win_d[r] = bd;
        win_s[r] = bs;
        if (bi != INT_MAX) sd[bi] = INFINITY, ss[bi] = INT_MAX;  // taken
      }
    }
    __syncthreads();
  }
  const int32_t* crow = cand + static_cast<long long>(b) * M;
  const float* vrow = valid + static_cast<long long>(b) * M;
  const bool tail_pads = has_tail_pads(crow, M);
  for (int i = tid; i < k; i += kMergeThreads) {
    const float d = win_d[i];
    int pos = -1;
    if (d < 3.0e38f) {
      // the first entry of the slot's run that is valid (a masked duplicate
      // may stand before it)
      pos = lower_bound(crow, M, tail_pads, win_s[i]);
      while (pos < M - 1 && !(__ldg(vrow + pos) > 0.f) && __ldg(crow + pos + 1) == win_s[i])
        ++pos;
    }
    out_d[static_cast<long long>(b) * k + i] = pos >= 0 ? d : INFINITY;
    out_p[static_cast<long long>(b) * k + i] = pos;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32 slab, 1 bf16 slab
// (raw 16-bit patterns). metric: 0 cosine, 1 l2, 2 sql2. The grid is ceil(B / 128) query groups x nchunks slab chunks
// of tiles_per_chunk tiles of 128 rows over the slab prefix [0, occupied);
// part_d / part_s are [B, nchunks, k] scratch, qsplit [2, B, D] (the queries'
// TF32 hi and lo parts). out_p holds candidate positions (-1 = missing).
// Launches the three kernels on `stream` and returns the first
// cudaGetLastError() that is not 0 (0 = all launched).
extern "C" int zt_lsh_rerank_slab(const void* vec, int dtype, long long S, int W,
                                  const float* q,
                                  float* qsplit, int D, const int32_t* cand,
                                  const float* norms,
                                  const float* valid, int B, int M, int k, int metric,
                                  long long occupied, int nchunks, int tiles_per_chunk,
                                  float* part_d, int32_t* part_s, float* out_d,
                                  int32_t* out_p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = reinterpret_cast<uintptr_t>(vec) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(qsplit) % 16 == 0 && W % 4 == 0 &&
                      D % 4 == 0;
  const long long nq = static_cast<long long>(B) * D;
  split_queries<<<static_cast<unsigned>((nq + 255) / 256), 256, 0, s>>>(q, qsplit, nq);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t smem = sizeof(float) * kStages * kStageFloats + 1024;  // alignment slack
  const dim3 grid((B + kQg - 1) / kQg, nchunks);
  auto launch = [&](auto kernel, auto* slab) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kernel<<<grid, kThreads, smem, s>>>(slab, S, W, q, qsplit, D, cand, norms, valid, B, M, k,
                                        metric, occupied, tiles_per_chunk, nchunks, part_d,
                                        part_s);
  };
  const float* f32 = static_cast<const float*>(vec);
  const uint16_t* b16 = static_cast<const uint16_t*>(vec);
  if (dtype == 1) {
    if (vec_ok) launch(lsh_rerank_slab_kernel<true, uint16_t>, b16);
    else launch(lsh_rerank_slab_kernel<false, uint16_t>, b16);
  } else {
    if (vec_ok) launch(lsh_rerank_slab_kernel<true, float>, f32);
    else launch(lsh_rerank_slab_kernel<false, float>, f32);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = nchunks * k;
  const size_t msmem = static_cast<size_t>(n) * 8;
  if (msmem > 48 * 1024)
    cudaFuncSetAttribute(lsh_rerank_slab_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(msmem));
  lsh_rerank_slab_merge<<<B, kMergeThreads, msmem, s>>>(part_d, part_s, n, cand, valid, M, k,
                                                        out_d, out_p);
  return static_cast<int>(cudaGetLastError());
}
