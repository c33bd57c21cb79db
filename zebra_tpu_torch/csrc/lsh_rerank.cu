// LSH candidate re-rank for Hopper (sm_90a), gather form: per query, gather
// its M candidate slab rows by slot, take full-f32 dots with the query, build
// the distance from the stored squared norm and keep the top k. The wrapper
// launches it for sparse or unsorted candidates and for bf16 slabs; sorted
// rows that hold a large share of the slab go to csrc/lsh_rerank_slab.cu.
//
// Replaces zebra_tpu/ops/pallas_rerank.py:48 (_kernel_factory, the Pallas
// fused gather + distance + top-k kernel), reached through the wrapper
// zebra_tpu_torch/ops/lsh_rerank.py::lsh_rerank.
//
// Bound: device-memory reads of a random-row gather. A query reads its M
// validity flags (4 bytes each) and, for each VALID candidate (live, unique,
// not a pad), its slot and norm (8 bytes) and D * itemsize bytes of its row;
// the rows of invalid candidates are never read. A batch therefore moves
// B*M*4 + (valid candidates) * (8 + D*itemsize) bytes. A row is 3 KB at f32,
// D=768: whole 128-byte lines at a random address, so the gather can run
// near streaming bandwidth once enough rows are in flight. On the LSH
// defaults at 1M x 768 f32 (1024 queries, M = 312,320 compacted candidates,
// ~201,858 valid each) that is 1.3 GB of flags and 0.64 TB of rows: 190 ms
// at 3.35 TB/s. That traffic is this form's own floor, not the work's: the
// 0.64 TB are 999,900 distinct rows (3.1 GB) read ~200 times each, which is
// why such batches take the slab-major form and this one keeps the batches
// whose rows are mostly read once.
//
// Design: one block (256 threads, 8 warps) per query. The query sits in
// shared memory and, on the vector path, in each lane's registers (the
// 16-byte chunks the lane owns). Candidates are walked in tiles of 2048:
//   1. the block reads the tile's validity flags coalesced and compacts the
//      valid positions, with their slots and norms, into shared memory;
//   2. warps take one valid row each: each lane loads 16-byte chunks
//      (float4, or 8 bf16), the dot reduces by warp shuffle, and lane 0
//      builds the distance and keeps it only if it beats the current k-th
//      best (an equal distance loses: the earlier position wins the tie);
//   3. if any did, min(#, k) block-wide (distance, position) argmin rounds
//      pull the tile's winners in order and a rank merge folds them into the
//      running top-k (<= 128 entries in shared memory).
// M never has to fit in shared memory (65,536 candidates are 256 KB of
// distances), and a tile whose candidates all lose costs no selection round.
//
// Contract (pallas_rerank.py:160-227):
//   cosine = 1 - dot * rsqrt(max(|q|^2 n2, 1e-30)), and 1 where |q|^2 n2 == 0
//   l2 = sqrt(max(|q|^2 + n2 - 2 dot, 0)); sql2 the same without the sqrt
//   valid == 0 -> never selected; fewer than k valid -> (+inf, -1) tail;
//   equal distances -> the lowest candidate position; k <= 128; any M >= 1;
//   slab rows have stride W >= D and only their first D columns are read.
// Row offsets are 64-bit: S*W passes 2^31 at 1M x 768 (a 2M-row slab).

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;  // candidates per tile
constexpr int kMaxK = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (d, p) orders before (bd, bp): smaller distance, then lower position
__device__ __forceinline__ bool before(float d, int p, float bd, int bp) {
  return d < bd || (d == bd && p < bp);
}

__device__ __forceinline__ void warp_argmin(float& d, int& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int op = __shfl_xor_sync(0xffffffffu, p, o);
    if (before(od, op, d, p)) {
      d = od;
      p = op;
    }
  }
}

// Slab element access: f32, or bf16 as raw 16-bit patterns (bf16 -> f32 is
// the bit pattern shifted into the high half).
template <bool BF16>
struct Elem;

template <>
struct Elem<false> {
  using T = float;
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  __device__ static float get(const T* row, int d) { return __ldg(row + d); }
  __device__ static float dot_chunk(const T* row, int e, const float (&qv)[kVec], float acc) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + e));
    acc = fmaf(qv[0], v.x, acc);
    acc = fmaf(qv[1], v.y, acc);
    acc = fmaf(qv[2], v.z, acc);
    return fmaf(qv[3], v.w, acc);
  }
};

template <>
struct Elem<true> {
  using T = uint16_t;
  static constexpr int kVec = 8;
  __device__ static float get(const T* row, int d) {
    return __uint_as_float(static_cast<unsigned>(__ldg(row + d)) << 16);
  }
  __device__ static float pair(unsigned w, float q0, float q1, float acc) {
    acc = fmaf(q0, __uint_as_float(w << 16), acc);
    return fmaf(q1, __uint_as_float(w & 0xffff0000u), acc);
  }
  __device__ static float dot_chunk(const T* row, int e, const float (&qv)[kVec], float acc) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + e));
    acc = pair(v.x, qv[0], qv[1], acc);
    acc = pair(v.y, qv[2], qv[3], acc);
    acc = pair(v.z, qv[4], qv[5], acc);
    return pair(v.w, qv[6], qv[7], acc);
  }
};

// NCH > 0: 16-byte chunk loads; lane l owns chunks l + 32*i (i < NCH), which
// needs D % kVec == 0, a 16-byte aligned slab and a row stride of whole
// 16-byte chunks. NCH == 0: any layout, one element per lane and step.
template <bool BF16, int NCH>
__global__ void __launch_bounds__(kThreads) lsh_rerank_kernel(
    const typename Elem<BF16>::T* __restrict__ vec, long long S, int W,
    const float* __restrict__ q, int D, const int32_t* __restrict__ cand,
    const float* __restrict__ norms, const float* __restrict__ valid, int M,
    int k, int metric, float* __restrict__ out_d, int32_t* __restrict__ out_p) {
  using E = Elem<BF16>;
  constexpr int V = E::kVec;
  extern __shared__ float4 smem4[];
  const int dpad = (D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);  // [dpad] the query
  float* dist = qs + dpad;                      // [kTile] tile distances
  float* lnorm = dist + kTile;                  // [kTile] valid: norms
  int* lpos = reinterpret_cast<int*>(lnorm + kTile);  // valid: tile positions
  int* lslot = lpos + kTile;                    // [kTile] valid: slab slots
  __shared__ float top_d[kMaxK], new_d[kMaxK], win_d[kMaxK];
  __shared__ int top_p[kMaxK], new_p[kMaxK], win_p[kMaxK];
  __shared__ float red_d[kWarps];
  __shared__ int red_p[kWarps];
  __shared__ int n_live, n_win;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + static_cast<long long>(b) * D;
  const long long base = static_cast<long long>(b) * M;

  float part = 0.f;
  for (int d = tid; d < D; d += kThreads) {
    const float v = qb[d];
    qs[d] = v;
    part = fmaf(v, v, part);
  }
  part = warp_sum(part);
  if (lane == 0) red_d[warp] = part;
  for (int i = tid; i < k; i += kThreads) {
    top_d[i] = INFINITY;
    top_p[i] = INT_MAX;
  }
  __syncthreads();
  float qn2 = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) qn2 += red_d[w];

  float qr[NCH > 0 ? NCH : 1][V];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = (lane + 32 * i) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) qr[i][j] = e < D ? qs[e + j] : 0.f;
  }

  float thr = INFINITY;  // the k-th best so far: a candidate must beat it
  for (int t0 = 0; t0 < M; t0 += kTile) {
    const int tn = min(kTile, M - t0);
    if (tid == 0) {
      n_live = 0;
      n_win = 0;
    }
    __syncthreads();
    // 1. compact the tile's valid candidates (coalesced flag reads)
    for (int i = tid; i < kTile; i += kThreads) {
      dist[i] = INFINITY;
      if (i < tn && valid[base + t0 + i] > 0.f) {
        const int j = atomicAdd(&n_live, 1);
        lpos[j] = i;
        lslot[j] = cand[base + t0 + i];
        lnorm[j] = norms[base + t0 + i];
      }
    }
    __syncthreads();
    // 2. one warp per valid row: dot, distance, threshold
    const int nl = n_live;
    for (int j = warp; j < nl; j += kWarps) {
      const long long slot = min(max(static_cast<long long>(lslot[j]), 0LL), S - 1);
      const typename E::T* row = vec + slot * W;
      float acc = 0.f;
      if (NCH > 0) {
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int e = (lane + 32 * i) * V;
          if (e < D) acc = E::dot_chunk(row, e, qr[i], acc);
        }
      } else {
        for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], E::get(row, d), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        const float n2 = lnorm[j];
        float dd;
        if (metric == 0) {
          dd = 1.f - acc * rsqrtf(fmaxf(qn2 * n2, 1e-30f));
          if (!(n2 * qn2 > 0.f)) dd = 1.f;
        } else {
          const float d2 = fmaxf(qn2 + n2 - 2.f * acc, 0.f);
          dd = metric == 1 ? sqrtf(d2) : d2;
        }
        if (dd < thr) {
          dist[lpos[j]] = dd;
          atomicAdd(&n_win, 1);
        }
      }
    }
    __syncthreads();
    // 3. the tile's winners in order, merged into the running top-k
    const int rounds = min(n_win, k);
    if (rounds > 0) {
      for (int r = 0; r < rounds; ++r) {
        float bd = INFINITY;
        int bp = INT_MAX;
        for (int i = tid; i < tn; i += kThreads) {
          const float v = dist[i];
          if (before(v, i, bd, bp)) {
            bd = v;
            bp = i;
          }
        }
        warp_argmin(bd, bp);
        if (lane == 0) {
          red_d[warp] = bd;
          red_p[warp] = bp;
        }
        __syncthreads();
        if (warp == 0) {
          bd = lane < kWarps ? red_d[lane] : INFINITY;
          bp = lane < kWarps ? red_p[lane] : INT_MAX;
          warp_argmin(bd, bp);
          if (lane == 0) {
            win_d[r] = bd;
            win_p[r] = t0 + bp;
            dist[bp] = INFINITY;  // taken
          }
        }
        __syncthreads();
      }
      // rank merge of two sorted lists: every (d, p) pair is distinct
      // except the empty (inf, INT_MAX) tail of top, which keeps its order
      for (int i = tid; i < k + rounds; i += kThreads) {
        float d;
        int p, rank;
        if (i < k) {
          d = top_d[i];
          p = top_p[i];
          rank = i;
          for (int j = 0; j < rounds; ++j) rank += before(win_d[j], win_p[j], d, p);
        } else {
          d = win_d[i - k];
          p = win_p[i - k];
          rank = i - k;
          for (int o = 0; o < k; ++o) rank += before(top_d[o], top_p[o], d, p);
        }
        if (rank < k) {
          new_d[rank] = d;
          new_p[rank] = p;
        }
      }
      __syncthreads();
      for (int i = tid; i < k; i += kThreads) {
        top_d[i] = new_d[i];
        top_p[i] = new_p[i];
      }
      __syncthreads();
      thr = top_d[k - 1];
    }
    __syncthreads();  // counters and distances are reset next tile
  }

  for (int i = tid; i < k; i += kThreads) {
    const long long o = static_cast<long long>(b) * k + i;
    const bool ok = top_d[i] < 3.0e38f;
    out_d[o] = ok ? top_d[i] : INFINITY;
    out_p[o] = ok ? top_p[i] : -1;
  }
}

template <bool BF16, int NCH>
void launch(int B, cudaStream_t stream, const void* vec, long long S, int W,
            const float* q, int D, const int32_t* cand, const float* norms,
            const float* valid, int M, int k, int metric, float* out_d,
            int32_t* out_p) {
  const size_t smem = sizeof(float) * (static_cast<size_t>((D + 3) & ~3) + 4 * kTile);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(lsh_rerank_kernel<BF16, NCH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  lsh_rerank_kernel<BF16, NCH><<<B, kThreads, smem, stream>>>(
      static_cast<const typename Elem<BF16>::T*>(vec), S, W, q, D, cand, norms,
      valid, M, k, metric, out_d, out_p);
}

// chunks per lane, rounded up to an instantiated count (0 = element path)
int lane_chunks(int D, int vec_elems, int max_nch) {
  const int nch = (D / vec_elems + 31) / 32;
  for (int c : {1, 2, 3, 4, 6, 8, 12, 16})
    if (nch <= c) return c <= max_nch ? c : 0;
  return 0;
}

template <bool BF16>
void dispatch(int nch, int B, cudaStream_t s, const void* vec, long long S,
              int W, const float* q, int D, const int32_t* cand,
              const float* norms, const float* valid, int M, int k, int metric,
              float* out_d, int32_t* out_p) {
#define ZT_LAUNCH(N)                                                         \
  launch<BF16, N>(B, s, vec, S, W, q, D, cand, norms, valid, M, k, metric, \
                  out_d, out_p)
  switch (nch) {
    case 1: ZT_LAUNCH(1); break;
    case 2: ZT_LAUNCH(2); break;
    case 3: ZT_LAUNCH(3); break;
    case 4: ZT_LAUNCH(4); break;
    case 6: ZT_LAUNCH(6); break;
    case 8: ZT_LAUNCH(8); break;
    case 12: if constexpr (!BF16) ZT_LAUNCH(12); break;
    case 16: if constexpr (!BF16) ZT_LAUNCH(16); break;
    default: ZT_LAUNCH(0); break;
  }
#undef ZT_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32 slab, 1 bf16 slab
// (raw 16-bit patterns). metric: 0 cosine, 1 l2, 2 sql2. out_p holds
// candidate positions (-1 = missing). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int zt_lsh_rerank(const void* vec, int dtype, long long S, int W,
                             const float* q, int D, const int32_t* cand,
                             const float* norms, const float* valid, int B,
                             int M, int k, int metric, float* out_d,
                             int32_t* out_p, void* stream) {
  const bool bf16 = dtype == 1;
  const int vec_elems = bf16 ? 8 : 4;
  const size_t item = bf16 ? 2 : 4;
  const bool vec_ok = reinterpret_cast<uintptr_t>(vec) % 16 == 0 &&
                      (static_cast<size_t>(W) * item) % 16 == 0 && D % vec_elems == 0;
  // at most 64 query floats per lane in registers: D <= 2048 either way
  const int nch = vec_ok ? lane_chunks(D, vec_elems, bf16 ? 8 : 16) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch<true>(nch, B, s, vec, S, W, q, D, cand, norms, valid, M, k, metric, out_d, out_p);
  else
    dispatch<false>(nch, B, s, vec, S, W, q, D, cand, norms, valid, M, k, metric, out_d, out_p);
  return static_cast<int>(cudaGetLastError());
}
