// Device helpers shared by the probe re-rank kernels (ivf_rerank.cu,
// ivf_rerank_wave.cu, ivf_rerank_aug.cu): warp reductions, 16-byte row
// chunk dots for the three slab element types, and the block-wide top-k
// selection. Every kernel runs one block of kThreads threads per query.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace zt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;       // widest top-k a kernel returns
constexpr float kBig = 3.0e38f;  // masked-candidate sentinel (pallas_ivf.BIG)

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

// Sum of v over the block, on every thread (all threads call it).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kWarps];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w];
  return s;
}

// f32 -> nearest-even bf16 -> f32 (finite inputs), the rounding of a cast
// to bfloat16
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// Slab element types. kVec = elements per 16-byte chunk; get() widens one
// element to f32; dot_chunk() adds <qv, the chunk at row + e> to acc with
// f32 FMAs (e is a multiple of kVec and the chunk 16-byte aligned).
struct ElemF32 {
  using T = float;
  static constexpr int kVec = 4;
  __device__ static float get(const T* row, int d) { return __ldg(row + d); }
  __device__ static float dot_chunk(const T* row, int e, const float (&qv)[kVec], float acc) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + e));
    acc = fmaf(qv[0], v.x, acc);
    acc = fmaf(qv[1], v.y, acc);
    acc = fmaf(qv[2], v.z, acc);
    return fmaf(qv[3], v.w, acc);
  }
};

// bf16 as raw 16-bit patterns: bf16 -> f32 is the pattern shifted into the
// high half
struct ElemBF16 {
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

// int8 codes, 4 packed little-endian in one 32-bit word
struct ElemI8 {
  using T = int8_t;
  static constexpr int kVec = 16;
  __device__ static float get(const T* row, int d) { return static_cast<float>(__ldg(row + d)); }
  __device__ static float quad(int w, float q0, float q1, float q2, float q3, float acc) {
    acc = fmaf(q0, static_cast<float>((w << 24) >> 24), acc);
    acc = fmaf(q1, static_cast<float>((w << 16) >> 24), acc);
    acc = fmaf(q2, static_cast<float>((w << 8) >> 24), acc);
    return fmaf(q3, static_cast<float>(w >> 24), acc);
  }
  __device__ static float dot_chunk(const T* row, int e, const float (&qv)[kVec], float acc) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + e));
    acc = quad(v.x, qv[0], qv[1], qv[2], qv[3], acc);
    acc = quad(v.y, qv[4], qv[5], qv[6], qv[7], acc);
    acc = quad(v.z, qv[8], qv[9], qv[10], qv[11], acc);
    return quad(v.w, qv[12], qv[13], qv[14], qv[15], acc);
  }
};

// One lane's share of <row[0..D), q>; warp_sum of it is the dot. NCH > 0:
// lane l owns the 16-byte chunks l + 32*i (i < NCH), whose slice of q it
// holds in `qr`; NCH == 0: any layout, one element per lane and step, q read
// from `qs`.
template <class E, int NCH>
__device__ __forceinline__ float lane_row_dot(const typename E::T* row, int D, int lane,
                                              const float (&qr)[(NCH > 0 ? NCH : 1)][E::kVec],
                                              const float* qs) {
  float acc = 0.f;
  if (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int e = (lane + 32 * i) * E::kVec;
      if (e < D) acc = E::dot_chunk(row, e, qr[i], acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], E::get(row, d), acc);
  }
  return acc;
}

// The lane's register slice of the query in shared memory (zeros past D),
// read as float4: `qs` is 16-byte aligned and D a multiple of kVec here.
template <class E, int NCH>
__device__ __forceinline__ void load_query_chunks(const float* qs, int D, int lane,
                                                  float (&qr)[(NCH > 0 ? NCH : 1)][E::kVec]) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int e = (lane + 32 * i) * E::kVec;
#pragma unroll
    for (int j = 0; j < E::kVec; j += 4) {
      const float4 v = e < D ? *reinterpret_cast<const float4*>(qs + e + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[i][j] = v.x;
      qr[i][j + 1] = v.y;
      qr[i][j + 2] = v.z;
      qr[i][j + 3] = v.w;
    }
  }
}

// The k smallest of dist[0..n) in order, by k block-wide (distance,
// position) argmin rounds; equal distances go to the lowest position. Round
// j leaves its pick in sel_d[j] / sel_p[j], or (+inf, -1) once nothing
// below kBig is left. dist is consumed; every thread of the block calls
// this, and the block is synchronised on return.
__device__ __forceinline__ void block_select(float* dist, int n, int k, float* sel_d, int* sel_p) {
  __shared__ float red_d[kWarps];
  __shared__ int red_p[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < k; ++j) {
    float bd = INFINITY;
    int bp = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
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
        if (bd < kBig) {
          sel_d[j] = bd;
          sel_p[j] = bp;
          dist[bp] = INFINITY;  // taken
        } else {
          sel_d[j] = INFINITY;
          sel_p[j] = -1;
        }
      }
    }
    __syncthreads();
  }
}

// Chunks per lane rounded up to an instantiated count, 0 = the element path.
// The 16-byte path needs an aligned slab, rows of whole chunks and at most
// 64 query floats per lane in registers.
template <class E>
inline int lane_chunks(const void* slab, int D, size_t row_elems) {
  if (reinterpret_cast<uintptr_t>(slab) % 16 != 0 ||
      (row_elems * sizeof(typename E::T)) % 16 != 0 || D % E::kVec != 0)
    return 0;
  const int nch = (D / E::kVec + 31) / 32;
  for (int c : {1, 2, 3, 4, 6, 8})
    if (nch <= c) return c * E::kVec <= 64 ? c : 0;
  return 0;
}

}  // namespace zt
