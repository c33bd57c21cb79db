// IVF probe re-rank for Hopper (sm_90a): per query, score every live row of
// its P probed cluster blocks against the int8 slab (plus the int8 residual
// slab when given), build the distance and keep the top k.
//
// Replaces zebra_tpu/ops/pallas_ivf.py::_kernel_factory (the Pallas wave
// kernel, residual-scan form), reached through the adapter
// zebra_tpu_torch/ops/ivf_rerank.py::ivf_rerank.
//
// Bound: device-memory reads. Each probed row costs D bytes of codes per slab
// (2 bytes per element with the residual), so a batch reads at most
// B*P*C*D*2 bytes; rows past counts[c] and tombstoned rows are skipped, so
// the real traffic is the occupied share of that. The design streams every
// row once with 16-byte coalesced loads (one warp per row, each lane a
// 16-byte chunk; the lane's slice of q lives in registers), keeps the P*C
// candidate distances in shared memory and selects the top k there with k
// block-wide (distance, position) argmin rounds, so nothing but the [B, k]
// result goes back to device memory.
//
// Contract (the adapter's, pallas_ivf.py:617-686):
//   dot    = scale*<q, v8> + rscale*<q, r8>    (f32 dots: the "highest" grade)
//   cosine = 1 - dot * rsqrt(max(|q|^2 n2, 1e-30)), and 1 where |q|^2 n2 == 0
//   l2     = sqrt(max(|q|^2 + n2 - 2 dot, 0)); sql2 the same without sqrt
//   invalid rows -> +inf with slot -1; equal distances -> lowest position of
//   the flattened [P*C] probe axis; k <= 128.
// Row offsets are 64-bit: S*D passes 2^31 at the 4M x 768 capacity scale.

#include "rerank_common.cuh"

namespace {

using namespace zt;

// NCH > 0: lane l owns the 16-element chunks l + 32*i (i < NCH) and loads
// them as int4 (see rerank_common.cuh). NCH == 0: any D, byte loads.
template <int NCH>
__global__ void __launch_bounds__(kThreads) ivf_rerank_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ probes,
    const int32_t* __restrict__ counts, const int8_t* __restrict__ vec,
    const int8_t* __restrict__ res, const float* __restrict__ scales,
    const float* __restrict__ rscales, const float* __restrict__ norms,
    const uint8_t* __restrict__ valid, float* __restrict__ out_d,
    int64_t* __restrict__ out_s, int P, int C, int D, int k, int metric) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D] the query
  float* dist = qs + D;                         // [P*C] candidate distances
  __shared__ float sel_d[kMaxK];
  __shared__ int sel_p[kMaxK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + static_cast<int64_t>(b) * D;
  const int32_t* pb = probes + static_cast<int64_t>(b) * P;

  float part = 0.f;
  for (int d = tid; d < D; d += kThreads) {
    const float v = qb[d];
    qs[d] = v;
    part = fmaf(v, v, part);
  }
  const float qn2 = block_sum(part);

  float qr[NCH > 0 ? NCH : 1][ElemI8::kVec];
  load_query_chunks<ElemI8, NCH>(qs, D, lane, qr);

  for (int p = 0; p < P; ++p) {
    const int c = pb[p];
    const int cnt = min(max(counts[c], 0), C);
    for (int r = warp; r < C; r += kWarps) {
      const int pos = p * C + r;
      const int64_t slot = static_cast<int64_t>(c) * C + r;
      // rows past the occupied prefix are invalid by construction
      if (r >= cnt || valid[slot] == 0) {
        if (lane == 0) dist[pos] = kBig;
        continue;
      }
      const int8_t* vrow = vec + slot * D;
      const int8_t* rrow = res != nullptr ? res + slot * D : nullptr;
      float hi = 0.f, lo = 0.f;
      if constexpr (NCH > 0) {
        // the two slabs' chunks load side by side: twice the bytes in flight
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int e = (lane + 32 * i) * ElemI8::kVec;
          if (e < D) {
            hi = ElemI8::dot_chunk(vrow, e, qr[i], hi);
            if (rrow != nullptr) lo = ElemI8::dot_chunk(rrow, e, qr[i], lo);
          }
        }
      } else {
        hi = lane_row_dot<ElemI8, 0>(vrow, D, lane, qr, qs);
        if (rrow != nullptr) lo = lane_row_dot<ElemI8, 0>(rrow, D, lane, qr, qs);
      }
      hi = warp_sum(hi);
      lo = warp_sum(lo);
      if (lane == 0) {
        // dequantise after the dot: <q, s*v8 + r*r8> = s<q,v8> + r<q,r8>
        float dot = hi * scales[slot];
        if (res != nullptr) dot += lo * rscales[slot];
        const float n2 = norms[slot];
        float d;
        if (metric == 0) {
          d = 1.f - dot * rsqrtf(fmaxf(qn2 * n2, 1e-30f));
          if (!(n2 * qn2 > 0.f)) d = 1.f;
        } else {
          const float d2 = fmaxf(qn2 + n2 - 2.f * dot, 0.f);
          d = metric == 1 ? sqrtf(d2) : d2;
        }
        dist[pos] = d;
      }
    }
  }
  __syncthreads();

  block_select(dist, P * C, k, sel_d, sel_p);
  for (int j = tid; j < k; j += kThreads) {
    const int64_t o = static_cast<int64_t>(b) * k + j;
    const int bp = sel_p[j];
    out_d[o] = sel_d[j];
    out_s[o] = bp < 0 ? -1 : static_cast<int64_t>(pb[bp / C]) * C + bp % C;
  }
}

template <int NCH>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const float* q,
            const int32_t* probes, const int32_t* counts, const int8_t* vec,
            const int8_t* res, const float* scales, const float* rscales,
            const float* norms, const uint8_t* valid, float* out_d,
            int64_t* out_s, int P, int C, int D, int k, int metric) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ivf_rerank_kernel<NCH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  ivf_rerank_kernel<NCH><<<grid, kThreads, smem, stream>>>(
      q, probes, counts, vec, res, scales, rscales, norms, valid, out_d, out_s,
      P, C, D, k, metric);
}

}  // namespace

// Plain C entry point (loaded with ctypes). res/rscales may be null (no
// residual slab). metric: 0 cosine, 1 l2, 2 sql2. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int zt_ivf_rerank(const float* q, const int32_t* probes,
                             const int32_t* counts, const int8_t* vec,
                             const int8_t* res, const float* scales,
                             const float* rscales, const float* norms,
                             const uint8_t* valid, float* out_d, int64_t* out_s,
                             int B, int P, int C, int D, int k, int metric,
                             void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) + static_cast<size_t>(P) * C);
  int nch = lane_chunks<ElemI8>(vec, D, D);
  if (res != nullptr && lane_chunks<ElemI8>(res, D, D) != nch) nch = 0;
  const dim3 grid(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZT_LAUNCH(N)                                                          \
  launch<N>(grid, smem, s, q, probes, counts, vec, res, scales, rscales,      \
            norms, valid, out_d, out_s, P, C, D, k, metric)
  switch (nch) {
    case 1: ZT_LAUNCH(1); break;
    case 2: ZT_LAUNCH(2); break;
    case 3: ZT_LAUNCH(3); break;
    case 4: ZT_LAUNCH(4); break;
    default: ZT_LAUNCH(0); break;
  }
#undef ZT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
