// IVF probe re-rank for Hopper (sm_90a): per query, score every live row of
// its P probed cluster blocks, build the distance and keep the top k. The
// slab is int8 codes with per-row scales (plus the int8 residual slab when
// given), or bf16 / f32 values without scales.
//
// Replaces zebra_tpu/ops/pallas_ivf.py::_kernel_factory (the Pallas wave
// kernel) in every form it has: has_scales with and without the residual
// scan, and has_scales=False over bf16 / f32 slabs; reached through the
// adapter zebra_tpu_torch/ops/ivf_rerank.py::ivf_rerank.
//
// Bound: device-memory reads. Each probed row costs D * itemsize bytes per
// slab (int8: D, plus D more with the residual; bf16: 2D; f32: 4D), so a
// batch reads at most B*P*C*D*itemsize bytes; rows past counts[c] and
// tombstoned rows are skipped unread, so the real traffic is the occupied
// share of that. The design streams every row once with 16-byte coalesced
// loads (one warp per row, each lane a 16-byte chunk; the lane's slice of q
// lives in registers), keeps the P*C candidate distances in shared memory
// and selects the top k there with k block-wide (distance, position) argmin
// rounds, so nothing but the [B, k] result goes back to device memory. Each
// probed block is read once per query that probes it (the cluster-major
// redesign that reads it once for all its queries is later work).
//
// Contract (the adapter's, pallas_ivf.py:617-686):
//   dot    = scale*<q, v8> + rscale*<q, r8> on int8 slabs (the residual term
//            only with the residual slab), <q, v> on bf16 / f32 slabs
//            (f32 dots: the "highest" grade)
//   cosine = 1 - dot * rsqrt(max(|q|^2 n2, 1e-30)), and 1 where |q|^2 n2 == 0
//   l2     = sqrt(max(|q|^2 + n2 - 2 dot, 0)); sql2 the same without sqrt
//   invalid rows -> +inf with slot -1; equal distances -> lowest position of
//   the flattened [P*C] probe axis; k <= 128.
// Row offsets are 64-bit: S*D passes 2^31 at the 4M x 768 capacity scale.

#include <type_traits>

#include "rerank_common.cuh"

namespace {

using namespace zt;

// E: the slab element type; int8 codes carry scales (and may carry the
// residual), bf16 / f32 rows are values. NCH > 0: lane l owns the 16-byte
// chunks l + 32*i (i < NCH) and loads them whole (see rerank_common.cuh).
// NCH == 0: any D, element loads.
template <class E, int NCH>
__global__ void __launch_bounds__(kThreads) ivf_rerank_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ probes,
    const int32_t* __restrict__ counts, const typename E::T* __restrict__ vec,
    const int8_t* __restrict__ res, const float* __restrict__ scales,
    const float* __restrict__ rscales, const float* __restrict__ norms,
    const uint8_t* __restrict__ valid, float* __restrict__ out_d,
    int64_t* __restrict__ out_s, int P, int C, int D, int k, int metric) {
  constexpr bool kCodes = std::is_same_v<E, ElemI8>;
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

  float qr[NCH > 0 ? NCH : 1][E::kVec];
  load_query_chunks<E, NCH>(qs, D, lane, qr);

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
      const typename E::T* vrow = vec + slot * D;
      float hi = 0.f, lo = 0.f;
      if constexpr (!kCodes) {
        hi = lane_row_dot<E, NCH>(vrow, D, lane, qr, qs);
      } else if constexpr (NCH > 0) {
        const int8_t* rrow = res != nullptr ? res + slot * D : nullptr;
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
        if (res != nullptr) lo = lane_row_dot<ElemI8, 0>(res + slot * D, D, lane, qr, qs);
      }
      hi = warp_sum(hi);
      if constexpr (kCodes) lo = warp_sum(lo);
      if (lane == 0) {
        float dot = hi;
        if constexpr (kCodes) {
          // dequantise after the dot: <q, s*v8 + r*r8> = s<q,v8> + r<q,r8>
          dot *= scales[slot];
          if (res != nullptr) dot += lo * rscales[slot];
        }
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

struct Args {
  const float* q;
  const int32_t* probes;
  const int32_t* counts;
  const void* vec;
  const int8_t* res;
  const float* scales;
  const float* rscales;
  const float* norms;
  const uint8_t* valid;
  float* out_d;
  int64_t* out_s;
  int B, P, C, D, k, metric;
  cudaStream_t stream;
};

template <class E, int NCH>
void launch(const Args& a) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(a.D) + static_cast<size_t>(a.P) * a.C);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ivf_rerank_kernel<E, NCH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  ivf_rerank_kernel<E, NCH><<<a.B, kThreads, smem, a.stream>>>(
      a.q, a.probes, a.counts, static_cast<const typename E::T*>(a.vec), a.res, a.scales,
      a.rscales, a.norms, a.valid, a.out_d, a.out_s, a.P, a.C, a.D, a.k, a.metric);
}

// The chunk count lane_chunks picks (6 and 8 occur for bf16 / f32 rows: f32
// at D=768 is 192 chunks, 6 a lane); a residual slab that cannot take the
// codes' count sends both to the element path.
template <class E>
void dispatch(const Args& a) {
  int nch = lane_chunks<E>(a.vec, a.D, a.D);
  if (a.res != nullptr && lane_chunks<ElemI8>(a.res, a.D, a.D) != nch) nch = 0;
  switch (nch) {
    case 1: launch<E, 1>(a); break;
    case 2: launch<E, 2>(a); break;
    case 3: launch<E, 3>(a); break;
    case 4: launch<E, 4>(a); break;
    case 6: if constexpr (E::kVec <= 8) launch<E, 6>(a); break;
    case 8: if constexpr (E::kVec <= 8) launch<E, 8>(a); break;
    default: launch<E, 0>(a); break;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32 slab, 1 bf16 slab
// (raw 16-bit patterns), 2 int8 slab (scales required). res/rscales may be
// null (no residual slab; always null for f32 / bf16), scales is null for
// f32 / bf16. metric: 0 cosine, 1 l2, 2 sql2. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int zt_ivf_rerank(const float* q, const int32_t* probes,
                             const int32_t* counts, const void* vec, int dtype,
                             const int8_t* res, const float* scales,
                             const float* rscales, const float* norms,
                             const uint8_t* valid, float* out_d, int64_t* out_s,
                             int B, int P, int C, int D, int k, int metric,
                             void* stream) {
  const Args a{q, probes, counts, vec, res, scales, rscales, norms, valid, out_d, out_s,
               B, P, C, D, k, metric, static_cast<cudaStream_t>(stream)};
  if (dtype == 2)
    dispatch<ElemI8>(a);
  else if (dtype == 1)
    dispatch<ElemBF16>(a);
  else
    dispatch<ElemF32>(a);
  return static_cast<int>(cudaGetLastError());
}
