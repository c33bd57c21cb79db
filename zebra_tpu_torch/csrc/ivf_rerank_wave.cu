// One-slab IVF probe re-rank for Hopper (sm_90a): per query, score every
// live row of its P probed cluster blocks of ONE slab (int8 with scales,
// bf16 or f32; never the residual), build the distance from the stored norm
// and keep the top k. It is the coarse stage of the gather-refine query
// (refine=N): it keeps an oversampled k on the 1-byte slab and
// ivf._refine_topk re-scores those against the residual.
//
// Replaces zebra_tpu/ops/experimental_ivf.py::_kernel_factory_v2 (the
// "one-matmul wave" Pallas kernel, reached through
// pallas_ivf.ivf_rerank(..., wave=2) when ivf.query runs rerank="pallas2"),
// through the adapter zebra_tpu_torch/ops/experimental_ivf.py::ivf_rerank_wave.
//
// The TPU kernel scores a wave of Q queries against all Q fetched blocks in
// one [Q, D] x [D, Q*C] product and masks the off-diagonal blocks, to feed a
// 128 x 128 matrix unit from one core. That trick is not carried over: here
// a query's rows are only ever multiplied with that query.
//
// Bound: device-memory reads. A probed row costs D * itemsize bytes; rows
// past counts[c] and tombstoned rows are skipped before they are read, so a
// batch moves (live probed rows) * (D * itemsize + 9) bytes. At the refine=4
// defaults on 1M x 768 int8 (B=16384, P=4, C=128, ~45% live) that is ~2.9 GB,
// 0.87 ms at 3.35 TB/s. The design streams each row once with 16-byte
// coalesced loads (one warp per row; the lane's slice of the query lives in
// registers), keeps the P*C distances in shared memory and selects there, so
// only the [B, k] result is written. Each probed block is read once per
// query that probes it; reading it once for all its queries (a real
// [nq, D] x [D, C] product per block on the tensor cores) is later work.
//
// Contract (experimental_ivf.py:34-175, pallas_ivf.py:532-558):
//   q'     = the query rounded to bf16 on int8 / bf16 slabs (round_q), the
//            f32 query on f32 slabs; |q|^2 is taken from q'
//   dot    = <q', row> accumulated in f32, times scales[slot] on int8 slabs
//   cosine = 1 - dot * rsqrt(max(|q'|^2 n2, 1e-30)), and 1 where |q'|^2 n2 == 0
//   l2     = sqrt(max(|q'|^2 + n2 - 2 dot, 0)); sql2 the same without sqrt
//   invalid rows -> never selected; fewer than k live rows ->
//   (+inf, -1) tail; equal distances -> lowest position of the flattened
//   [P*C] probe axis; k <= 128; any P >= 1 (no even-P padding is needed).
// Row offsets are 64-bit: S*D passes 2^31 at 2M x 768 rows.

#include "rerank_common.cuh"

namespace {

using namespace zt;

template <class E, int NCH>
__global__ void __launch_bounds__(kThreads) ivf_rerank_wave_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ probes,
    const int32_t* __restrict__ counts, const typename E::T* __restrict__ vec,
    const float* __restrict__ scales, const float* __restrict__ norms,
    const uint8_t* __restrict__ valid, float* __restrict__ out_d,
    int64_t* __restrict__ out_s, int P, int C, int D, int k, int metric,
    int round_q) {
  extern __shared__ float4 smem4[];
  const int dpad = (D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);  // [dpad] the (rounded) query
  float* dist = qs + dpad;                      // [P*C] candidate distances
  __shared__ float sel_d[kMaxK];
  __shared__ int sel_p[kMaxK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + static_cast<int64_t>(b) * D;
  const int32_t* pb = probes + static_cast<int64_t>(b) * P;

  float part = 0.f;
  for (int d = tid; d < D; d += kThreads) {
    const float v = round_q ? round_bf16(qb[d]) : qb[d];
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
      float dot = warp_sum(lane_row_dot<E, NCH>(vec + slot * D, D, lane, qr, qs));
      if (lane == 0) {
        if (scales != nullptr) dot *= scales[slot];  // dequantise after the dot
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
  const float* scales;
  const float* norms;
  const uint8_t* valid;
  float* out_d;
  int64_t* out_s;
  int B, P, C, D, k, metric, round_q;
  cudaStream_t stream;
};

template <class E, int NCH>
void launch(const Args& a) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>((a.D + 3) & ~3) + static_cast<size_t>(a.P) * a.C);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ivf_rerank_wave_kernel<E, NCH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  ivf_rerank_wave_kernel<E, NCH><<<a.B, kThreads, smem, a.stream>>>(
      a.q, a.probes, a.counts, static_cast<const typename E::T*>(a.vec), a.scales, a.norms,
      a.valid, a.out_d, a.out_s, a.P, a.C, a.D, a.k, a.metric, a.round_q);
}

template <class E>
void dispatch(const Args& a) {
  switch (lane_chunks<E>(a.vec, a.D, a.D)) {
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
// (raw 16-bit patterns), 2 int8 slab (scales required). scales is null for
// f32 / bf16. metric: 0 cosine, 1 l2, 2 sql2. round_q: round the query to
// bf16 first. Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int zt_ivf_rerank_wave(const float* q, const int32_t* probes, const int32_t* counts,
                                  const void* vec, int dtype, const float* scales,
                                  const float* norms, const uint8_t* valid, float* out_d,
                                  int64_t* out_s, int B, int P, int C, int D, int k, int metric,
                                  int round_q, void* stream) {
  const Args a{q, probes, counts, vec, scales, norms, valid, out_d, out_s,
               B, P, C, D, k, metric, round_q, static_cast<cudaStream_t>(stream)};
  if (dtype == 2)
    dispatch<ElemI8>(a);
  else if (dtype == 1)
    dispatch<ElemBF16>(a);
  else
    dispatch<ElemF32>(a);
  return static_cast<int>(cudaGetLastError());
}
