// Augmented-slab IVF probe re-rank for Hopper (sm_90a): per query, ONE dot
// of its pre-transformed query w [D + 128] with every row of its P probed
// [C, D + 128] blocks, a clamp, and the top k. The rows carry their own
// epilogue in the 128 extra lanes (a dead-row penalty and the split squared
// norm, see experimental_ivf.augment_slab), so no norms, validity flags or
// scales are read.
//
// Replaces zebra_tpu/ops/experimental_ivf.py::_kernel_factory_v3 (the
// aux-free Pallas wave kernel, called at experimental_ivf.py:332), through
// zebra_tpu_torch/ops/experimental_ivf.py::rerank_aug_raw and its adapter
// ivf_rerank_aug.
//
// Bound: device-memory reads of whole blocks. Liveness is inside the row,
// so every one of the B*P*C probed rows is read in full, all D + 128 stored
// lanes of it (lanes past D + 2 hold zeros, but the contract is to rank the
// slab as stored): B*P*C*(D + 128)*itemsize bytes, 0.94 GB = 0.28 ms at
// 3.35 TB/s for B=1024, P=4, C=128, D=768 in bf16. One warp per row with
// 16-byte coalesced loads; the lane's slice of w lives in registers; the P*C
// values stay in shared memory and are selected there.
//
// Contract (experimental_ivf.py:178-360):
//   exact: f32 w, rows widened to f32, f32 accumulation; otherwise w is
//   first rounded to the slab's type (round_w on a bf16 slab; bf16 x bf16
//   products are exact in f32) and accumulated in f32
//   d = min(<w, row>, BIG): a dead row carries PEN = 3.2e38 in lane D and w
//   has 1 there, so its finite sum clamps to BIG and an overflow to +inf
//   clamps to BIG too; a lane's partial sums hold at most one PEN, so no
//   inf - inf arises
//   value BIG -> never selected; fewer than k live rows -> (+inf, -1) tail;
//   equal values -> lowest position of the flattened [P*C] probe axis;
//   k <= 128; out_p holds positions on that axis.
// Row offsets are 64-bit: S*(D + 128) passes 2^31 at 2M x 896 rows.

#include "rerank_common.cuh"

namespace {

using namespace zt;

template <class E, int NCH>
__global__ void __launch_bounds__(kThreads) ivf_rerank_aug_kernel(
    const float* __restrict__ w, const int32_t* __restrict__ probes,
    const typename E::T* __restrict__ vec, float* __restrict__ out_d,
    int32_t* __restrict__ out_p, int P, int C, int Da, int k, int round_w) {
  extern __shared__ float4 smem4[];
  const int dpad = (Da + 3) & ~3;
  float* ws = reinterpret_cast<float*>(smem4);  // [dpad] the transformed query
  float* dist = ws + dpad;                      // [P*C] raw values
  __shared__ float sel_d[kMaxK];
  __shared__ int sel_p[kMaxK];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* wb = w + static_cast<int64_t>(b) * Da;
  const int32_t* pb = probes + static_cast<int64_t>(b) * P;

  for (int d = tid; d < Da; d += kThreads) ws[d] = round_w ? round_bf16(wb[d]) : wb[d];
  __syncthreads();

  float wr[NCH > 0 ? NCH : 1][E::kVec];
  load_query_chunks<E, NCH>(ws, Da, lane, wr);

  for (int p = 0; p < P; ++p) {
    const typename E::T* block = vec + static_cast<int64_t>(pb[p]) * C * Da;
    for (int r = warp; r < C; r += kWarps) {
      const float dot = warp_sum(
          lane_row_dot<E, NCH>(block + static_cast<int64_t>(r) * Da, Da, lane, wr, ws));
      if (lane == 0) dist[p * C + r] = fminf(dot, kBig);
    }
  }
  __syncthreads();

  block_select(dist, P * C, k, sel_d, sel_p);
  for (int j = tid; j < k; j += kThreads) {
    const int64_t o = static_cast<int64_t>(b) * k + j;
    out_d[o] = sel_d[j];
    out_p[o] = sel_p[j];
  }
}

struct Args {
  const float* w;
  const int32_t* probes;
  const void* vec;
  float* out_d;
  int32_t* out_p;
  int B, P, C, Da, k, round_w;
  cudaStream_t stream;
};

template <class E, int NCH>
void launch(const Args& a) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>((a.Da + 3) & ~3) + static_cast<size_t>(a.P) * a.C);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ivf_rerank_aug_kernel<E, NCH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  ivf_rerank_aug_kernel<E, NCH><<<a.B, kThreads, smem, a.stream>>>(
      a.w, a.probes, static_cast<const typename E::T*>(a.vec), a.out_d, a.out_p, a.P, a.C,
      a.Da, a.k, a.round_w);
}

template <class E>
void dispatch(const Args& a) {
  switch (lane_chunks<E>(a.vec, a.Da, a.Da)) {
    case 1: launch<E, 1>(a); break;
    case 2: launch<E, 2>(a); break;
    case 3: launch<E, 3>(a); break;
    case 4: launch<E, 4>(a); break;
    case 6: launch<E, 6>(a); break;
    case 8: launch<E, 8>(a); break;
    default: launch<E, 0>(a); break;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 f32 slab, 1 bf16 slab
// (raw 16-bit patterns). round_w: round w to bf16 first (the one-pass form on
// a bf16 slab). Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int zt_ivf_rerank_aug(const float* w, const int32_t* probes, const void* vec,
                                 int dtype, float* out_d, int32_t* out_p, int B, int P, int C,
                                 int Da, int k, int round_w, void* stream) {
  const Args a{w, probes, vec, out_d, out_p, B, P, C, Da, k, round_w,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1)
    dispatch<ElemBF16>(a);
  else
    dispatch<ElemF32>(a);
  return static_cast<int>(cudaGetLastError());
}
