// Host-side int8 pair quantisation for the refined wire (the port's own copy
// of zebra_tpu/native/zebra_quant.cpp; the kernel below is unchanged).
//
// Mirrors zebra_tpu_torch.index.ivf.quantise_pair_host's contract BITWISE:
//   scale  = absmax > 0 ? absmax * (1.0f/127.0f) : 1.0f
//   v8     = clip(rint(x / scale), -127, 127)          (f32 divide, half-even)
//   res    = fmaf(-v8, scale, x)                       (single-rounded FMA ==
//            the f64-emulated residual the numpy fallback computes: the f64
//            product and difference are exact, so the one f32 rounding IS the
//            fused rounding; fmaf is correctly rounded by IEEE 754 either way)
//   rscale = rabsmax > 0 ? rabsmax * (1.0f/127.0f) : 1.0f
//   r8     = clip(rint(res / rscale), -127, 127)
//
// Why native: the refined int8 tier quantises every inserted vector on the
// host before the wire (index/ivf_host.py _quant_wire). The numpy fallback
// walks full-array f32/f64 passes per span; this kernel streams each row
// through L1 in three passes and threads over row blocks when cores exist.
// Round-half-even matches np.rint (default FE_TONEAREST).

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

inline int8_t quantise_one(float v, float s) {
    float q = nearbyintf(v / s);
    if (q > 127.0f) q = 127.0f;
    if (q < -127.0f) q = -127.0f;
    return static_cast<int8_t>(q);
}

void quantise_rows(const float* x, int64_t row0, int64_t row1, int64_t d,
                   int8_t* v8, int8_t* r8, float* scale, float* rscale,
                   float* res_buf) {
    for (int64_t i = row0; i < row1; ++i) {
        const float* xi = x + i * d;
        int8_t* vi = v8 + i * d;
        int8_t* ri = r8 + i * d;

        float absmax = 0.0f;
        for (int64_t j = 0; j < d; ++j) {
            float a = fabsf(xi[j]);
            if (a > absmax) absmax = a;
        }
        float s = absmax > 0.0f ? absmax * kInv127 : 1.0f;
        scale[i] = s;

        float rabs = 0.0f;
        for (int64_t j = 0; j < d; ++j) {
            int8_t q = quantise_one(xi[j], s);
            vi[j] = q;
            // single-rounded residual: exactly the f64-emulated value
            float r = fmaf(-static_cast<float>(q), s, xi[j]);
            res_buf[j] = r;
            float a = fabsf(r);
            if (a > rabs) rabs = a;
        }
        float rs = rabs > 0.0f ? rabs * kInv127 : 1.0f;
        rscale[i] = rs;

        for (int64_t j = 0; j < d; ++j) ri[j] = quantise_one(res_buf[j], rs);
    }
}

}  // namespace

extern "C" int zq_quantise_pair(const float* x, int64_t n, int64_t d,
                                int8_t* v8, int8_t* r8,
                                float* scale, float* rscale, int threads) {
    if (n <= 0 || d <= 0) return 0;
    int hw = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = hw > 0 ? hw : 1;
    // below ~64 rows the spawn cost dominates any overlap
    if (threads > 1 && n < 64) threads = 1;
    if (threads == 1) {
        std::vector<float> buf(d);
        quantise_rows(x, 0, n, d, v8, r8, scale, rscale, buf.data());
        return 0;
    }
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        int64_t r0 = t * per;
        int64_t r1 = r0 + per < n ? r0 + per : n;
        if (r0 >= r1) break;
        pool.emplace_back([=] {
            std::vector<float> buf(d);
            quantise_rows(x, r0, r1, d, v8, r8, scale, rscale, buf.data());
        });
    }
    for (auto& th : pool) th.join();
    return 0;
}
