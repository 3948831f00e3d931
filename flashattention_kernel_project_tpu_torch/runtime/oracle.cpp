// Native CPU reference oracles — the reference's L4 layer, rebuilt.
//
// The CUDA reference pairs every kernel with a naive C++ CPU implementation,
// fp64-accumulated (SURVEY.md section 4.1: cpu_gemm_ref naive_gemm.cu:60-74,
// flashattn_cpu_ref flashattn_forward_fused_5_4_2.cu:224-271, streaming ref
// flashattn_streaming_16x16.cu:283-348). numpy covers small shapes; this
// library makes oracle verification practical at production shapes
// (4K x 4K x 128 attention) by threading over independent rows/heads.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread oracle.cpp -o liboracle.so
// (done automatically by runtime/native.py on first use)

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across hardware threads.
template <typename F>
void parallel_for(int64_t n, F fn) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  int64_t n_threads = std::min<int64_t>(hw, n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([=] {
      for (int64_t i = t; i < n; i += n_threads) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// C[m,n] = A[m,k] @ B[k,n], fp64 accumulation, threaded over rows.
void gemm_f32(const float* a, const float* b, float* c, int64_t m, int64_t k,
              int64_t n) {
  parallel_for(m, [=](int64_t i) {
    for (int64_t j = 0; j < n; ++j) {
      double acc = 0.0;
      for (int64_t kk = 0; kk < k; ++kk) {
        acc += static_cast<double>(a[i * k + kk]) *
               static_cast<double>(b[kk * n + j]);
      }
      c[i * n + j] = static_cast<float>(acc);
    }
  });
}

// Row softmax, fp64 accumulation, threaded over rows.
void softmax_f32(const float* x, float* y, int64_t rows, int64_t n) {
  parallel_for(rows, [=](int64_t r) {
    const float* xr = x + r * n;
    float* yr = y + r * n;
    double m = -INFINITY;
    for (int64_t j = 0; j < n; ++j) m = std::max(m, (double)xr[j]);
    double l = 0.0;
    for (int64_t j = 0; j < n; ++j) l += std::exp((double)xr[j] - m);
    for (int64_t j = 0; j < n; ++j)
      yr[j] = static_cast<float>(std::exp((double)xr[j] - m) / l);
  });
}

// Grouped-query attention oracle.
//   q: [b, hq, n, d]   k, v: [b, hkv, s, d]   o: [b, hq, n, d]
// causal: query i attends key j iff j <= i + q_offset.
// Threaded over (b, hq, n) rows; fp64 throughout.
void gqa_attention_f32(const float* q, const float* k, const float* v,
                       float* o, int64_t b, int64_t hq, int64_t hkv,
                       int64_t n, int64_t s, int64_t d, float scale,
                       int32_t causal, int64_t q_offset) {
  int64_t group = hq / hkv;
  int64_t total = b * hq * n;
  parallel_for(total, [=](int64_t idx) {
    int64_t i = idx % n;
    int64_t h = (idx / n) % hq;
    int64_t bb = idx / (n * hq);
    int64_t hk = h / group;
    const float* qrow = q + ((bb * hq + h) * n + i) * d;
    const float* kbase = k + (bb * hkv + hk) * s * d;
    const float* vbase = v + (bb * hkv + hk) * s * d;
    float* orow = o + ((bb * hq + h) * n + i) * d;

    int64_t s_end = causal ? std::min<int64_t>(s, i + q_offset + 1) : s;
    if (s_end <= 0) {
      for (int64_t dd = 0; dd < d; ++dd) orow[dd] = 0.0f;
      return;
    }
    // online softmax (the 5.4.2 rescale discipline) so scores never
    // materialize — the oracle itself demonstrates the algorithm.
    double m = -INFINITY, l = 0.0;
    std::vector<double> acc(d, 0.0);
    for (int64_t j = 0; j < s_end; ++j) {
      double score = 0.0;
      const float* krow = kbase + j * d;
      for (int64_t dd = 0; dd < d; ++dd)
        score += (double)qrow[dd] * (double)krow[dd];
      score *= scale;
      double m_new = std::max(m, score);
      double alpha = std::exp(m - m_new);
      double e = std::exp(score - m_new);
      l = l * alpha + e;
      const float* vrow = vbase + j * d;
      for (int64_t dd = 0; dd < d; ++dd)
        acc[dd] = acc[dd] * alpha + e * (double)vrow[dd];
      m = m_new;
    }
    for (int64_t dd = 0; dd < d; ++dd)
      orow[dd] = static_cast<float>(acc[dd] / l);
  });
}

}  // extern "C"
