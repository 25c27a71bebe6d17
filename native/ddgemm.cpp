// Double-double ground-truth GEMM for the accuracy harness.
//
// Native analog of the reference's dd evaluation kernels
// (GEMMul8 testing/eval.hpp:15-164, 265-308): error-free
// TwoProd (FMA) + TwoSum accumulation so the result carries ~106 bits of
// precision — the oracle every accuracy test compares against. The
// reference runs this as a CUDA kernel; here it is host C++/OpenMP: the
// oracle must be independent of the device under test.
//
// Also exports a phi-difficulty matrix generator matching
// testing/make_matrix.hpp:8-35's distribution ((u-0.5)*exp(phi*N(0,1))),
// and max/median relative-error metrics (eval.hpp:317-381).
//
// Build: make -C native   (produces libddgemm.so; loaded via ctypes from
// gemmul8_tpu/bench/native.py with a pure-NumPy fallback).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct dd {
  double hi, lo;
};

inline dd two_sum(double a, double b) {
  double s = a + b;
  double bb = s - a;
  double err = (a - (s - bb)) + (b - bb);
  return {s, err};
}

inline dd quick_two_sum(double a, double b) {
  double s = a + b;
  return {s, b - (s - a)};
}

inline dd two_prod(double a, double b) {
  double p = a * b;
  return {p, std::fma(a, b, -p)};
}

inline dd dd_add(dd x, double y) {
  dd s = two_sum(x.hi, y);
  return quick_two_sum(s.hi, s.lo + x.lo);
}

inline dd dd_add(dd x, dd y) {
  dd s = two_sum(x.hi, y.hi);
  dd t = two_sum(x.lo, y.lo);
  s.lo += t.hi;
  s = quick_two_sum(s.hi, s.lo);
  s.lo += t.lo;
  return quick_two_sum(s.hi, s.lo);
}

}  // namespace

extern "C" {

// C[hi,lo] = A (m x k, row-major) * B (k x n, row-major), double-double.
void ddgemm(const double* A, const double* B, double* C_hi, double* C_lo,
            int64_t m, int64_t n, int64_t k) {
  constexpr int64_t NB = 64;  // B-panel blocking for cache reuse
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t i = 0; i < m; ++i) {
    std::vector<dd> acc(n, dd{0.0, 0.0});
    for (int64_t p0 = 0; p0 < k; p0 += NB) {
      int64_t p1 = std::min(p0 + NB, k);
      for (int64_t p = p0; p < p1; ++p) {
        double a = A[i * k + p];
        if (a == 0.0) continue;
        const double* brow = B + p * n;
        for (int64_t j = 0; j < n; ++j) {
          dd prod = two_prod(a, brow[j]);
          acc[j] = dd_add(dd_add(acc[j], prod.hi), prod.lo);
        }
      }
    }
    for (int64_t j = 0; j < n; ++j) {
      C_hi[i * n + j] = acc[j].hi;
      C_lo[i * n + j] = acc[j].lo;
    }
  }
}

// max and median elementwise relative error of got vs dd truth
// (eval.hpp:317-358). Writes {max, median} into out[2].
void relerr_metrics(const double* got, const double* ref_hi,
                    const double* ref_lo, int64_t count, double* out) {
  std::vector<double> errs(count);
#if defined(_OPENMP)
#pragma omp parallel for
#endif
  for (int64_t i = 0; i < count; ++i) {
    dd diff = two_sum(got[i], -ref_hi[i]);
    diff.lo -= ref_lo[i];
    double d = std::fabs(diff.hi + diff.lo);
    double r = std::fabs(ref_hi[i]);
    errs[i] = r > 0.0 ? d / r : (d > 0.0 ? HUGE_VAL : 0.0);
  }
  double mx = 0.0;
  for (int64_t i = 0; i < count; ++i) mx = std::max(mx, errs[i]);
  std::nth_element(errs.begin(), errs.begin() + count / 2, errs.end());
  out[0] = mx;
  out[1] = errs[count / 2];
}

// phi-difficulty test matrix, xorshift-seeded: (u-0.5)*exp(phi*N(0,1))
// matching make_matrix.hpp:8-22's distribution model.
void phi_matrix(double* out, int64_t count, double phi, uint64_t seed) {
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
  auto next = [&s]() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  };
  constexpr double kInv = 1.0 / 9007199254740992.0;  // 2^-53
  for (int64_t i = 0; i < count; ++i) {
    double u = ((next() >> 11) + 0.5) * kInv;
    double u1 = ((next() >> 11) + 0.5) * kInv;
    double u2 = ((next() >> 11) + 0.5) * kInv;
    double g = std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
    out[i] = (u - 0.5) * std::exp(phi * g);
  }
}

}  // extern "C"
