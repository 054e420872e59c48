// Native data-prep kernel: fused dedup -> dense pivot -> per-patient
// mean imputation for the DNA-methylation matrix build
// (reference scripts/prepare_dna.py:33-65; the pandas path materializes a
// patient x probe cross-product of Python tuples — O(P*K) objects — before
// merging, which is minutes/GBs at whole-methylome scale. This single pass
// over flat arrays runs at memory bandwidth.)
//
// Semantics (must match data/prepare_dna.py's pandas path exactly;
// equivalence-tested in tests/test_prepare_data.py and
// tests/test_torch_prepare_data.py):
//   * duplicate (patient, probe) pairs: FIRST occurrence wins, even when its
//     beta is NaN (pandas drop_duplicates keep="first" acts on rows, not
//     values);
//   * cells never observed stay NaN until imputation;
//   * imputation: per-patient mean over that patient's non-NaN cells
//     (float64 accumulation, like pandas); a patient with zero non-NaN
//     cells keeps NaN everywhere.
//
// Built on demand by utils/native.py (g++ -O3 -shared -fPIC); loaded via
// ctypes. No Python.h dependency.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" int pivot_impute(const int32_t* pat, const int32_t* probe,
                            const double* beta, int64_t n, int32_t P,
                            int32_t K, double* out /* P*K, caller-allocated */) {
  const size_t total = (size_t)P * (size_t)K;
  const double kNaN = std::nan("");
  std::vector<uint8_t> written(total, 0);
  for (size_t i = 0; i < total; ++i) out[i] = kNaN;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t p = pat[i];
    const int32_t k = probe[i];
    if (p < 0 || p >= P || k < 0 || k >= K) return 1;  // bad index
    const size_t idx = (size_t)p * K + k;
    if (!written[idx]) {
      written[idx] = 1;
      out[idx] = beta[i];
    }
  }

  for (int32_t p = 0; p < P; ++p) {
    double* row = out + (size_t)p * K;
    double sum = 0.0;
    int64_t cnt = 0;
    for (int32_t k = 0; k < K; ++k) {
      if (!std::isnan(row[k])) {
        sum += row[k];
        ++cnt;
      }
    }
    if (cnt == 0) continue;  // all-NaN patient: mean undefined, keep NaN
    const double mean = sum / (double)cnt;
    for (int32_t k = 0; k < K; ++k) {
      if (std::isnan(row[k])) row[k] = mean;
    }
  }
  return 0;
}
