// speechmix_tpu_torch native runtime: host-side hot loops in C++ (the
// port's own copy of speechmix_tpu/runtime/native.cpp, the same functions).
//
// The device path is PyTorch + the CUDA kernels of csrc/; this library
// covers the host runtime pieces that sit on the data path and the eval path:
//   * smx_resample      — rational polyphase windowed-sinc resampler
//                         (audio -> 16 kHz; the reference used torchaudio,
//                         train.py:40-42)
//   * smx_normalize     — zero-mean/unit-variance waveform normalization
//   * smx_edit_distance — Levenshtein DP over int token/char ids (WER/CER
//                         inner loop; the reference used the asrp package)
//
// Built by runtime/native.py with g++ -O3 -shared -fPIC into
// speechmix_tpu_torch/_build/ at first use and loaded with ctypes; a failed
// build raises.  The numpy versions in data/audio.py and metrics.py are the
// plain versions the tests hold this library against.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// greatest common divisor (C++14-safe)
static int64_t smx_gcd(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

// Output length for smx_resample given input length and rates.
int64_t smx_resample_out_len(int64_t n_in, int64_t sr_in, int64_t sr_out) {
  int64_t g = smx_gcd(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;
  return (n_in * up + down - 1) / down;
}

// Rational polyphase resampling with a Hamming-windowed sinc low-pass.
// Equivalent math to resample_plain in data/audio.py: zero-stuff by
// `up`, convolve with sinc(cutoff)*hamming, take every `down`-th sample —
// but computed directly in polyphase form (no up-sampled buffer).
int64_t smx_resample(const float* in, int64_t n_in, int64_t sr_in,
                     int64_t sr_out, float* out, int64_t max_out) {
  if (sr_in == sr_out) {
    int64_t n = std::min(n_in, max_out);
    std::memcpy(out, in, sizeof(float) * n);
    return n;
  }
  int64_t g = smx_gcd(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;

  // filter design (matches _sinc_kernel in data/audio.py)
  double cutoff = 0.5 / static_cast<double>(std::max(up, down));
  int64_t half = 10 * std::max(up, down);
  int64_t taps_n = 2 * half + 1;
  std::vector<double> taps(taps_n);
  double sum = 0.0;
  for (int64_t i = 0; i < taps_n; ++i) {
    double x = 2.0 * cutoff * static_cast<double>(i - half);
    double sinc = (x == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    double win = 0.54 - 0.46 * std::cos(2.0 * M_PI * i / (taps_n - 1));
    taps[i] = sinc * win;
    sum += taps[i];
  }
  for (auto& t : taps) t /= sum;

  // polyphase: out[m] corresponds to up-sampled index m*down; the "same"
  // convolution of the plain version centers the kernel, so up-sampled position
  // p draws on stuffed samples p-half..p+half; stuffed[j] = in[j/up]*up
  // when j%up==0.
  int64_t n_out = (n_in * up + down - 1) / down;
  n_out = std::min(n_out, max_out);
  for (int64_t m = 0; m < n_out; ++m) {
    int64_t p = m * down;
    int64_t j_lo = p - half, j_hi = p + half;
    // smallest j >= j_lo with j % up == 0
    int64_t j0 = j_lo >= 0 ? ((j_lo + up - 1) / up) * up : (j_lo / up) * up;
    if (j0 < j_lo) j0 += up;
    double acc = 0.0;
    for (int64_t j = j0; j <= j_hi; j += up) {
      int64_t src = j / up;
      if (src < 0 || src >= n_in) continue;
      acc += static_cast<double>(in[src]) * up * taps[j - j_lo];
    }
    out[m] = static_cast<float>(acc);
  }
  return n_out;
}

// Zero-mean unit-variance normalization (wav2vec2 do_normalize).
void smx_normalize(float* data, int64_t n, float eps) {
  if (n <= 0) return;
  double mean = 0.0;
  for (int64_t i = 0; i < n; ++i) mean += data[i];
  mean /= n;
  double var = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double d = data[i] - mean;
    var += d * d;
  }
  var /= n;
  float scale = 1.0f / std::sqrt(static_cast<float>(var) + eps);
  for (int64_t i = 0; i < n; ++i)
    data[i] = (data[i] - static_cast<float>(mean)) * scale;
}

// Levenshtein distance over int sequences (two-row DP).
int64_t smx_edit_distance(const int32_t* ref, int64_t n,
                          const int32_t* hyp, int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  std::iota(prev.begin(), prev.end(), 0);
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    int32_t r = ref[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      int64_t cost = (r == hyp[j - 1]) ? 0 : 1;
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"
