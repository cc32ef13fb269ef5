// Native log-mel filterbank feature extraction (host-side input pipeline).
//
// Production ASR serving/training feeds the TPU from the host: audio ->
// frames -> FFT -> mel filterbank -> log, per utterance, overlapped with
// device compute.  The reference ships no input pipeline at all; this is
// the from-scratch native component backing fast_rnnt_tpu.data.features.
//
// Pipeline (matching the common Kaldi/lhotse "fbank" defaults):
//   pre-emphasis (0.97) -> povey-ish Hann window -> zero-padded radix-2
//   real FFT -> power spectrum -> HTK-mel triangular filterbank -> log.
//
// Exact numerics are pinned against an independent numpy/np.fft reference
// in tests/test_features.py.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// In-place iterative radix-2 complex FFT (n a power of two).
void fft(std::vector<float>& re, std::vector<float>& im) {
  const int n = static_cast<int>(re.size());
  // bit reversal
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / len;
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (int k = 0; k < len / 2; ++k) {
        const double ur = re[i + k], ui = im[i + k];
        const double vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        const double vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = static_cast<float>(ur + vr);
        im[i + k] = static_cast<float>(ui + vi);
        re[i + k + len / 2] = static_cast<float>(ur - vr);
        im[i + k + len / 2] = static_cast<float>(ui - vi);
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

inline double hz_to_mel(double hz) { return 1127.0 * std::log1p(hz / 700.0); }

}  // namespace

namespace {

// Core extractor.  have_prev/prev_sample supply the sample preceding
// wav[0] for pre-emphasis, so a long stream can be processed in chunks
// with EXACT parity to one offline call (data/features.py:StreamingFbank).
int32_t fbank_impl(const float* wav, int32_t n, int32_t sample_rate,
                   int32_t win_len, int32_t hop, int32_t n_fft,
                   int32_t n_mels, float low_hz, float high_hz,
                   float preemph, float* out, int32_t max_frames,
                   int32_t have_prev, float prev_sample) {
  if (n < win_len || win_len > n_fft) return 0;
  const int n_frames_all = (n - win_len) / hop + 1;
  const int n_frames = n_frames_all < max_frames ? n_frames_all : max_frames;
  const int n_bins = n_fft / 2 + 1;

  // Hann window
  std::vector<float> window(win_len);
  for (int i = 0; i < win_len; ++i)
    window[i] = 0.5f - 0.5f * std::cos(2.0f * kPi * i / (win_len - 1));

  // mel filterbank: triangular filters over FFT bins (HTK convention)
  if (high_hz <= 0.0f) high_hz = sample_rate / 2.0f;
  const double mel_lo = hz_to_mel(low_hz), mel_hi = hz_to_mel(high_hz);
  std::vector<double> mel_pts(n_mels + 2);
  for (int m = 0; m < n_mels + 2; ++m)
    mel_pts[m] = mel_lo + (mel_hi - mel_lo) * m / (n_mels + 1);
  // filter weight for (mel band m, fft bin k), stored sparsely per band
  std::vector<std::vector<float>> fw(n_mels, std::vector<float>(n_bins, 0.f));
  for (int k = 0; k < n_bins; ++k) {
    const double mel_k = hz_to_mel(static_cast<double>(k) * sample_rate / n_fft);
    for (int m = 0; m < n_mels; ++m) {
      const double l = mel_pts[m], c = mel_pts[m + 1], r = mel_pts[m + 2];
      double w = 0.0;
      if (mel_k > l && mel_k < r)
        w = mel_k <= c ? (mel_k - l) / (c - l) : (r - mel_k) / (r - c);
      fw[m][k] = static_cast<float>(w);
    }
  }

  std::vector<float> re(n_fft), im(n_fft);
  for (int f = 0; f < n_frames; ++f) {
    const float* frame = wav + static_cast<int64_t>(f) * hop;
    // pre-emphasis + window, zero-pad to n_fft
    for (int i = 0; i < win_len; ++i) {
      const float prev =
          (f * hop + i > 0)
              ? frame[i - 1]
              : (have_prev ? prev_sample : frame[i]);
      re[i] = (frame[i] - preemph * prev) * window[i];
      im[i] = 0.f;
    }
    for (int i = win_len; i < n_fft; ++i) re[i] = im[i] = 0.f;
    fft(re, im);
    float* row = out + static_cast<int64_t>(f) * n_mels;
    for (int m = 0; m < n_mels; ++m) {
      double acc = 0.0;
      const std::vector<float>& w = fw[m];
      for (int k = 0; k < n_bins; ++k) {
        const double p = static_cast<double>(re[k]) * re[k] +
                         static_cast<double>(im[k]) * im[k];
        acc += w[k] * p;
      }
      row[m] = static_cast<float>(std::log(acc > 1e-10 ? acc : 1e-10));
    }
  }
  return n_frames;
}

}  // namespace

extern "C" {

// wav: n samples in [-1, 1].  out: (max_frames, n_mels) row-major.
// Returns the number of frames written (floor((n - win_len)/hop) + 1, or 0).
int32_t frt_fbank(const float* wav, int32_t n, int32_t sample_rate,
                  int32_t win_len, int32_t hop, int32_t n_fft,
                  int32_t n_mels, float low_hz, float high_hz,
                  float preemph, float* out, int32_t max_frames) {
  return fbank_impl(wav, n, sample_rate, win_len, hop, n_fft, n_mels, low_hz,
                    high_hz, preemph, out, max_frames, /*have_prev=*/0, 0.f);
}

// Chunked variant: prev_sample is the stream sample preceding wav[0]
// (pre-emphasis context), making chunked extraction exactly equal to one
// offline frt_fbank call over the concatenated stream.
int32_t frt_fbank_ctx(const float* wav, int32_t n, int32_t sample_rate,
                      int32_t win_len, int32_t hop, int32_t n_fft,
                      int32_t n_mels, float low_hz, float high_hz,
                      float preemph, float* out, int32_t max_frames,
                      int32_t have_prev, float prev_sample) {
  return fbank_impl(wav, n, sample_rate, win_len, hop, n_fft, n_mels, low_hz,
                    high_hz, preemph, out, max_frames, have_prev, prev_sample);
}

}  // extern "C"
