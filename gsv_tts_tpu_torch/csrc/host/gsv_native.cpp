// Host-side DSP kernels for gsv-tts-lite-tpu.
//
// These implement the irregular, latency-sensitive host algorithms that sit
// between device dispatches in the streaming pipeline: the SOLA
// cross-correlation offset search (reference gsv_tts/TTS.py:1612-1627) and
// the monotonic Viterbi alignment used for subtitle timing
// (gsv_tts/TTS.py:1744-1797).  Exposed with a plain C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Normalized cross-correlation offset search.
// query: previous chunk tail [overlap_len]; key: next chunk head [key_len].
// Returns argmax_o ( sum_i query[i]*key[o+i] / sqrt(sum_i key[o+i]^2 + eps) ).
int64_t gsv_sola_offset(const float* query, int64_t overlap_len,
                        const float* key, int64_t key_len) {
  const int64_t n = key_len - overlap_len + 1;
  if (n <= 0) return 0;

  // rolling energy of key windows
  double energy = 0.0;
  for (int64_t i = 0; i < overlap_len; ++i) energy += (double)key[i] * key[i];

  int64_t best = 0;
  double best_score = -1e30;
  double e = energy;
  for (int64_t o = 0; o < n; ++o) {
    double corr = 0.0;
    const float* k = key + o;
    for (int64_t i = 0; i < overlap_len; ++i) corr += (double)query[i] * k[i];
    const double score = corr / std::sqrt(e + 1e-8);
    if (score > best_score) {
      best_score = score;
      best = o;
    }
    if (o + 1 < n) {
      e += (double)key[o + overlap_len] * key[o + overlap_len] -
           (double)key[o] * key[o];
    }
  }
  return best;
}

// Monotonic Viterbi: transitions stay or advance by one phone per frame.
// probs: [t, n] row-major emission scores; out: [t] assignment path.
// Tie-breaking matches torch.max(stacked, dim=0): prefer "stay" on ties.
void gsv_viterbi_monotonic(const float* probs, int64_t t, int64_t n,
                           int64_t* out) {
  if (t <= 0 || n <= 0) return;
  std::vector<float> dp_prev(probs, probs + n), dp_cur(n);
  std::vector<int8_t> shift(t * n, 0);

  for (int64_t i = 1; i < t; ++i) {
    const float* row = probs + i * n;
    int8_t* sh = shift.data() + i * n;
    dp_cur[0] = row[0] + dp_prev[0];
    for (int64_t j = 1; j < n; ++j) {
      const float stay = dp_prev[j];
      const float adv = dp_prev[j - 1];
      if (adv > stay) {
        dp_cur[j] = row[j] + adv;
        sh[j] = 1;
      } else {
        dp_cur[j] = row[j] + stay;
      }
    }
    dp_prev.swap(dp_cur);
  }

  int64_t best = 0;
  for (int64_t j = 1; j < n; ++j)
    if (dp_prev[j] > dp_prev[best]) best = j;
  out[t - 1] = best;
  for (int64_t i = t - 2; i >= 0; --i) {
    const int64_t nxt = out[i + 1];
    out[i] = nxt - (int64_t)shift[(i + 1) * n + nxt];
  }
}

// Attack/release envelope follower (compressor level detector): one-pole
// smoothing whose coefficient switches on signal direction.  Inherently
// sequential, so it lives here rather than in numpy.
void gsv_envelope_follow(const float* level, int64_t n, float att, float rel,
                         float* out) {
  double e = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double v = level[i];
    const double c = v > e ? att : rel;
    e = c * e + (1.0 - c) * v;
    out[i] = (float)e;
  }
}

// Freeverb wet path (juce::Reverb processMono structure): 8 damped combs in
// parallel + 4 series "allpass" sections, as true O(1)/sample delay-line
// recursions.  The numpy fallback expresses the same filters as dense
// lfilter IIRs whose coefficient vectors are ~delay long — O(delay)/sample,
// ~1000x more work at 32 kHz tunings.  Doubles throughout (the fallback
// accumulates in float64); the dry/wet mix and the fixed 0.015 comb input
// gain stay in the Python caller so both paths share one definition.
void gsv_freeverb(const float* x, int64_t n, const int64_t* comb_delays,
                  int64_t n_combs, const int64_t* ap_delays, int64_t n_aps,
                  double feedback, double damp, double* out) {
  const double d2 = 1.0 - damp;
  std::vector<std::vector<double>> cbuf(n_combs);
  std::vector<double> fstore(n_combs, 0.0);
  std::vector<int64_t> cidx(n_combs, 0);
  for (int64_t c = 0; c < n_combs; ++c) cbuf[c].assign(comb_delays[c], 0.0);
  std::vector<std::vector<double>> abuf(n_aps);
  std::vector<int64_t> aidx(n_aps, 0);
  for (int64_t a = 0; a < n_aps; ++a) abuf[a].assign(ap_delays[a], 0.0);

  for (int64_t i = 0; i < n; ++i) {
    const double in = x[i];
    double acc = 0.0;
    for (int64_t c = 0; c < n_combs; ++c) {
      const double y = cbuf[c][cidx[c]];
      acc += y;
      fstore[c] = y * d2 + fstore[c] * damp;  // one-pole damping LP
      cbuf[c][cidx[c]] = in + fstore[c] * feedback;
      if (++cidx[c] == comb_delays[c]) cidx[c] = 0;
    }
    acc *= 0.015;  // freeverb fixed input gain (linear: applied post-sum)
    for (int64_t a = 0; a < n_aps; ++a) {
      const double buffered = abuf[a][aidx[a]];
      const double y = buffered - acc;  // JUCE form, not unity-gain allpass
      abuf[a][aidx[a]] = acc + 0.5 * buffered;
      if (++aidx[a] == ap_delays[a]) aidx[a] = 0;
      acc = y;
    }
    out[i] = acc;
  }
}

}  // extern "C"
