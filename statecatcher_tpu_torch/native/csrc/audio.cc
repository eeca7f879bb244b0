// Native audio decode for the host data plane.
//
// C++ replacement for the reference's ffmpeg/soundfile decode path
// (reference dataset.py:155-164) for RIFF/WAVE inputs: PCM16/32/float32
// parse, channel downmix, linear resample, int16 -> float32/32767 scaling.
// Exposed through a C ABI consumed via ctypes (statecatcher_tpu_torch/native).
// Semantics are kept bit-compatible with the pure-numpy fallback
// (statecatcher_tpu_torch/data/audio.py) and cross-checked by tests: the sample
// scaling stays a true float32 DIVISION (a reciprocal multiply differs in
// the last ulp from numpy's vdivps).
//
// Perf notes: the size query (out=nullptr)
// is header-only — it must NOT decode; the fill call decodes straight into
// the caller's buffer so the common mono-PCM16-no-resample case is one
// vectorizable pass over the payload with zero intermediate allocation.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
};

bool parse_wav(const uint8_t* buf, size_t n, WavInfo* out) {
  if (n < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= n) {
    const uint8_t* cid = buf + pos;
    uint32_t csize;
    memcpy(&csize, buf + pos + 4, 4);
    pos += 8;
    if (pos + csize > n) csize = static_cast<uint32_t>(n - pos);
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      memcpy(&out->format, buf + pos, 2);
      memcpy(&out->channels, buf + pos + 2, 2);
      memcpy(&out->sample_rate, buf + pos + 4, 4);
      memcpy(&out->bits, buf + pos + 14, 2);
      if (out->format == 0xFFFE && csize >= 26) {
        memcpy(&out->format, buf + pos + 24, 2);  // WAVE_FORMAT_EXTENSIBLE
      }
      have_fmt = true;
    } else if (memcmp(cid, "data", 4) == 0) {
      out->data = buf + pos;
      out->data_size = csize;
      have_data = true;
    }
    pos += csize + (csize & 1);
    if (have_fmt && have_data) break;
  }
  return have_fmt && have_data && out->channels > 0;
}

bool format_supported(const WavInfo& w) {
  return (w.format == 1 && (w.bits == 16 || w.bits == 32 || w.bits == 8)) ||
         (w.format == 3 && w.bits == 32);
}

// frame count from the header alone (no decode)
size_t frame_count(const WavInfo& w) {
  const size_t bytes_per_frame =
      static_cast<size_t>(w.bits / 8) * w.channels;
  return bytes_per_frame ? w.data_size / bytes_per_frame : 0;
}

size_t resampled_count(size_t frames, uint32_t sr_in, int sr_out) {
  if (static_cast<int>(sr_in) == sr_out || frames == 0) return frames;
  return static_cast<size_t>(
      std::llround(static_cast<double>(frames) * sr_out / sr_in));
}

// decode to mono float32 at source rate, directly into dst (frame_count(w)
// floats).  One pass, vectorizable in the mono cases.
bool decode_samples(const WavInfo& w, float* dst) {
  const size_t ch = w.channels;
  const size_t frames = frame_count(w);
  if (w.format == 1 && w.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(w.data);
    if (ch == 1) {
      for (size_t i = 0; i < frames; ++i)
        dst[i] = static_cast<float>(s[i]) / 32767.0f;
    } else {
      for (size_t i = 0; i < frames; ++i) {
        // parity with numpy fallback: mean of per-channel float values
        float acc = 0.f;
        for (size_t c = 0; c < ch; ++c)
          acc += static_cast<float>(s[i * ch + c]) / 32767.0f;
        dst[i] = acc / static_cast<float>(ch);
      }
    }
    return true;
  }
  if (w.format == 1 && w.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(w.data);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (size_t c = 0; c < ch; ++c)
        acc += static_cast<float>(s[i * ch + c]) / 2147483647.0f;
      dst[i] = acc / static_cast<float>(ch);
    }
    return true;
  }
  if (w.format == 1 && w.bits == 8) {
    const uint8_t* s = w.data;
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (size_t c = 0; c < ch; ++c)
        acc += (static_cast<float>(s[i * ch + c]) - 128.0f) / 127.0f;
      dst[i] = acc / static_cast<float>(ch);
    }
    return true;
  }
  if (w.format == 3 && w.bits == 32) {
    const float* s = reinterpret_cast<const float*>(w.data);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (size_t c = 0; c < ch; ++c) acc += s[i * ch + c];
      dst[i] = acc / static_cast<float>(ch);
    }
    return true;
  }
  return false;
}

// np.interp-compatible linear resampler (double-precision positions)
void resample_linear(const float* in, size_t n_in, int sr_in, int sr_out,
                     float* out, size_t n_out) {
  const double step = static_cast<double>(sr_in) / sr_out;
  for (size_t i = 0; i < n_out; ++i) {
    double t = i * step;
    size_t lo = static_cast<size_t>(t);
    if (lo >= n_in - 1) {
      out[i] = in[n_in - 1];
      continue;
    }
    double frac = t - lo;
    out[i] = static_cast<float>(in[lo] * (1.0 - frac) + in[lo + 1] * frac);
  }
}

}  // namespace

extern "C" {

// Returns number of output samples, or -1 on parse/format error.
// Two-call protocol: pass out=nullptr to query the size first (header-only,
// no decode); the second call decodes once, straight into ``out``.
long sc_decode_wav(const uint8_t* buf, size_t n, int target_sr, float* out,
                   size_t out_capacity) {
  WavInfo w;
  if (!parse_wav(buf, n, &w)) return -1;
  if (!format_supported(w)) return -1;
  const size_t frames = frame_count(w);
  const size_t n_out = resampled_count(frames, w.sample_rate, target_sr);
  if (out == nullptr) return static_cast<long>(n_out);
  if (static_cast<int>(w.sample_rate) == target_sr || frames == 0) {
    if (out_capacity < n_out) return -1;
    if (!decode_samples(w, out)) return -1;
    return static_cast<long>(n_out);
  }
  std::vector<float> mono(frames);
  if (!decode_samples(w, mono.data())) return -1;
  if (out_capacity < n_out) return -1;
  resample_linear(mono.data(), frames, static_cast<int>(w.sample_rate),
                  target_sr, out, n_out);
  return static_cast<long>(n_out);
}

int sc_wav_sample_rate(const uint8_t* buf, size_t n) {
  WavInfo w;
  if (!parse_wav(buf, n, &w)) return -1;
  return static_cast<int>(w.sample_rate);
}

}  // extern "C"
