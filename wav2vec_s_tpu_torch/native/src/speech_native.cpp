// The batched WAV reader of the data loader (C ABI, loaded with ctypes by
// wav2vec_s_tpu_torch/native/__init__.py): the role of the reference's
// soundfile / torchaudio C extensions.  It parses RIFF/WAVE PCM16 headers
// and fills a caller-provided [n, stride] float32 buffer from a pool of
// threads; a file it cannot handle gets lens[i] = -1, and the Python
// caller reads that one with its per-file reader.  Pure compute over plain
// arrays, no Python API.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavResult { int64_t len; int64_t rate; };

// One file into out[0, stride): mono PCM16 scaled by 1/32768; C channels
// summed in int32 and scaled by 1/(32768 C).  {-1, 0} when the file is not
// PCM16 RIFF/WAVE, is truncated, or holds more than `stride` frames.
WavResult read_one_wav(const char* path, float* out, int64_t stride) {
  WavResult bad{-1, 0};
  FILE* f = std::fopen(path, "rb");
  if (!f) return bad;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) { std::fclose(f); return bad; }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  // walk the chunks: fmt, then data (others skipped at their padded size)
  for (;;) {
    unsigned char ch[8];
    if (std::fread(ch, 1, 8, f) != 8) { std::fclose(f); return bad; }
    uint32_t sz;
    std::memcpy(&sz, ch + 4, 4);
    if (std::memcmp(ch, "fmt ", 4) == 0) {
      std::vector<unsigned char> b(sz);
      if (std::fread(b.data(), 1, sz, f) != sz || sz < 16) {
        std::fclose(f); return bad;
      }
      std::memcpy(&fmt, b.data(), 2);
      std::memcpy(&channels, b.data() + 2, 2);
      std::memcpy(&rate, b.data() + 4, 4);
      std::memcpy(&bits, b.data() + 14, 2);
    } else if (std::memcmp(ch, "data", 4) == 0) {
      if (fmt != 1 || bits != 16 || channels == 0) {  // PCM16 only
        std::fclose(f); return bad;
      }
      int64_t frames = (int64_t)sz / (2 * channels);
      if (frames > stride) { std::fclose(f); return bad; }
      std::vector<int16_t> raw((size_t)frames * channels);
      size_t got = std::fread(raw.data(), 2 * channels, frames, f);
      std::fclose(f);
      if ((int64_t)got != frames) return bad;
      const float inv = 1.0f / 32768.0f;
      if (channels == 1) {
        for (int64_t i = 0; i < frames; ++i) out[i] = raw[i] * inv;
      } else {
        const float cinv = inv / channels;
        for (int64_t i = 0; i < frames; ++i) {
          int32_t acc = 0;
          for (int c = 0; c < channels; ++c) acc += raw[i * channels + c];
          out[i] = acc * cinv;
        }
      }
      return WavResult{frames, (int64_t)rate};
    } else {
      if (std::fseek(f, (long)((sz + 1) & ~1u), SEEK_CUR) != 0) {
        std::fclose(f); return bad;
      }
    }
  }
}

}  // namespace

extern "C" {

// paths: n C strings; out: [n, stride] float32 (zero-filled by the caller);
// lens / rates: [n] outputs (len -1: not read here, the caller reads that
// file itself).  Returns the number of files decoded.
int64_t read_wav_batch(const char** paths, int64_t n, float* out,
                       int64_t stride, int64_t* lens, int64_t* rates,
                       int64_t n_threads) {
  std::atomic<int64_t> next{0}, ok{0};
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      WavResult r = read_one_wav(paths[i], out + i * stride, stride);
      lens[i] = r.len;
      rates[i] = r.rate;
      if (r.len >= 0) ok.fetch_add(1);
    }
  };
  int64_t t = std::min<int64_t>(std::max<int64_t>(n_threads, 1), n);
  std::vector<std::thread> pool;
  for (int64_t i = 1; i < t; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return ok.load();
}

}  // extern "C"
