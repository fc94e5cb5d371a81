// Native WAV codec for the corpus data path.
//
// The reference delegates audio I/O to its Rust/tract host application; this
// framework owns the ingest path so multi-host extraction jobs can stream
// LibriSpeech-scale corpora without Python in the hot loop.  Supports RIFF
// PCM8/16/24/32 and IEEE float32/64, with optional mono mixdown, plus a
// PCM16 writer for tests/fixtures.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

struct WavInfo {
  uint32_t sample_rate;
  uint16_t channels;
  uint16_t bits_per_sample;
  uint32_t frames;         // samples per channel
  uint16_t format;         // 1 = PCM, 3 = IEEE float
};

// Error codes (negative returns)
enum {
  WAV_ERR_OPEN = -1,
  WAV_ERR_NOT_RIFF = -2,
  WAV_ERR_NO_FMT = -3,
  WAV_ERR_NO_DATA = -4,
  WAV_ERR_FORMAT = -5,
  WAV_ERR_IO = -6,
};

namespace {

struct ChunkHeader {
  char id[4];
  uint32_t size;
};

bool read_exact(FILE* f, void* buf, size_t n) { return fread(buf, 1, n, f) == n; }

// Locate the fmt and data chunks; returns 0 on success and leaves the file
// positioned at the start of the data chunk payload.
int parse_header(FILE* f, WavInfo* info, uint32_t* data_bytes) {
  char riff[4], wave[4];
  uint32_t riff_size;
  if (!read_exact(f, riff, 4) || !read_exact(f, &riff_size, 4) ||
      !read_exact(f, wave, 4))
    return WAV_ERR_NOT_RIFF;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(wave, "WAVE", 4) != 0)
    return WAV_ERR_NOT_RIFF;

  bool have_fmt = false;
  ChunkHeader ch;
  while (read_exact(f, &ch, sizeof(ch))) {
    if (memcmp(ch.id, "fmt ", 4) == 0) {
      uint8_t fmt[40] = {0};
      uint32_t n = ch.size < sizeof(fmt) ? ch.size : (uint32_t)sizeof(fmt);
      if (!read_exact(f, fmt, n)) return WAV_ERR_IO;
      if (ch.size > n && fseek(f, ch.size - n, SEEK_CUR) != 0) return WAV_ERR_IO;
      uint16_t format;
      memcpy(&format, fmt + 0, 2);
      memcpy(&info->channels, fmt + 2, 2);
      memcpy(&info->sample_rate, fmt + 4, 4);
      memcpy(&info->bits_per_sample, fmt + 14, 2);
      if (format == 0xFFFE && ch.size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        memcpy(&format, fmt + 24, 2);           // sub-format GUID leading u16
      }
      info->format = format;
      have_fmt = true;
    } else if (memcmp(ch.id, "data", 4) == 0) {
      if (!have_fmt) return WAV_ERR_NO_FMT;
      *data_bytes = ch.size;
      uint32_t frame_bytes = info->channels * (info->bits_per_sample / 8);
      if (frame_bytes == 0) return WAV_ERR_FORMAT;
      info->frames = ch.size / frame_bytes;
      return 0;
    } else {
      // chunks are word-aligned
      uint32_t skip = ch.size + (ch.size & 1);
      if (fseek(f, skip, SEEK_CUR) != 0) return WAV_ERR_IO;
    }
  }
  return have_fmt ? WAV_ERR_NO_DATA : WAV_ERR_NO_FMT;
}

inline float pcm_to_f32(const uint8_t* p, uint16_t bits, uint16_t format) {
  switch (format) {
    case 1:  // integer PCM
      switch (bits) {
        case 8:
          return ((int)p[0] - 128) * (1.0f / 128.0f);
        case 16: {
          int16_t v;
          memcpy(&v, p, 2);
          return v * (1.0f / 32768.0f);
        }
        case 24: {
          int32_t v = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
          return (v >> 8) * (1.0f / 8388608.0f);
        }
        case 32: {
          int32_t v;
          memcpy(&v, p, 4);
          return (float)(v * (1.0 / 2147483648.0));
        }
      }
      return 0.0f;
    case 3:  // IEEE float
      if (bits == 32) {
        float v;
        memcpy(&v, p, 4);
        return v;
      }
      if (bits == 64) {
        double v;
        memcpy(&v, p, 8);
        return (float)v;
      }
      return 0.0f;
  }
  return 0.0f;
}

}  // namespace

int wav_probe(const char* path, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return WAV_ERR_OPEN;
  uint32_t data_bytes = 0;
  int rc = parse_header(f, info, &data_bytes);
  fclose(f);
  return rc;
}

// Decode up to max_frames frames into out.  mix_mono!=0 averages channels
// into a single stream (out needs max_frames floats); otherwise output is
// interleaved (out needs max_frames * channels floats).  Returns frames
// decoded, or a negative error.
int wav_read_f32(const char* path, float* out, uint32_t max_frames,
                 int mix_mono) {
  FILE* f = fopen(path, "rb");
  if (!f) return WAV_ERR_OPEN;
  WavInfo info;
  uint32_t data_bytes = 0;
  int rc = parse_header(f, &info, &data_bytes);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (!(info.format == 1 || info.format == 3) ||
      (info.format == 1 && !(info.bits_per_sample == 8 ||
                             info.bits_per_sample == 16 ||
                             info.bits_per_sample == 24 ||
                             info.bits_per_sample == 32)) ||
      (info.format == 3 && !(info.bits_per_sample == 32 ||
                             info.bits_per_sample == 64))) {
    fclose(f);
    return WAV_ERR_FORMAT;
  }
  uint32_t frames = info.frames < max_frames ? info.frames : max_frames;
  uint16_t bytes_per = info.bits_per_sample / 8;
  uint32_t frame_bytes = info.channels * bytes_per;

  std::vector<uint8_t> buf(1 << 16);
  uint32_t done = 0;
  float inv_ch = info.channels ? 1.0f / info.channels : 0.0f;
  while (done < frames) {
    uint32_t want = (uint32_t)(buf.size() / frame_bytes);
    if (want > frames - done) want = frames - done;
    if (want == 0) break;
    if (!read_exact(f, buf.data(), (size_t)want * frame_bytes)) {
      fclose(f);
      return WAV_ERR_IO;
    }
    const uint8_t* p = buf.data();
    if (mix_mono) {
      for (uint32_t i = 0; i < want; i++) {
        float acc = 0.0f;
        for (uint16_t c = 0; c < info.channels; c++)
          acc += pcm_to_f32(p + (size_t)i * frame_bytes + (size_t)c * bytes_per,
                            info.bits_per_sample, info.format);
        out[done + i] = acc * inv_ch;
      }
    } else {
      for (uint32_t i = 0; i < want; i++)
        for (uint16_t c = 0; c < info.channels; c++)
          out[(size_t)(done + i) * info.channels + c] =
              pcm_to_f32(p + (size_t)i * frame_bytes + (size_t)c * bytes_per,
                         info.bits_per_sample, info.format);
    }
    done += want;
  }
  fclose(f);
  return (int)done;
}

int wav_write_pcm16(const char* path, const float* data, uint32_t frames,
                    uint32_t sample_rate, uint16_t channels) {
  FILE* f = fopen(path, "wb");
  if (!f) return WAV_ERR_OPEN;
  uint32_t data_bytes = frames * channels * 2;
  uint32_t riff_size = 36 + data_bytes;
  uint16_t block_align = channels * 2;
  uint32_t byte_rate = sample_rate * block_align;
  uint16_t fmt_pcm = 1, bits = 16;
  uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt_pcm, 2, 1, f);
  fwrite(&channels, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> tmp((size_t)frames * channels);
  for (size_t i = 0; i < tmp.size(); i++) {
    float v = data[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    tmp[i] = (int16_t)(v * 32767.0f);
  }
  size_t wrote = fwrite(tmp.data(), 2, tmp.size(), f);
  fclose(f);
  return wrote == tmp.size() ? 0 : WAV_ERR_IO;
}

}  // extern "C"
