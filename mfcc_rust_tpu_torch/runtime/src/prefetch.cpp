// Multi-threaded prefetching audio loader.
//
// Feeds the TPU extraction pipeline: N worker threads read+decode WAV files
// into a bounded queue; the Python consumer pops decoded float32 buffers.
// This is the native data-path component the reference leaves to its host
// application — here it keeps host CPUs decoding ahead of device compute so
// the accelerator never stalls on I/O.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int wav_read_f32(const char* path, float* out, uint32_t max_frames,
                 int mix_mono);
struct WavInfo {
  uint32_t sample_rate;
  uint16_t channels;
  uint16_t bits_per_sample;
  uint32_t frames;
  uint16_t format;
};
int wav_probe(const char* path, WavInfo* info);
}

namespace {

struct Item {
  int index;                 // position in the input path list
  int frames;                // decoded frames (or negative error code)
  uint32_t sample_rate;
  uint32_t channels;         // values per frame in `data` (1 when mixed)
  uint32_t format;           // source WAV format tag (1 = PCM, 3 = float)
  uint32_t bits;             // source bits per sample
  uint32_t src_channels;     // channel count in the FILE (mixdown provenance)
  std::vector<float> data;
};

struct Loader {
  std::vector<std::string> paths;
  uint32_t max_frames;
  int mix_mono;
  size_t capacity;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  // Reorder buffer keyed on path index: the consumer pops strictly in path
  // order, so downstream batch composition is DETERMINISTIC across runs
  // regardless of worker completion order (SURVEY §7 multi-host determinism
  // — the in-host half).  Workers may overfill by one item each when they
  // hold the next-needed index, which bounds memory at capacity + n_threads.
  std::map<size_t, Item> ready;
  std::atomic<size_t> next_path{0};
  size_t next_emit = 0;  // index the consumer needs next
  bool stopping = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t i = next_path.fetch_add(1);
      if (i >= paths.size()) return;
      Item it;
      it.index = (int)i;
      WavInfo info{};
      int prc = wav_probe(paths[i].c_str(), &info);
      it.sample_rate = prc == 0 ? info.sample_rate : 0;
      it.format = prc == 0 ? info.format : 0;
      it.bits = prc == 0 ? info.bits_per_sample : 0;
      it.src_channels = prc == 0 ? info.channels : 0;
      // interleaved output is frames*channels floats — size the buffer for
      // the full frame width or a multi-channel file overruns it.  If the
      // probe failed the channel count is unknown, so force a mono mixdown
      // for this item (a later successful read must not overrun the buffer).
      int effective_mix = mix_mono || prc != 0;
      uint32_t ch = (!effective_mix && info.channels > 0) ? info.channels : 1;
      it.channels = ch;
      // size the buffer from the probed frame count: resizing to max_frames
      // zero-fills max_seconds*48kHz floats (~46 MB) per item — measured as
      // a fixed ~12 ms/utterance that capped the whole corpus pipeline at
      // ~550 audio-s/s no matter how fast decode and the device were
      uint32_t want = max_frames;
      if (prc == 0 && info.frames > 0 && info.frames < max_frames)
        want = info.frames;
      it.data.resize((size_t)want * ch);
      it.frames = wav_read_f32(paths[i].c_str(), it.data.data(), want,
                               effective_mix ? 1 : 0);
      if (it.frames > 0) it.data.resize((size_t)it.frames * ch);
      std::unique_lock<std::mutex> lk(mu);
      // the next-needed index always bypasses the capacity bound, so the
      // in-order consumer can never deadlock against a full buffer
      cv_push.wait(lk, [&] {
        return ready.size() < capacity || i == next_emit || stopping;
      });
      if (stopping) return;
      ready.emplace(i, std::move(it));
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int n_threads,
                    int capacity, int mix_mono, uint32_t max_frames) {
  auto* ld = new Loader();
  ld->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; i++) ld->paths.emplace_back(paths[i]);
  ld->max_frames = max_frames;
  ld->mix_mono = mix_mono;
  ld->capacity = capacity > 0 ? (size_t)capacity : 8;
  int nt = n_threads > 0 ? n_threads : 4;
  if (nt > n_paths && n_paths > 0) nt = n_paths;
  for (int t = 0; t < nt; t++)
    ld->workers.emplace_back([ld] { ld->worker(); });
  return ld;
}

// Pops the next decoded item in PATH ORDER (deterministic).  Returns:
//   0  item copied (index_out, frames_out, ch_out, sr_out, fmt_out,
//      bits_out set; data into buf — interleaved, frames_out*ch_out floats,
//      capped at buf_values)
//   1  exhausted (all paths consumed)
//  <0  decode error for the item at index_out (frames_out = error code)
int loader_next(void* handle, int* index_out, float* buf, uint32_t buf_values,
                uint32_t* frames_out, uint32_t* ch_out, uint32_t* sr_out,
                uint32_t* fmt_out, uint32_t* bits_out, uint32_t* src_ch_out) {
  auto* ld = (Loader*)handle;
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_emit >= ld->paths.size()) return 1;
  ld->cv_pop.wait(lk, [&] { return ld->ready.count(ld->next_emit) != 0; });
  auto node = ld->ready.extract(ld->next_emit);
  Item it = std::move(node.mapped());
  ld->next_emit++;
  ld->cv_push.notify_all();
  lk.unlock();

  *index_out = it.index;
  *sr_out = it.sample_rate;
  *ch_out = it.channels;
  *fmt_out = it.format;
  *bits_out = it.bits;
  *src_ch_out = it.src_channels;
  if (it.frames < 0) {
    *frames_out = (uint32_t)(-it.frames);
    return it.frames;
  }
  uint32_t values = (uint32_t)it.frames * it.channels;
  if (values > buf_values) values = buf_values / it.channels * it.channels;
  memcpy(buf, it.data.data(), (size_t)values * sizeof(float));
  *frames_out = values / (it.channels ? it.channels : 1);
  return 0;
}

void loader_destroy(void* handle) {
  auto* ld = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stopping = true;
    ld->next_path.store(ld->paths.size());
  }
  ld->cv_push.notify_all();
  ld->cv_pop.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
