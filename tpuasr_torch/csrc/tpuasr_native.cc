// The port's native host runtime (its own copy of the JAX package's
// native/tpuasr_native.cc, with the same C ABI).
//
// The per-utterance WAV decode that a corpus epoch runs on the host (PCM
// 8/16/24/32-bit and IEEE float32, the first channel), a std::thread pool
// that decodes whole batches in parallel straight into the caller's numpy
// buffers, and the CER edit distance with an S/D/I backtrace. Built with
// the host C++ compiler at first use (tpuasr_torch/ops/_build.py,
// `host_library`) and bound with ctypes (tpuasr_torch/utils/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode (PCM 8/16/24/32-bit and float32, first channel)
// ---------------------------------------------------------------------------

// Returns number of samples written (<= max_samples); fills *sample_rate and
// *total_samples (full file length). Returns -1 on error.
int64_t tpuasr_wav_read(const char* path, float* out, int64_t max_samples,
                        int32_t* sample_rate, int64_t* total_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return -1;
  }
  uint16_t audio_format = 0, num_channels = 0, bits = 0;
  uint32_t sr = 0;
  int64_t data_size = -1;
  long data_pos = -1;
  // chunk scan
  for (;;) {
    uint8_t ch[8];
    if (fread(ch, 1, 8, f) != 8) break;
    uint32_t size;
    memcpy(&size, ch + 4, 4);
    if (memcmp(ch, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (fread(fmt, 1, 16, f) != 16) break;
      memcpy(&audio_format, fmt + 0, 2);
      memcpy(&num_channels, fmt + 2, 2);
      memcpy(&sr, fmt + 4, 4);
      memcpy(&bits, fmt + 14, 2);
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (memcmp(ch, "data", 4) == 0) {
      data_size = size;
      data_pos = ftell(f);
      fseek(f, size + (size & 1), SEEK_CUR);
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
    if (data_pos >= 0 && bits > 0) break;
  }
  if (data_pos < 0 || num_channels == 0 || bits == 0) {
    fclose(f);
    return -1;
  }
  const int bytes_per = bits / 8;
  const int64_t frames = data_size / (bytes_per * num_channels);
  *sample_rate = (int32_t)sr;
  *total_samples = frames;
  const int64_t n = frames < max_samples ? frames : max_samples;
  fseek(f, data_pos, SEEK_SET);

  std::vector<uint8_t> buf((size_t)(n * bytes_per * num_channels));
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const uint8_t* p = buf.data();
  const int stride = bytes_per * num_channels;
  if (audio_format == 3 && bits == 32) {  // IEEE float
    for (int64_t i = 0; i < n; i++) memcpy(&out[i], p + i * stride, 4);
  } else if (bits == 16) {
    for (int64_t i = 0; i < n; i++) {
      int16_t v;
      memcpy(&v, p + i * stride, 2);
      out[i] = (float)v / 32768.0f;
    }
  } else if (bits == 32) {
    for (int64_t i = 0; i < n; i++) {
      int32_t v;
      memcpy(&v, p + i * stride, 4);
      out[i] = (float)v / 2147483648.0f;
    }
  } else if (bits == 24) {
    for (int64_t i = 0; i < n; i++) {
      const uint8_t* q = p + i * stride;
      int32_t v = (int32_t)((uint32_t)q[0] << 8 | (uint32_t)q[1] << 16 |
                            (uint32_t)q[2] << 24) >> 8;
      out[i] = (float)v / 8388608.0f;
    }
  } else if (bits == 8) {
    for (int64_t i = 0; i < n; i++)
      out[i] = ((float)p[i * stride] - 128.0f) / 128.0f;
  } else {
    return -1;
  }
  return n;
}

// ---------------------------------------------------------------------------
// thread-pool batch loader
// ---------------------------------------------------------------------------

struct ThreadPool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  explicit ThreadPool(int n) {
    for (int i = 0; i < n; i++) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop();
          }
          task();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push(std::move(f));
    }
    cv.notify_one();
  }
};

void* tpuasr_loader_create(int num_threads) {
  return new ThreadPool(num_threads > 0 ? num_threads : 4);
}

void tpuasr_loader_destroy(void* pool) { delete (ThreadPool*)pool; }

// Decode `n` wav files in parallel into out[i * max_samples ...] (zero-padded),
// writing per-file sample counts (clipped to max_samples) into out_lens.
// Returns 0 on success, else the count of failed files.
int tpuasr_loader_load_batch(void* pool_ptr, const char** paths, int n,
                             float* out, int64_t* out_lens,
                             int64_t max_samples) {
  ThreadPool* pool = (ThreadPool*)pool_ptr;
  std::atomic<int> remaining(n), failures(0);
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; i++) {
    pool->submit([&, i] {
      float* dst = out + (int64_t)i * max_samples;
      memset(dst, 0, sizeof(float) * (size_t)max_samples);
      int32_t sr;
      int64_t total;
      int64_t got = tpuasr_wav_read(paths[i], dst, max_samples, &sr, &total);
      if (got < 0) {
        failures.fetch_add(1);
        out_lens[i] = 0;
      } else {
        out_lens[i] = got;
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failures.load();
}

// ---------------------------------------------------------------------------
// CER edit distance with S/D/I backtrace counts
// ---------------------------------------------------------------------------

// out[0..2] = substitutions, deletions, insertions
void tpuasr_cer_counts(const int32_t* ref, int32_t rlen, const int32_t* hyp,
                       int32_t hlen, int32_t* out) {
  const int n = rlen, m = hlen;
  std::vector<int32_t> dp((size_t)(n + 1) * (m + 1));
  auto at = [&](int i, int j) -> int32_t& { return dp[(size_t)i * (m + 1) + j]; };
  for (int i = 0; i <= n; i++) at(i, 0) = i;
  for (int j = 0; j <= m; j++) at(0, j) = j;
  for (int i = 1; i <= n; i++) {
    for (int j = 1; j <= m; j++) {
      int32_t sub = at(i - 1, j - 1) + (ref[i - 1] != hyp[j - 1]);
      int32_t del = at(i - 1, j) + 1;
      int32_t ins = at(i, j - 1) + 1;
      int32_t best = sub < del ? sub : del;
      at(i, j) = best < ins ? best : ins;
    }
  }
  int32_t s = 0, d = 0, ins = 0;
  int i = n, j = m;
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0 &&
        at(i, j) == at(i - 1, j - 1) + (ref[i - 1] != hyp[j - 1])) {
      if (ref[i - 1] != hyp[j - 1]) s++;
      i--, j--;
    } else if (i > 0 && at(i, j) == at(i - 1, j) + 1) {
      d++, i--;
    } else {
      ins++, j--;
    }
  }
  out[0] = s;
  out[1] = d;
  out[2] = ins;
}

}  // extern "C"
