// f5_runtime: native serving runtime for the TPU TTS framework.
//
// Role parity with the reference's native serving layer (Triton Inference
// Server's C++ dynamic batcher + TRT engine host glue,
// src/f5_tts/runtime/triton_trtllm/model_repo_f5_tts/f5_tts/config.pbtxt
// dynamic_batching + model.py execute): requests are queued by duration
// bucket and grouped into batches under a max size / max queue delay, so the
// jitted XLA program runs at a bounded set of shapes with high occupancy.
// Also provides the hot host-side PCM paths (f32->i16, cross-fade, RMS).
//
// C ABI, consumed from Python via ctypes (no pybind11 in image).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Request {
  int64_t id;
  int bucket;
  Clock::time_point arrival;
};

struct Batcher {
  int max_batch;
  int64_t max_wait_us;
  std::mutex mu;
  std::condition_variable cv;
  // FIFO per duration-bucket; batches never mix buckets (one compiled shape)
  std::map<int, std::deque<Request>> queues;
  bool closed = false;

  Batcher(int mb, int64_t mw) : max_batch(mb), max_wait_us(mw) {}

  void submit(int64_t id, int bucket) {
    {
      std::lock_guard<std::mutex> lk(mu);
      queues[bucket].push_back({id, bucket, Clock::now()});
    }
    cv.notify_all();
  }

  // Pick the bucket whose head request has waited longest; release a batch
  // when it is full OR its head exceeded max_wait_us.
  int next_batch(int64_t* out_ids, int* out_bucket, int64_t timeout_us) {
    std::unique_lock<std::mutex> lk(mu);
    auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
    for (;;) {
      if (closed) return -1;
      int best_bucket = -1;
      Clock::time_point oldest;
      int64_t wait_us = 0;
      for (auto& [bucket, q] : queues) {
        if (q.empty()) continue;
        if (best_bucket < 0 || q.front().arrival < oldest) {
          best_bucket = bucket;
          oldest = q.front().arrival;
        }
      }
      if (best_bucket >= 0) {
        auto& q = queues[best_bucket];
        wait_us = std::chrono::duration_cast<std::chrono::microseconds>(
                      Clock::now() - q.front().arrival)
                      .count();
        if ((int)q.size() >= max_batch || wait_us >= max_wait_us) {
          int n = std::min<int>(max_batch, (int)q.size());
          for (int i = 0; i < n; ++i) {
            out_ids[i] = q.front().id;
            q.pop_front();
          }
          *out_bucket = best_bucket;
          return n;
        }
        // wait the residual delay for more requests to coalesce
        auto head_deadline =
            oldest + std::chrono::microseconds(max_wait_us);
        auto until = std::min(deadline, head_deadline);
        if (cv.wait_until(lk, until) == std::cv_status::timeout &&
            Clock::now() >= deadline && (int)q.size() == 0)
          return 0;
        continue;
      }
      if (cv.wait_until(lk, deadline) == std::cv_status::timeout) return 0;
    }
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv.notify_all();
  }
};

}  // namespace

extern "C" {

void* f5rt_batcher_create(int max_batch, int64_t max_wait_us) {
  return new Batcher(max_batch, max_wait_us);
}

void f5rt_batcher_destroy(void* b) { delete static_cast<Batcher*>(b); }

void f5rt_batcher_submit(void* b, int64_t id, int bucket) {
  static_cast<Batcher*>(b)->submit(id, bucket);
}

int f5rt_batcher_next(void* b, int64_t* out_ids, int* out_bucket,
                      int64_t timeout_us) {
  return static_cast<Batcher*>(b)->next_batch(out_ids, out_bucket, timeout_us);
}

void f5rt_batcher_close(void* b) { static_cast<Batcher*>(b)->close(); }

// ---- PCM hot paths --------------------------------------------------------

void f5rt_f32_to_i16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i];
    v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
    out[i] = (int16_t)lrintf(v * 32767.f);
  }
}

double f5rt_rms(const float* in, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += (double)in[i] * in[i];
  return n ? std::sqrt(acc / (double)n) : 0.0;
}

// cross-fade b onto the tail of a: out must hold na + nb - nfade samples
void f5rt_crossfade(const float* a, int64_t na, const float* b, int64_t nb,
                    int64_t nfade, float* out) {
  if (nfade > na) nfade = na;
  if (nfade > nb) nfade = nb;
  int64_t head = na - nfade;
  std::copy(a, a + head, out);
  for (int64_t i = 0; i < nfade; ++i) {
    float t = nfade > 1 ? (float)i / (float)(nfade - 1) : 1.f;
    out[head + i] = a[head + i] * (1.f - t) + b[i] * t;
  }
  std::copy(b + nfade, b + nb, out + na);
}

}  // extern "C"
