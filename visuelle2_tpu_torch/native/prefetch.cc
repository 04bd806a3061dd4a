// Native batch-assembly engine of the port's data plane
// (visuelle2_tpu_torch/native/__init__.py binds it with ctypes).
//
// Images are decoded once into a uint8 store (data/images.py); what is left
// on the hot path of a batch is a gather of whole image rows, about 34 MB
// for a 128 x 299 x 299 x 3 batch.  This library runs that gather on a pool
// of worker threads, into a buffer the caller owns, so the loader assembles
// batch t + 1 while the card runs batch t.
//
// Ownership: jobs are shared_ptr-managed; the queue, every worker that
// touches a job and the Python-side handle each hold a reference, so a wait
// on the consumer side never frees memory a worker still reads.
//
// A plain C ABI for ctypes.  Build: g++ -O3 -shared -fPIC -pthread
// prefetch.cc -o libprefetch.so (native/__init__.py does it at first use).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct GatherJob {
  const uint8_t* src = nullptr;
  int64_t row_bytes = 0;
  std::vector<int64_t> indices;
  uint8_t* dst = nullptr;
  std::atomic<int64_t> next_chunk{0};
  std::atomic<int64_t> done_chunks{0};
  int64_t num_chunks = 0;
  int64_t chunk_rows = 0;
  std::mutex m;
  std::condition_variable cv;

  bool finished() const { return done_chunks.load() == num_chunks; }
};

using JobPtr = std::shared_ptr<GatherJob>;

void ProcessChunks(const JobPtr& job) {
  for (;;) {
    int64_t chunk = job->next_chunk.fetch_add(1);
    if (chunk >= job->num_chunks) return;
    int64_t row0 = chunk * job->chunk_rows;
    int64_t row1 = std::min<int64_t>(row0 + job->chunk_rows,
                                     (int64_t)job->indices.size());
    for (int64_t r = row0; r < row1; ++r) {
      std::memcpy(job->dst + r * job->row_bytes,
                  job->src + job->indices[r] * job->row_bytes,
                  job->row_bytes);
    }
    if (job->done_chunks.fetch_add(1) + 1 == job->num_chunks) {
      std::lock_guard<std::mutex> lk(job->m);
      job->cv.notify_all();
    }
  }
}

class Engine {
 public:
  explicit Engine(int num_threads) {
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~Engine() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  JobPtr Submit(const uint8_t* src, int64_t row_bytes, const int64_t* indices,
                int64_t n, uint8_t* dst) {
    auto job = std::make_shared<GatherJob>();
    job->src = src;
    job->row_bytes = row_bytes;
    job->indices.assign(indices, indices + n);
    job->dst = dst;
    int64_t rows_per_chunk =
        std::max<int64_t>(1, (2 << 20) / std::max<int64_t>(1, row_bytes));
    job->chunk_rows = rows_per_chunk;
    job->num_chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
    {
      std::lock_guard<std::mutex> lk(m_);
      queue_.push_back(job);
    }
    cv_.notify_all();
    return job;
  }

  static void Wait(const JobPtr& job) {
    std::unique_lock<std::mutex> lk(job->m);
    job->cv.wait(lk, [&job] { return job->finished(); });
  }

 private:
  void WorkerLoop() {
    for (;;) {
      JobPtr job;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        // Drop fully-claimed jobs from the front; take a shared ref to the
        // first job with unclaimed chunks.
        while (!queue_.empty() &&
               queue_.front()->next_chunk.load() >= queue_.front()->num_chunks) {
          queue_.pop_front();
        }
        if (queue_.empty()) continue;
        job = queue_.front();
      }
      ProcessChunks(job);
    }
  }

  std::vector<std::thread> workers_;
  std::deque<JobPtr> queue_;
  std::mutex m_;
  std::condition_variable cv_;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* prefetch_engine_create(int num_threads) { return new Engine(num_threads); }

void prefetch_engine_destroy(void* engine) { delete static_cast<Engine*>(engine); }

void* prefetch_gather_submit(void* engine, const uint8_t* src,
                             int64_t row_bytes, const int64_t* indices,
                             int64_t n, uint8_t* dst) {
  auto job = static_cast<Engine*>(engine)->Submit(src, row_bytes, indices, n, dst);
  // Hand Python an owning reference (released in prefetch_gather_wait).
  return new JobPtr(std::move(job));
}

void prefetch_gather_wait(void* handle) {
  auto* job = static_cast<JobPtr*>(handle);
  // The calling thread helps finish the job instead of just blocking.
  ProcessChunks(*job);
  Engine::Wait(*job);
  delete job;
}

void prefetch_gather(void* engine, const uint8_t* src, int64_t row_bytes,
                     const int64_t* indices, int64_t n, uint8_t* dst) {
  void* h = prefetch_gather_submit(engine, src, row_bytes, indices, n, dst);
  prefetch_gather_wait(h);
}

}  // extern "C"
