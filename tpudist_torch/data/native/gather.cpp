// Native batch-assembly engine for the tpudist_torch data path (a copy of
// the JAX package's tpudist/data/native/gather.cpp; framework-free).
//
// The reference gets host-side data parallelism from torch's C++ DataLoader
// worker pool (num_workers, demo.py:150 — external native code, SURVEY.md
// §2.4 native-code ledger).  This is the equivalent: a small C++ thread
// pool that gathers dataset rows into preallocated batch buffers in the
// background, so the Python loop and the device step never wait on host
// memcpys.  Determinism stays in Python (the seeded ShardPlan permutation);
// this engine only moves bytes.
//
// C ABI (consumed via ctypes from tpudist_torch/data/native_loader.py):
//   tg_create(n_workers) -> pool*
//   tg_submit(pool, src, row_bytes, idx, n_rows, dst) -> job id
//       dst[i] = src[idx[i]] for n_rows rows of row_bytes each
//   tg_wait(pool, job)   block until done
//   tg_poll(pool, job)   1 if done, 0 otherwise
//   tg_destroy(pool)
//
// Build: g++ -O3 -shared -fPIC -pthread gather.cpp -o libtpugather.so
// (done lazily by native_loader.py; no build-system dependency).

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Job {
  int64_t id;
  const char* src;
  int64_t row_bytes;
  const int64_t* idx;
  int64_t n_rows;
  char* dst;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::unordered_set<int64_t> pending;  // submitted or running
  std::mutex mu;
  std::condition_variable work_cv;   // workers wait for jobs
  std::condition_variable done_cv;   // waiters wait for completions
  int64_t next_id = 1;
  bool stopping = false;

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        work_cv.wait(lock, [&] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      for (int64_t i = 0; i < job.n_rows; ++i) {
        std::memcpy(job.dst + i * job.row_bytes,
                    job.src + job.idx[i] * job.row_bytes,
                    static_cast<size_t>(job.row_bytes));
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        pending.erase(job.id);
      }
      done_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* tg_create(int n_workers) {
  auto* pool = new Pool();
  if (n_workers < 1) n_workers = 1;
  pool->workers.reserve(n_workers);
  for (int i = 0; i < n_workers; ++i) {
    pool->workers.emplace_back([pool] { pool->run(); });
  }
  return pool;
}

int64_t tg_submit(void* handle, const void* src, int64_t row_bytes,
                  const int64_t* idx, int64_t n_rows, void* dst) {
  auto* pool = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> lock(pool->mu);
  int64_t id = pool->next_id++;
  pool->pending.insert(id);
  pool->queue.push_back(Job{id, static_cast<const char*>(src), row_bytes, idx,
                            n_rows, static_cast<char*>(dst)});
  pool->work_cv.notify_one();
  return id;
}

int tg_wait(void* handle, int64_t job) {
  auto* pool = static_cast<Pool*>(handle);
  std::unique_lock<std::mutex> lock(pool->mu);
  pool->done_cv.wait(lock, [&] { return pool->pending.count(job) == 0; });
  return 0;
}

int tg_poll(void* handle, int64_t job) {
  auto* pool = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> lock(pool->mu);
  return pool->pending.count(job) == 0 ? 1 : 0;
}

void tg_destroy(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  {
    std::lock_guard<std::mutex> lock(pool->mu);
    pool->stopping = true;
  }
  pool->work_cv.notify_all();
  for (auto& t : pool->workers) t.join();
  delete pool;
}

}  // extern "C"
