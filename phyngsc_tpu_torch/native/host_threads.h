// The thread pool of the port's host runtime (host_runtime.cpp beside it):
// parallel_for on std::thread, std::mutex and std::condition_variable, in
// place of the OpenMP regions of native/host_runtime.cpp. It needs only
// libstdc++ and pthreads.
//
// Guarantees:
//  - One pool a process, made at the first call that splits its range, with
//    threads() - 1 workers (the calling thread is the T-th). threads() is the
//    number of CPUs the process may use (sched_getaffinity) until
//    phyngsc_set_threads overrides it; the pool grows when T does.
//  - parallel_for(n, grain, fn) splits [0, n) into k = max(1, min(T, n /
//    grain)) contiguous chunks of near-equal size, calls fn(chunk, begin,
//    end) once for each and returns when every call has returned. The split
//    depends on n, grain and T alone; callers that reduce keep one partial a
//    chunk (chunk_count gives k beforehand) and combine them after the join,
//    so a result does not depend on which thread ran which chunk.
//  - Many threads may call at once (the pipelines' thread pools enter the
//    runtime through ctypes, which drops the GIL). A caller queues its
//    chunks 1..k-1, runs chunk 0, then runs whichever of its chunks no
//    worker has taken yet, and then waits only for its own chunks that
//    workers are running. Workers wait on nothing but the empty queue, and
//    fn never calls parallel_for, so callers cannot deadlock one another.
//  - The queue is guarded by the pool's mutex. A chunk's completion is
//    counted under its call's mutex, and a worker notifies while it holds
//    it, so the caller's frame (which holds that mutex) outlives the last
//    touch of any worker.
//  - fork: a child starts without a pool (pthread_atfork drops the parent's,
//    whose workers the child does not have) and makes its own at its first
//    split.

#pragma once

#include <pthread.h>
#include <sched.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace phyngsc {
namespace detail {

struct Call {  // one parallel_for: its chunks that have not finished
  std::mutex mu;
  std::condition_variable done;
  int pending = 0;
};

struct Item {
  Call *call;
  void (*run)(void *ctx, int chunk);
  void *ctx;
  int chunk;
};

class Pool {
 public:
  // Starts workers until there are n (under the registry's lock).
  void grow(int n) {
    while (workers_ < n) {
      std::thread(&Pool::work, this).detach();
      ++workers_;
    }
  }

  void submit(const std::vector<Item> &items) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      q_.insert(q_.end(), items.begin(), items.end());
    }
    cv_.notify_all();
  }

  // Removes one still-queued chunk of `call` into *out; false when none is
  // left (every other chunk of the call is running or finished).
  bool take(const Call *call, Item *out) {
    std::lock_guard<std::mutex> lock(mu_);
    for (auto it = q_.begin(); it != q_.end(); ++it) {
      if (it->call == call) {
        *out = *it;
        q_.erase(it);
        return true;
      }
    }
    return false;
  }

 private:
  void work() {
    for (;;) {
      Item it;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_.wait(lock, [this] { return !q_.empty(); });
        it = q_.front();
        q_.pop_front();
      }
      it.run(it.ctx, it.chunk);
      std::lock_guard<std::mutex> lock(it.call->mu);
      if (--it.call->pending == 0) it.call->done.notify_one();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Item> q_;
  int workers_ = 0;
};

// The registry: the process's pool and the lock that guards making and
// growing it. Neither is ever destroyed (workers outlive static destructors).
inline std::mutex &registry_mu() {
  static std::mutex *mu = new std::mutex;
  return *mu;
}

inline Pool *&registry_pool() {
  static Pool *pool = nullptr;
  return pool;
}

inline void before_fork() { registry_mu().lock(); }
inline void after_fork_parent() { registry_mu().unlock(); }
inline void after_fork_child() {
  registry_pool() = nullptr;  // the parent's workers do not exist here
  registry_mu().unlock();     // locked by this thread in before_fork
}

inline Pool *pool_of(int workers) {
  static bool hooked = false;
  std::lock_guard<std::mutex> lock(registry_mu());
  if (!hooked) {
    pthread_atfork(before_fork, after_fork_parent, after_fork_child);
    hooked = true;
  }
  Pool *&pool = registry_pool();
  if (pool == nullptr) pool = new Pool;
  pool->grow(workers);
  return pool;
}

inline std::atomic<int> &thread_setting() {  // 0: the affinity's count
  static std::atomic<int> t{0};
  return t;
}

inline int affinity_cpus() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0)
    return std::max(1, CPU_COUNT(&set));
  return std::max(1, (int)std::thread::hardware_concurrency());
}

// Runs run(ctx, c) for c in [0, k): c = 0 on the calling thread, the rest on
// the pool or, where no worker has taken them, on the calling thread too.
inline void run_chunks(int k, void (*run)(void *, int), void *ctx) {
  Call call;
  call.pending = k - 1;
  std::vector<Item> items;
  items.reserve(k - 1);
  for (int c = 1; c < k; ++c) items.push_back({&call, run, ctx, c});
  Pool *pool = pool_of(k - 1);
  pool->submit(items);
  run(ctx, 0);
  Item it;
  while (pool->take(&call, &it)) {
    run(ctx, it.chunk);
    std::lock_guard<std::mutex> lock(call.mu);
    --call.pending;
  }
  std::unique_lock<std::mutex> lock(call.mu);
  call.done.wait(lock, [&call] { return call.pending == 0; });
}

}  // namespace detail

// T: the threads a parallel_for may use.
inline int threads() {
  int t = detail::thread_setting().load(std::memory_order_relaxed);
  if (t > 0) return t;
  t = detail::affinity_cpus();
  int unset = 0;
  detail::thread_setting().compare_exchange_strong(unset, t);
  return detail::thread_setting().load(std::memory_order_relaxed);
}

// Sets T (t <= 0: the CPUs the process may use); returns the new T.
inline int set_threads(int t) {
  detail::thread_setting().store(t > 0 ? t : detail::affinity_cpus());
  return threads();
}

// k, the number of chunks parallel_for(n, grain, ...) splits [0, n) into at
// the current T (0 when n <= 0).
inline int chunk_count(int64_t n, int64_t grain) {
  if (n <= 0) return 0;
  const int64_t k =
      std::min<int64_t>(threads(), n / std::max<int64_t>(grain, 1));
  return (int)std::max<int64_t>(k, 1);
}

inline int64_t chunk_begin(int64_t n, int k, int c) {
  return c * (n / k) + std::min<int64_t>(c, n % k);
}

// fn(chunk, begin, end) over the k = chunk_count(n, grain) chunks of [0, n).
// k is passed by callers that size their partials from it beforehand.
template <class F>
void parallel_chunks(int64_t n, int k, F &&fn) {
  if (k <= 0) return;
  auto body = [&](int c) {
    fn(c, chunk_begin(n, k, c), chunk_begin(n, k, c + 1));
  };
  if (k == 1) {
    body(0);
    return;
  }
  using Body = decltype(body);
  detail::run_chunks(
      k, [](void *ctx, int c) { (*static_cast<Body *>(ctx))(c); }, &body);
}

template <class F>
void parallel_for(int64_t n, int64_t grain, F &&fn) {
  parallel_chunks(n, chunk_count(n, grain), fn);
}

}  // namespace phyngsc
