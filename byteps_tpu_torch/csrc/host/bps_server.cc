// bps_server: host-side key-value reduction service (the PyTorch port's
// own copy of the JAX package's summation server, byte for byte the same
// engine; built at first use by ops/_build_host.py and bound through
// ctypes in server/engine.py).
//
// Native equivalent of the reference's BytePS server (reference:
// byteps/server/server.cc — KVServer request handler + multi-threaded
// summation engine; queue.h priority queues; cpu_reducer.cc typed
// summation). Workers push gradient buckets copied off the GPU into it
// and pull the merged round back (the parameter-server path).
//
// Same capabilities, redesigned:
//   - per-key double buffer (accumulate vs serve) instead of parked pull
//     request queues (server.cc:371-404): pulls block on a condition
//     variable until the round completes, next round's pushes never
//     corrupt in-flight pulls;
//   - sticky least-loaded key→engine-thread assignment (server.h:149-173);
//   - optional priority scheduling: keys with more pushes outstanding are
//     summed first, unblocking waiters sooner (BYTEPS_SERVER_ENABLE_SCHEDULE,
//     queue.h heap compare);
//   - sync mode: first push copies, later pushes sum, all-workers-pushed
//     publishes (server.cc:290-369 COPY_FIRST/SUM_RECV/ALL_RECV);
//   - async mode: pushes sum immediately into the store, one buffer a
//     key and no round buffer, pulls never wait (server.cc:310-314,
//     BYTEPS_ENABLE_ASYNC).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <memory>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum DType : int { F32 = 0, F64 = 1, I32 = 2, I64 = 3, F16 = 4, BF16 = 5, U8 = 6 };

inline size_t dtype_size(int d) {
  switch (d) {
    case F64: case I64: return 8;
    case F32: case I32: return 4;
    case F16: case BF16: return 2;
    default: return 1;
  }
}

// ---- half-precision scalar conversions (role of reference half.h) ----
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) { man <<= 1; exp--; }
      man &= 0x3FF;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000 | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t float_to_half(float f) {
  // round-to-nearest-even, subnormal-preserving — matches numpy's
  // float32→float16 cast so native f16 sums agree with the numpy
  // reference path elementwise (the previous truncate-and-flush form
  // biased sums low by up to 1 ulp per add)
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000;
  uint32_t absf = bits & 0x7FFFFFFF;
  if (absf >= 0x7F800000)                            // inf / nan
    return (uint16_t)(sign | 0x7C00 | ((absf > 0x7F800000) ? 0x200 : 0));
  if (absf >= 0x477FF000)                            // overflow → inf
    return (uint16_t)(sign | 0x7C00);
  if (absf < 0x38800000) {                           // subnormal / zero
    if (absf < 0x33000000) return (uint16_t)sign;    // underflow → 0
    // h = round(1.man × 2^(e-103)): the 24-bit significand shifted
    // right by 126-e (e ∈ [102,112] here, so the shift is 14..24 —
    // well-defined), RNE on the dropped bits
    uint32_t shift = 126 - (absf >> 23);
    uint32_t man = (absf & 0x7FFFFF) | 0x800000;
    uint32_t h = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (h & 1))) h++;
    return (uint16_t)(sign | h);
  }
  uint32_t h = (((absf >> 23) - 112) << 10) | ((absf >> 13) & 0x3FF);
  uint32_t rem = absf & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (h & 1))) h++;  // RNE
  return (uint16_t)(sign | h);
}

inline float bf16_to_float(uint16_t h) {
  uint32_t bits = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t float_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  // round-to-nearest-even
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7FFF + lsb;
  return (uint16_t)(bits >> 16);
}

// ---- typed summation: dst += src (role of reference cpu_reducer.cc) ----
template <typename T>
void sum_typed(T* dst, const T* src, size_t n) {
#pragma omp parallel for simd
  for (size_t i = 0; i < n; ++i) dst[i] += src[i];
}

void reduce_sum(void* dst, const void* src, size_t nbytes, int dtype) {
  switch (dtype) {
    case F32: sum_typed((float*)dst, (const float*)src, nbytes / 4); break;
    case F64: sum_typed((double*)dst, (const double*)src, nbytes / 8); break;
    case I32: sum_typed((int32_t*)dst, (const int32_t*)src, nbytes / 4); break;
    case I64: sum_typed((int64_t*)dst, (const int64_t*)src, nbytes / 8); break;
    case F16: {
      size_t n = nbytes / 2;
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
#pragma omp parallel for
      for (size_t i = 0; i < n; ++i)
        d[i] = float_to_half(half_to_float(d[i]) + half_to_float(s[i]));
      break;
    }
    case BF16: {
      size_t n = nbytes / 2;
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
#pragma omp parallel for
      for (size_t i = 0; i < n; ++i)
        d[i] = float_to_bf16(bf16_to_float(d[i]) + bf16_to_float(s[i]));
      break;
    }
    default: {  // U8: saturating nonsense is worse than wrap; plain add
      uint8_t* d = (uint8_t*)dst;
      const uint8_t* s = (const uint8_t*)src;
      for (size_t i = 0; i < nbytes; ++i) d[i] += s[i];
    }
  }
}

// ---- key store ----
struct KeyStore {
  std::mutex mu;
  std::condition_variable cv;
  std::vector<char> merged;  // published result, served by pulls
  std::vector<char> accum;   // in-progress round accumulation (sync mode)
  size_t len = 0;
  int dtype = F32;
  int push_count = 0;   // engine-applied pushes this round
  int pull_count = 0;   // pulls served since publish
  uint64_t round = 0;   // published rounds
  bool ready = false;   // merged holds a publishable round result
  int tid = 0;          // sticky engine thread
};

struct Task {
  uint64_t key;
  std::vector<char> data;  // owned copy of the pushed payload
};

class Server;

class EngineThread {
 public:
  explicit EngineThread(Server* srv, int id, bool schedule)
      : srv_(srv), id_(id), schedule_(schedule),
        thread_([this] { Run(); }) {}

  ~EngineThread() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();
  }

  void Push(Task&& t) {
    // snapshot the priority BEFORE taking mu_: PushCount waits on the
    // key lock, which Apply holds across a long OMP reduce — taking it
    // under mu_ would serialize every producer (and the engine's next
    // wakeup) behind that reduce. The snapshot also refreshes counts_,
    // the cache PopNext reads instead of re-taking the key lock.
    const int count = schedule_ ? CurCount(t.key) : 0;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (schedule_) {
        const uint64_t key = t.key;
        buckets_[key].push_back(std::move(t));
        heap_.push(HeapEntry{count, seq_++, key});
        counts_[key] = count;
        ++pending_;
      } else {
        queue_.push_back(std::move(t));
      }
    }
    cv_.notify_one();
  }

  std::atomic<uint64_t> assigned_bytes{0};

  // Tasks enqueued and not yet taken by the thread: its backlog.
  uint64_t Backlog() {
    std::lock_guard<std::mutex> lk(mu_);
    return schedule_ ? (uint64_t)pending_ : (uint64_t)queue_.size();
  }

 private:
  void Run();
  bool PopNext(Task* out);   // callers hold mu_; false iff nothing queued
  int CurCount(uint64_t key);

  // Scheduled mode is a max-heap over (push count, FIFO seq) with
  // per-key FIFO buckets. Priorities go stale when a round applies or
  // publishes, but every key is sticky to ONE engine thread, so a
  // key's push count only moves while THIS thread runs Apply. Two
  // mechanisms keep the heap honest without rescanning it:
  //   - downward (publish reset): a popped entry whose snapshot no
  //     longer matches is re-pushed with the fresh count;
  //   - upward (a push applied): Run() inserts a fresh-count entry for
  //     the applied key if it still has queued tasks, so a key climbing
  //     toward publication surfaces above keys it now outranks —
  //     buried stale-low entries can never starve it.
  // Residual window: a push whose pre-lock snapshot raced the same
  // key's Apply can sit one notch low until popped-and-refreshed or
  // until the key's next Apply — a transient mis-ordering, never a
  // drop. O(log n) amortized per task vs the previous O(queue) scan
  // per pick, which went O(n^2) under deep backlogs.
  //
  // counts_ caches each queued key's last-sampled push count. Both
  // writers (Push pre-lock, Run post-Apply) sample OUTSIDE mu_ and
  // store under mu_, so PopNext's stale-entry refresh reads the cache
  // instead of calling CurCount — which takes the per-key mutex that
  // Apply holds across a long OMP reduce: the old form could park the
  // pick loop (and every producer queued on mu_ behind it) on another
  // key's in-flight reduce. Cached values are frozen while a pick
  // holds mu_, so each entry still refreshes at most once per pick —
  // no livelock; a racing producer's stale store only widens the
  // transient mis-ordering window above, never drops a task.
  struct HeapEntry {
    int count;
    uint64_t seq;
    uint64_t key;
    bool operator<(const HeapEntry& o) const {
      if (count != o.count) return count < o.count;  // higher count wins
      return seq > o.seq;                            // then FIFO
    }
  };

  Server* srv_;
  int id_;
  bool schedule_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Task> queue_;                              // FIFO mode
  std::unordered_map<uint64_t, std::deque<Task>> buckets_;  // scheduled
  std::unordered_map<uint64_t, int> counts_;  // cached push counts (mu_)
  std::priority_queue<HeapEntry> heap_;
  uint64_t seq_ = 0;
  size_t pending_ = 0;
  bool stop_ = false;
  std::thread thread_;
};

// env helper honoring both the BPS_ and legacy BYTEPS_ spellings
static const char* bps_getenv(const char* name, const char* legacy) {
  const char* v = std::getenv(name);
  if (v == nullptr && legacy != nullptr) v = std::getenv(legacy);
  return v;
}

class Server {
 public:
  Server(int num_workers, int num_threads, bool schedule, bool async_mode)
      : num_workers_(num_workers), async_(async_mode) {
    // per-stage value tracing for one key (reference:
    // BYTEPS_SERVER_DEBUG[_KEY], server.cc:115-197 printing tensor
    // value + address before/after COPY_FIRST / SUM_RECV)
    const char* dbg = bps_getenv("BPS_SERVER_DEBUG", "BYTEPS_SERVER_DEBUG");
    debug_ = dbg != nullptr && dbg[0] != '\0' && dbg[0] != '0';
    const char* dk = bps_getenv("BPS_SERVER_DEBUG_KEY",
                                "BYTEPS_SERVER_DEBUG_KEY");
    debug_key_ = dk ? (uint64_t)std::strtoull(dk, nullptr, 10) : 0;
    if (debug_)
      std::fprintf(stderr, "[bps_server] debug mode: printing key %llu\n",
                   (unsigned long long)debug_key_);
    // blocking engine: apply pushes inline in the caller thread instead
    // of queueing to engine threads (reference:
    // BYTEPS_SERVER_ENGINE_BLOCKING, server.cc:407-414)
    const char* blk = bps_getenv("BPS_SERVER_ENGINE_BLOCKING",
                                 "BYTEPS_SERVER_ENGINE_BLOCKING");
    blocking_ = blk != nullptr && blk[0] != '\0' && blk[0] != '0';
    if (blocking_)
      std::fprintf(stderr, "[bps_server] blocking engine mode enabled\n");
    if (!blocking_)
      for (int i = 0; i < num_threads; ++i)
        engines_.emplace_back(new EngineThread(this, i, schedule));
  }

  // Shutdown protocol: destroying the server while another thread is
  // blocked in Pull (e.g. a transport handler waiting on a round) must
  // not free the stores under it. dying_ flips first; every public entry
  // holds an inflight count; waiting pulls are woken to observe dying_
  // and return -5; the destructor drains inflight before freeing.
  // Publish the inflight increment BEFORE reading dying_: a caller that
  // passes the dying_ check is then guaranteed visible to the
  // destructor's drain loop (check-then-increment would let the drain
  // loop observe 0 between the two and free stores_ under the caller).
  struct CallGuard {
    std::atomic<int>& c;
    bool refused;
    CallGuard(std::atomic<int>& c, std::atomic<bool>& dying) : c(c) {
      ++c;
      refused = dying.load();
    }
    ~CallGuard() { --c; }
  };

  // Phase 1, callable separately: refuse new calls and wake blocked
  // pulls WITHOUT freeing, so a caller can drain its own layer first
  // (engine.py holds a Python-side inflight count around ctypes calls —
  // the C++ guard alone can't cover a call that reads the handle just
  // before destroy frees it).
  void BeginShutdown() {
    dying_.store(true);
    std::lock_guard<std::mutex> lk(map_mu_);
    for (auto& kv : stores_) {
      // take the key mutex between the dying_ store and the notify: a
      // Pull that read dying_=false under ks->mu must observe the store
      // before it can block, or the notify is lost and close() stalls
      // for the pull's full timeout
      std::lock_guard<std::mutex> klk(kv.second.mu);
      kv.second.cv.notify_all();
    }
  }

  ~Server() {
    BeginShutdown();
    while (inflight_.load() != 0) {
      {
        std::lock_guard<std::mutex> lk(map_mu_);
        for (auto& kv : stores_) kv.second.cv.notify_all();
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    engines_.clear();
  }

  int InitKey(uint64_t key, uint64_t nbytes, int dtype, const void* init) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    std::lock_guard<std::mutex> lk(map_mu_);
    // Idempotent: only the FIRST init allocates; later workers' inits are
    // no-ops (reference: init-push replies after all workers arrive but
    // only the first allocates, server.cc:261-289). Re-initializing would
    // wipe an in-flight round's accumulator and wedge the other workers.
    auto it = stores_.find(key);
    if (it != stores_.end()) {
      std::lock_guard<std::mutex> klk(it->second.mu);
      if (it->second.len != nbytes || it->second.dtype != dtype)
        return -4;  // conflicting re-declaration
      return 0;
    }
    auto& ks = stores_[key];  // creates
    std::lock_guard<std::mutex> klk(ks.mu);
    ks.len = nbytes;
    ks.dtype = dtype;
    ks.merged.assign(nbytes, 0);
    // async mode folds every push into the served store: no round buffer
    if (!async_) ks.accum.assign(nbytes, 0);
    ks.push_count = ks.pull_count = 0;
    ks.round = 0;
    // sticky least-loaded thread assignment (reference: server.h:149-173);
    // blocking mode has no engine threads — everything runs inline
    int best = 0;
    if (!engines_.empty()) {
      uint64_t best_load = UINT64_MAX;
      for (size_t i = 0; i < engines_.size(); ++i) {
        uint64_t l = engines_[i]->assigned_bytes.load();
        if (l < best_load) { best_load = l; best = (int)i; }
      }
      engines_[best]->assigned_bytes += nbytes;
    }
    ks.tid = best;
    if (init != nullptr) {
      std::memcpy(ks.merged.data(), init, nbytes);
      ks.ready = true;   // store initialized: async pulls may proceed
    } else {
      ks.ready = false;
    }
    return 0;
  }

  KeyStore* Find(uint64_t key) {
    std::lock_guard<std::mutex> lk(map_mu_);
    auto it = stores_.find(key);
    return it == stores_.end() ? nullptr : &it->second;
  }

  int Push(uint64_t key, const void* data, uint64_t nbytes) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || nbytes != ks->len) return -1;
    Task t;
    t.key = key;
    t.data.assign((const char*)data, (const char*)data + nbytes);
    if (blocking_) {
      // blocking engine: apply in the caller's thread (reference:
      // BYTEPS_SERVER_ENGINE_BLOCKING) — deterministic, single-threaded
      // summation for debugging at the cost of all engine overlap
      Apply(t);
      return 0;
    }
    engines_[ks->tid]->Push(std::move(t));
    return 0;
  }

  // ---- native onebit codec (reference: the server decompresses every
  // push before SUM_RECV and recompresses the merge once per round
  // inside its C++ engine, server.cc:86-113 — NOT in per-connection
  // interpreter threads). Wire layout matches the Python/JAX codecs
  // bit-exactly: ceil(n/32) uint32 words, element 0 in the TOP bit of
  // word 0 (big-endian byte order on the wire), then one LE float
  // scale. fp32 stores only; other dtypes take the Python path. ----

  // decompress payload into a dense fp32 task and enqueue like Push.
  // The ctypes caller releases the GIL, so multi-worker compressed
  // pushes decode in parallel native threads.
  int PushOnebit(uint64_t key, const void* payload, uint64_t plen) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || ks->dtype != F32) return -1;
    const size_t n = ks->len / 4;
    const size_t chunks = (n + 31) / 32;
    if (plen != chunks * 4 + 4) return -1;
    const unsigned char* raw = (const unsigned char*)payload;
    float scale;
    std::memcpy(&scale, raw + chunks * 4, 4);
    Task t;
    t.key = key;
    t.data.resize(ks->len);
    float* out = (float*)t.data.data();
    // wire words are NATIVE-endian uint32 with element i at bit
    // 31 - i%32 (the Python codec packbits MSB-first, views the bytes
    // big-endian, then converts to native order before tobytes —
    // host.py HostOnebit.compress). Branchless two-value select per
    // bit: the branchy form ran 40% slower than numpy's
    // unpackbits pipeline
    const float vals[2] = {scale, -scale};
#pragma omp parallel for
    for (size_t w = 0; w < chunks; ++w) {
      uint32_t word;
      std::memcpy(&word, raw + w * 4, 4);
      float* o = out + w * 32;
      const size_t lim = (w * 32 + 32 <= n) ? 32 : (n - w * 32);
      for (size_t j = 0; j < lim; ++j)
        o[j] = vals[(word >> (31 - j)) & 1u];
    }
    if (blocking_) {
      Apply(t);
      return 0;
    }
    engines_[ks->tid]->Push(std::move(t));
    return 0;
  }

  // ---- native topk codec. Wire: k int32 indices then k fp32 values
  // (matches _SparseCodec._pack). Selection: k largest |x|, ties to
  // the LOWER index — the Python codec's stable argsort of -|x|
  // (host.py HostTopk). Deterministic, so recompressed rounds are
  // byte-identical across pullers with no cache. fp32 stores only. ----

  int PushTopk(uint64_t key, const void* payload, uint64_t plen) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || ks->dtype != F32) return -1;
    if (plen % 8 != 0) return -1;
    const size_t kk = plen / 8;
    const size_t n = ks->len / 4;
    if (kk > n) return -1;
    const int32_t* idx = (const int32_t*)payload;
    const float* vals = (const float*)((const char*)payload + kk * 4);
    Task t;
    t.key = key;
    t.data.assign(ks->len, 0);           // scatter into zeros
    float* out = (float*)t.data.data();
    for (size_t i = 0; i < kk; ++i) {
      const int32_t j = idx[i];
      if (j < 0 || (size_t)j >= n) return -1;
      out[j] = vals[i];   // duplicate indices: LAST WINS, matching the
    }                     // Python path's scatter (out[idx] = vals) so
                          // the BPS_NATIVE_CODEC A/B stays meaningful
                          // even on malformed payloads
    if (blocking_) {
      Apply(t);
      return 0;
    }
    engines_[ks->tid]->Push(std::move(t));
    return 0;
  }

  int PullTopk(uint64_t key, void* dst, uint64_t dst_len,
               uint64_t want_round, int timeout_ms) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || ks->dtype != F32) return -1;
    if (dst_len % 8 != 0) return -1;
    const size_t kk = dst_len / 8;
    const size_t n = ks->len / 4;
    if (kk > n) return -1;
    std::vector<char> dense(ks->len);
    int rc = Pull(key, dense.data(), ks->len, want_round, timeout_ms);
    if (rc != 0) return rc;
    const float* x = (const float*)dense.data();
    std::vector<int32_t> order(n);
    for (size_t i = 0; i < n; ++i) order[i] = (int32_t)i;
    auto cmp = [x](int32_t a, int32_t b) {
      // NaN maps to -inf: deterministic, keeps the comparator a strict
      // weak ordering (fabs(NaN) comparisons would make NaN "equal" to
      // everything while finite values still order — UB in introsort),
      // and matches numpy's NaN-last argsort so the all-NaN store
      // selects indices 0..k-1 exactly like the Python codec
      float fa = std::fabs(x[a]), fb = std::fabs(x[b]);
      if (std::isnan(fa)) fa = -INFINITY;
      if (std::isnan(fb)) fb = -INFINITY;
      return fa != fb ? fa > fb : a < b;   // ties → lower index first
    };
    std::nth_element(order.begin(), order.begin() + kk, order.end(), cmp);
    std::sort(order.begin(), order.begin() + kk, cmp);
    int32_t* oidx = (int32_t*)dst;
    float* ovals = (float*)((char*)dst + kk * 4);
    for (size_t i = 0; i < kk; ++i) {
      oidx[i] = order[i];
      ovals[i] = x[order[i]];
    }
    return 0;
  }

  // pull the merged round and recompress to onebit in one native call;
  // deterministic, so every worker pulling a round gets identical bytes
  // without a cache. use_scale: L1-mean scale like the worker codec.
  int PullOnebit(uint64_t key, void* dst, uint64_t dst_len,
                 uint64_t want_round, int timeout_ms, int use_scale) {
    // own guard, like every public entry (the inner Pull's guard does
    // not cover the Find/field reads before it — see shutdown protocol)
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || ks->dtype != F32) return -1;
    const size_t n = ks->len / 4;
    const size_t chunks = (n + 31) / 32;
    if (dst_len != chunks * 4 + 4) return -1;
    std::vector<char> dense(ks->len);
    int rc = Pull(key, dense.data(), ks->len, want_round, timeout_ms);
    if (rc != 0) return rc;
    const float* x = (const float*)dense.data();
    unsigned char* out = (unsigned char*)dst;
    // one fused branchless pass: sign bits packed straight from the
    // IEEE sign bit, |x| accumulated for the L1 scale alongside
    // (native-endian uint32 words, element i at bit 31 - i%32 —
    // matches the worker codecs' wire layout, see PushOnebit)
    double l1 = 0.0;
#pragma omp parallel for reduction(+ : l1)
    for (size_t w = 0; w < chunks; ++w) {
      uint32_t word = 0;
      const size_t base = w * 32;
      const size_t lim = (base + 32 <= n) ? 32 : (n - base);
      double acc = 0.0;
      for (size_t j = 0; j < lim; ++j) {
        uint32_t bits;
        std::memcpy(&bits, &x[base + j], 4);
        word |= (bits >> 31) << (31 - j);
        acc += std::fabs((double)x[base + j]);
      }
      l1 += acc;
      std::memcpy(out + w * 4, &word, 4);
    }
    // NOTE: -0.0f packs its sign bit (x<0 would not); the Python codec
    // packs (x < 0) so -0.0 differs there — a zero gradient's sign is
    // meaningless under onebit, both decode to ±scale·0-free values
    const float scale = use_scale ? (float)(l1 / (double)n) : 1.0f;
    std::memcpy(out + chunks * 4, &scale, 4);
    return 0;
  }

  // first element of a typed buffer, for the debug tracer (reference:
  // DEBUG_PRINT_TENSOR_VALUE prints the leading scalar)
  static double FirstVal(const char* p, int dtype) {
    switch (dtype) {
      case F32: { float f; std::memcpy(&f, p, 4); return f; }
      case F64: { double d; std::memcpy(&d, p, 8); return d; }
      case I32: { int32_t v; std::memcpy(&v, p, 4); return v; }
      case I64: { int64_t v; std::memcpy(&v, p, 8); return (double)v; }
      case F16: { uint16_t h; std::memcpy(&h, p, 2); return half_to_float(h); }
      case BF16: { uint16_t h; std::memcpy(&h, p, 2); return bf16_to_float(h); }
      default: return (double)(unsigned char)p[0];
    }
  }

  void DebugStage(const char* stage, const KeyStore* ks, const char* dst,
                  const char* src, int dtype) {
    std::lock_guard<std::mutex> lk(debug_mu_);
    std::fprintf(stderr,
                 "[bps_server] stage: %s\tkey: %llu\tdst: %f\tsrc: %f\t"
                 "dst_addr: %p\tsrc_addr: %p\n",
                 stage, (unsigned long long)debug_key_, FirstVal(dst, dtype),
                 FirstVal(src, dtype), (const void*)dst, (const void*)src);
    (void)ks;
  }

  // engine-thread callback: apply one task
  void Apply(Task& t) {
    KeyStore* ks = Find(t.key);
    if (ks == nullptr) return;
    bool is_debug = debug_ && t.key == debug_key_;
    std::unique_lock<std::mutex> lk(ks->mu);
    if (async_) {
      if (is_debug)
        DebugStage("ENGINE_SUM_RECV_BEFORE", ks, ks->merged.data(),
                   t.data.data(), ks->dtype);
      // async: sum straight into the served store, no rounds
      reduce_sum(ks->merged.data(), t.data.data(), ks->len, ks->dtype);
      if (is_debug)
        DebugStage("ENGINE_SUM_RECV_AFTER", ks, ks->merged.data(),
                   t.data.data(), ks->dtype);
      ks->ready = true;
      ks->round++;
      lk.unlock();
      ks->cv.notify_all();
      return;
    }
    // COPY_FIRST vs SUM_RECV decided at apply time from push_count: a
    // round's tasks may reach the engine in any interleaving (concurrent
    // pushers, priority reordering), and summation is commutative, so
    // whichever task lands first is the copy (reference: server.cc:290-342
    // decides from updates.request.size() inside the handler).
    if (ks->push_count == 0) {
      if (is_debug)
        DebugStage("ENGINE_COPY_MERGED_TO_STORE_BEFORE", ks,
                   ks->accum.data(), t.data.data(), ks->dtype);
      std::memcpy(ks->accum.data(), t.data.data(), ks->len);
      if (is_debug)
        DebugStage("ENGINE_COPY_MERGED_TO_STORE_AFTER", ks,
                   ks->accum.data(), t.data.data(), ks->dtype);
    } else {
      if (is_debug)
        DebugStage("ENGINE_SUM_RECV_BEFORE", ks, ks->accum.data(),
                   t.data.data(), ks->dtype);
      reduce_sum(ks->accum.data(), t.data.data(), ks->len, ks->dtype);
      if (is_debug)
        DebugStage("ENGINE_SUM_RECV_AFTER", ks, ks->accum.data(),
                   t.data.data(), ks->dtype);
    }
    ks->push_count++;
    if (ks->push_count == num_workers_) {
      ks->merged.swap(ks->accum);
      ks->push_count = 0;
      ks->ready = true;
      ks->round++;
      lk.unlock();
      ks->cv.notify_all();
    }
  }

  // Pull round ``want_round`` (1-based). 0 means "latest published".
  // Round-numbered pulls replace the reference's per-sender response
  // tracking (server.cc:371-404 seen_sender_): each worker pulls the round
  // it just contributed to, so a fast worker can never be served a stale
  // round twice and a slow worker's round cannot be overwritten (the next
  // publish needs every worker's push, which follows their pull).
  int Pull(uint64_t key, void* dst, uint64_t nbytes, uint64_t want_round,
           int timeout_ms) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr || nbytes > ks->len) return -1;
    std::unique_lock<std::mutex> lk(ks->mu);
    if (async_) {
      if (!ks->ready) return -3;  // async pull before init
      std::memcpy(dst, ks->merged.data(), nbytes);
      return 0;
    }
    uint64_t want = want_round == 0 ? (ks->round > 0 ? ks->round : 1)
                                    : want_round;
#if defined(__SANITIZE_THREAD__)
    // TSAN builds only: gcc 10's libtsan does not intercept
    // pthread_cond_clockwait (GCC PR sanitizer/97868, fixed in gcc 11),
    // which libstdc++ uses for every STEADY-clock timed wait on
    // glibc >= 2.30. The un-instrumented wait releases/reacquires the
    // mutex invisibly, corrupting tsan's lock shadow — the stress
    // driver then reports impossible "double lock of a mutex" and
    // data races where two threads both "hold" the same mutex. Route
    // the wait through the REALTIME clock (pthread_cond_timedwait,
    // which this libtsan does intercept); production builds keep the
    // steady clock so a wall-clock jump cannot stretch pull timeouts.
    bool ok = ks->cv.wait_until(lk,
                                std::chrono::system_clock::now() +
                                    std::chrono::milliseconds(timeout_ms),
                                [&] { return dying_.load() ||
                                             ks->round >= want; });
#else
    bool ok = ks->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                              [&] { return dying_.load() ||
                                           ks->round >= want; });
#endif
    if (dying_.load()) return -5;  // woken by the destructor
    if (!ok) return -2;  // timeout
    std::memcpy(dst, ks->merged.data(), nbytes);
    return 0;
  }

  uint64_t Round(uint64_t key) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return 0;
    KeyStore* ks = Find(key);
    if (ks == nullptr) return 0;
    std::lock_guard<std::mutex> lk(ks->mu);
    return ks->round;
  }

  int PushCount(uint64_t key) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -5;
    KeyStore* ks = Find(key);
    if (ks == nullptr) return -1;
    std::lock_guard<std::mutex> lk(ks->mu);
    return ks->push_count;
  }

  uint64_t EngineLoad(int tid) {
    if (tid < 0 || (size_t)tid >= engines_.size()) return 0;
    return engines_[(size_t)tid]->assigned_bytes.load();
  }

  uint64_t EngineBacklog(int tid) {
    if (tid < 0 || (size_t)tid >= engines_.size()) return 0;
    return engines_[(size_t)tid]->Backlog();
  }

  int KeyThread(uint64_t key) {
    CallGuard g(inflight_, dying_);
    if (g.refused) return -1;
    KeyStore* ks = Find(key);
    return ks == nullptr ? -1 : ks->tid;
  }

  std::atomic<bool> dying_{false};
  std::atomic<int> inflight_{0};
  int num_workers_;
  bool async_;
  bool debug_ = false;
  bool blocking_ = false;
  uint64_t debug_key_ = 0;
  std::mutex debug_mu_;
  std::mutex map_mu_;
  std::unordered_map<uint64_t, KeyStore> stores_;
  std::vector<std::unique_ptr<EngineThread>> engines_;
};

int EngineThread::CurCount(uint64_t key) { return srv_->PushCount(key); }

// Priority: the key with the most pushes already applied this round is
// closest to publishing — run its tasks first (reference: queue.h
// compare on push_cnt under BYTEPS_SERVER_ENABLE_SCHEDULE). Caller
// holds mu_.
bool EngineThread::PopNext(Task* out) {
  if (!schedule_) {
    if (queue_.empty()) return false;
    *out = std::move(queue_.front());
    queue_.pop_front();
    return true;
  }
  while (!heap_.empty()) {
    HeapEntry e = heap_.top();
    auto it = buckets_.find(e.key);
    if (it == buckets_.end() || it->second.empty()) {
      heap_.pop();               // entry outlived its bucket — drop it
      continue;
    }
    // stale-entry refresh from the CACHED count (see counts_ above):
    // calling CurCount here would take the per-key mutex while holding
    // mu_ — parking the pick loop on whatever Apply that key's store
    // is in the middle of. Cached values are frozen while we hold mu_
    // (both writers store under mu_), so each entry refreshes at most
    // once per pick loop — no livelock.
    auto c = counts_.find(e.key);
    const int cur = c == counts_.end() ? e.count : c->second;
    if (cur != e.count) {
      heap_.pop();
      heap_.push(HeapEntry{cur, e.seq, e.key});
      continue;
    }
    *out = std::move(it->second.front());
    it->second.pop_front();
    if (it->second.empty()) {
      buckets_.erase(it);
      counts_.erase(e.key);      // re-seeded by the key's next Push
    }
    heap_.pop();
    --pending_;
    return true;
  }
  return false;
}

void EngineThread::Run() {
  for (;;) {
    Task t;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] {
        return stop_ || pending_ != 0 || !queue_.empty();
      });
      if (!PopNext(&t)) {
        if (stop_) return;
        continue;
      }
    }
    srv_->Apply(t);
    if (schedule_) {
      // the applied key's count just moved (one push closer to
      // publishing, or reset by the publish): surface its new rank so
      // its remaining queued tasks compete at the fresh priority.
      // Count read outside mu_ (same reasoning as Push); the store
      // refreshes counts_ so PopNext's next refresh sees it.
      const int cur = CurCount(t.key);
      std::lock_guard<std::mutex> lk(mu_);
      auto it = buckets_.find(t.key);
      if (it != buckets_.end() && !it->second.empty()) {
        heap_.push(HeapEntry{cur, seq_++, t.key});
        counts_[t.key] = cur;
      }
    }
  }
}

}  // namespace

extern "C" {

void* bps_server_create(int num_workers, int num_threads, int enable_schedule,
                        int async_mode) {
  if (num_workers <= 0 || num_threads <= 0) return nullptr;
  return new Server(num_workers, num_threads, enable_schedule != 0,
                    async_mode != 0);
}

void bps_server_destroy(void* h) { delete (Server*)h; }

void bps_server_begin_shutdown(void* h) { ((Server*)h)->BeginShutdown(); }

int bps_server_init_key(void* h, uint64_t key, uint64_t nbytes, int dtype,
                        const void* init) {
  return ((Server*)h)->InitKey(key, nbytes, dtype, init);
}

int bps_server_push(void* h, uint64_t key, const void* data, uint64_t nbytes) {
  return ((Server*)h)->Push(key, data, nbytes);
}

int bps_server_pull(void* h, uint64_t key, void* dst, uint64_t nbytes,
                    uint64_t want_round, int timeout_ms) {
  return ((Server*)h)->Pull(key, dst, nbytes, want_round, timeout_ms);
}

uint64_t bps_server_round(void* h, uint64_t key) {
  return ((Server*)h)->Round(key);
}

uint64_t bps_server_engine_load(void* h, int tid) {
  return ((Server*)h)->EngineLoad(tid);
}

// The port's addition: pushes enqueued on engine thread tid and not yet
// summed (engine_load above is the bytes of the keys assigned to it).
uint64_t bps_server_engine_backlog(void* h, int tid) {
  return ((Server*)h)->EngineBacklog(tid);
}

int bps_server_key_thread(void* h, uint64_t key) {
  return ((Server*)h)->KeyThread(key);
}

// standalone typed reducer, exposed for tests and host-side reuse
// (reference: cpu_reducer.cc sum)
void bps_reduce_sum(void* dst, const void* src, uint64_t nbytes, int dtype) {
  reduce_sum(dst, src, nbytes, dtype);
}

// native onebit codec: fused decompress→enqueue and pull→recompress
// (reference: server.cc:86-113 — codec work belongs in the engine, not
// in per-connection interpreter threads)
int bps_server_push_onebit(void* h, uint64_t key, const void* payload,
                           uint64_t plen) {
  return ((Server*)h)->PushOnebit(key, payload, plen);
}

int bps_server_pull_onebit(void* h, uint64_t key, void* dst,
                           uint64_t dst_len, uint64_t want_round,
                           int timeout_ms, int use_scale) {
  return ((Server*)h)->PullOnebit(key, dst, dst_len, want_round,
                                  timeout_ms, use_scale);
}

int bps_server_push_topk(void* h, uint64_t key, const void* payload,
                         uint64_t plen) {
  return ((Server*)h)->PushTopk(key, payload, plen);
}

int bps_server_pull_topk(void* h, uint64_t key, void* dst,
                         uint64_t dst_len, uint64_t want_round,
                         int timeout_ms) {
  return ((Server*)h)->PullTopk(key, dst, dst_len, want_round,
                                timeout_ms);
}

// ---------------------------------------------------------------------
// Standalone codec primitives (round 4). The per-key CHAIN state —
// error-feedback accumulators, momentum buffers, XorShift128+ RNG
// state — stays owned by the Python chain objects (host.py), which
// pass raw buffers / state words in and out of these calls; the
// O(n) loops run here with the GIL released. This is how every
// registered compressor chain (dithering, randomk recompress, the
// EF server chain, non-fp32 keys) leaves the Python interpreter,
// complementing the zero-Python fused fp32 paths above (reference:
// the server's engine does all codec work in C++,
// server.cc:86-113; compressor_registry.cc:40-56).
// ---------------------------------------------------------------------

// XorShift128+, bit-exact with ops/compression/rng.py (reference:
// compressor/utils.h:72-158): state {a, b}; the caller owns the words.
static inline uint64_t xorshift128p_next(uint64_t* st) {
  uint64_t t = st[0];
  const uint64_t s = st[1];
  st[0] = s;
  t ^= t << 23;
  t ^= t >> 17;
  t ^= s ^ (s >> 26);
  st[1] = t;
  return t + s;
}

// (No onebit-compress primitive: numpy's SIMD packbits runs
// FASTER than a scalar bit loop — compress stays numpy; the fused
// server paths above own the zero-Python onebit lane.)

// out[i] = ±scale from the packed bits (fp32). Matches
// HostOnebit.decompress (the dtype cast stays in Python).
void bps_codec_onebit_decompress(const unsigned char* p, uint64_t n,
                                 float* out) {
  const size_t chunks = ((size_t)n + 31) / 32;
  float scale;
  std::memcpy(&scale, p + chunks * 4, 4);
  const float vals[2] = {scale, -scale};
#pragma omp parallel for
  for (size_t w = 0; w < chunks; ++w) {
    uint32_t word;
    std::memcpy(&word, p + w * 4, 4);
    float* o = out + w * 32;
    const size_t lim = (w * 32 + 32 <= n) ? 32 : ((size_t)n - w * 32);
    for (size_t j = 0; j < lim; ++j)
      o[j] = vals[(word >> (31 - j)) & 1u];
  }
}

// k largest |x|, ties to the LOWER index, NaN ordered last — the
// Python codec's stable argsort of -|x| (HostTopk.compress). idx_out
// [k] int32, val_out [k] fp32 (dtype narrowing stays in Python).
int bps_codec_topk_select(const float* x, uint64_t n, uint64_t k,
                          int32_t* idx_out, float* val_out) {
  if (k > n) return -1;
  std::vector<int32_t> order((size_t)n);
  for (size_t i = 0; i < n; ++i) order[i] = (int32_t)i;
  auto cmp = [x](int32_t a, int32_t b) {
    float fa = std::fabs(x[a]), fb = std::fabs(x[b]);
    if (std::isnan(fa)) fa = -INFINITY;
    if (std::isnan(fb)) fb = -INFINITY;
    return fa != fb ? fa > fb : a < b;
  };
  std::nth_element(order.begin(), order.begin() + (size_t)k, order.end(),
                   cmp);
  std::sort(order.begin(), order.begin() + (size_t)k, cmp);
  for (size_t i = 0; i < k; ++i) {
    idx_out[i] = order[i];
    val_out[i] = x[order[i]];
  }
  return 0;
}

// Scatter k (idx, val) pairs into a zeroed dense fp32 buffer;
// duplicate indices LAST-WINS (the Python out[idx] = vals scatter).
int bps_codec_scatter_f32(const int32_t* idx, const float* vals,
                          uint64_t k, uint64_t n, float* out) {
  std::memset(out, 0, (size_t)n * 4);
  for (size_t i = 0; i < k; ++i) {
    const int32_t j = idx[i];
    if (j < 0 || (uint64_t)j >= n) return -1;
    out[j] = vals[i];
  }
  return 0;
}

// k sequential draws of Randint(0, n_range) from the caller's
// XorShift128+ state (updated in place) — HostRandomk's index stream,
// so the server's randomk RECOMPRESS runs native, seeded from the
// worker-synced state the Python chain maintains.
void bps_codec_xorshift_indices(uint64_t n_range, uint64_t k,
                                uint64_t* state, int32_t* idx_out) {
  for (size_t i = 0; i < k; ++i)
    idx_out[i] = (int32_t)(xorshift128p_next(state) % n_range);
}

// Seeded stochastic quantization, bit-exact with
// HostDithering.compress (LINEAR {i/s} / NATURAL {2^(i-s)} levels;
// reference: impl/dithering.{cc,h}). The RNG is SEQUENTIAL — the
// Python seeded path loops per element in the interpreter, which is
// exactly the loop that belongs here. ``scale`` is computed by the
// caller (max or L2 — numpy's pairwise L2 sum is kept on both paths
// by construction). qbits 8 → int8 out, else int16.
//
// NaN input is UNDEFINED for this codec (on both paths): the branchless
// sign below maps NaN to 0 while numpy's np.sign(NaN)*q propagates NaN
// and casts it to an unspecified int — byte equality between the native
// and Python paths is only contracted for finite gradients. A NaN
// blowup should be caught upstream (debug sampling / grad clipping),
// not inside a lossy quantizer.
void bps_codec_dithering_compress(const float* x, uint64_t n, float scale,
                                  int s, int ptype, int qbits,
                                  uint64_t* state, void* out_q) {
  const float safe = scale > 0.0f ? scale : 1.0f;
  int8_t* o8 = (int8_t*)out_q;
  int16_t* o16 = (int16_t*)out_q;
  const int LINEAR = 0;
  for (size_t i = 0; i < n; ++i) {
    // u BEFORE the branch, one draw per element, like _uniform(n)
    const double u =
        (double)xorshift128p_next(state) / 18446744073709551616.0;
    const float ax = std::fabs(x[i]);
    double q;
    if (ptype == LINEAR) {
      const float norm = ax / safe * (float)s;
      const float fl = std::floor(norm);
      q = (double)fl + (u < (double)(norm - fl) ? 1.0 : 0.0);
    } else {
      const uint32_t level = 1u << (s - 1);
      const float norm = ax / safe * (float)level;
      uint32_t c = (uint32_t)std::ceil(norm);
      uint32_t v = (c > 1 ? c : 1) - 1;          // RoundNextPow2 >> 1
      v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
      const float fl = (float)(((uint64_t)v + 1) >> 1);
      // p in FLOAT, not double: numpy 2.x's np.where keeps float32
      // (NEP 50 weak python scalars), so the reference path computes
      // the f32-rounded quotient — a double quotient here can flip
      // the u < p comparison on boundary draws (~2^-26/element)
      const float length = fl != 0.0f ? fl : 1.0f;
      const float p = (norm - fl) / length;
      q = (double)fl + (double)length * (u < (double)p ? 1.0 : 0.0);
    }
    const float sg = x[i] > 0.0f ? 1.0f : (x[i] < 0.0f ? -1.0f : 0.0f);
    const double sq = (double)sg * q;
    if (qbits <= 8) o8[i] = (int8_t)sq;
    else o16[i] = (int16_t)sq;
  }
}

// ---- bucket pack/unpack (role of core_loops.cc:538-618's zero-copy
// push/pull staging). The Python exchange's per-segment numpy slice
// assignments hold the GIL for every copy; these run the same segment
// plan as flat memcpys with the GIL released (ctypes) and OpenMP
// across segments — the uncompressed sync hop's interpreter cost
// drops to two native calls per bucket. Offsets/lengths in BYTES.

void bps_pack_segments(const void* const* srcs, const uint64_t* dst_offs,
                       const uint64_t* lens, uint64_t n, char* dst) {
#pragma omp parallel for schedule(static)
  for (uint64_t i = 0; i < n; ++i)
    std::memcpy(dst + dst_offs[i], srcs[i], lens[i]);
}

void bps_unpack_segments(const char* src, const uint64_t* src_offs,
                         void* const* dsts, const uint64_t* lens,
                         uint64_t n) {
#pragma omp parallel for schedule(static)
  for (uint64_t i = 0; i < n; ++i)
    std::memcpy(dsts[i], src + src_offs[i], lens[i]);
}

}  // extern "C"
