// Async dependency engine: vars + read/write dependencies + worker pool.
//
// Reference contract: src/engine/threaded_engine.cc ThreadedEngine::Push /
// ThreadedVar::{AppendReadDependency,CompleteReadDependency,...} and
// naive_engine.cc [U] (SURVEY.md §2.1) — every operation declares const
// (read) and mutable (write) vars; per-var FIFO with shared readers and
// exclusive writers; exceptions captured per-op and rethrown at sync
// points (WaitForVar/WaitAll), as exercised by the reference's
// tests/python/unittest/test_exc_handling.py [U].
//
// In the port (a copy of the JAX package's native/engine.cc): CUDA
// streams already order DEVICE work, so this engine schedules the HOST
// side of the framework — data-pipeline stages, checkpoint writes,
// python callbacks — with the same var-dependency protocol the
// reference used for everything.  The work function is a C callback
// (ctypes trampoline from python) that must call eng_on_complete(),
// possibly from another thread later, so async completions (e.g. an
// IO thread finishing a decode) compose with the dependency graph.
//
// Build: compiled into the port's host library by _native.py.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Opr;

// Dependency token a var hands to an opr: read (shared) or write
// (exclusive), granted strictly in push order per var.
struct Var {
  std::mutex mu;
  // Pending tokens in FIFO order.  first = opr, second = is_write.
  std::deque<std::pair<Opr*, bool>> queue;
  int active_readers = 0;
  bool active_writer = false;
  // Sticky async error from the last failed writer; inherited by
  // later oprs and rethrown at WaitForVar.
  std::string error;
  bool has_error = false;
  bool to_delete = false;
};

// skipped=1 means a dependency failed: the callback must NOT run the
// user body, only release its payload and call eng_on_complete (the
// inherited error keeps propagating var-to-var in CompleteOpr).
typedef void (*EngFn)(void* payload, void* complete_handle, int skipped);

struct Signal {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;

  void Notify() {
    // notify under the lock: the waiter owns this Signal on its stack
    // and frees it the moment Wait() returns — notifying after unlock
    // would race that free.
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return done; });
  }
};

struct Opr {
  EngFn fn = nullptr;          // nullptr => internal (delete-var / signal)
  void* payload = nullptr;
  std::vector<Var*> const_vars;
  std::vector<Var*> mut_vars;
  int priority = 0;
  uint64_t seq = 0;            // FIFO tiebreak within a priority class
  std::atomic<int> wait{0};    // ungranted tokens remaining
  std::string name;
  std::string inherited_error; // first error seen on a dep var
  Signal* notify = nullptr;    // fired right before the opr is freed
  struct Engine* engine = nullptr;
};

struct OprOrder {
  bool operator()(Opr* a, Opr* b) const {
    if (a->priority != b->priority) return a->priority < b->priority;
    return a->seq > b->seq;  // lower seq first
  }
};

struct Engine {
  bool naive = false;
  std::vector<std::thread> workers;
  std::mutex task_mu;
  std::condition_variable task_cv;
  std::priority_queue<Opr*, std::vector<Opr*>, OprOrder> tasks;
  bool shutdown = false;

  std::atomic<uint64_t> seq{0};
  std::atomic<int64_t> pending{0};     // pushed, not yet completed
  std::atomic<uint64_t> executed{0};

  // Serializes token APPENDING across an op's whole var set.  Without
  // it, two concurrent pushes can enqueue in opposite orders on two
  // vars (X ahead of Y on A, Y ahead of X on B) and the grant-at-
  // append / hold-until-complete protocol deadlocks — TSAN's scheduler
  // hits this reliably in the random-stress test.  Atomic appends give
  // a single total order of ops per var set; grants pop a FIFO prefix,
  // so "X blocked on a token Y holds" implies Y precedes X on that var
  // and a wait cycle is impossible.  Lock order: push_mu -> var.mu;
  // CompleteOpr takes var.mu only (pops grants, never appends).
  std::mutex push_mu;

  std::mutex wait_mu;
  std::condition_variable wait_cv;     // signaled on every completion

  std::mutex err_mu;
  std::vector<std::string> global_errors;  // drained by WaitAll
};

void Schedule(Engine* e, Opr* op);

// Grant head-of-queue tokens that can run now.  Called with var->mu held.
void DispatchVar(Engine* e, Var* v, std::vector<Opr*>* ready) {
  while (!v->queue.empty()) {
    auto& head = v->queue.front();
    bool is_write = head.second;
    if (is_write) {
      if (v->active_readers > 0 || v->active_writer) break;
      v->active_writer = true;
    } else {
      if (v->active_writer) break;
      ++v->active_readers;
    }
    Opr* op = head.first;
    v->queue.pop_front();
    if (v->has_error && op->inherited_error.empty())
      op->inherited_error = v->error;
    if (op->wait.fetch_sub(1) == 1) ready->push_back(op);
    if (is_write) break;  // nothing can follow a granted writer
  }
}

void ExecuteOpr(Engine* e, Opr* op);

void Schedule(Engine* e, Opr* op) {
  if (e->naive || e->workers.empty()) {
    // Naive engine: the pushing thread executes inline (push blocked
    // until deps cleared, which in naive mode they already are).
    ExecuteOpr(e, op);
    return;
  }
  {
    std::lock_guard<std::mutex> lk(e->task_mu);
    e->tasks.push(op);
  }
  e->task_cv.notify_one();
}

void CompleteOpr(Opr* op, const char* err) {
  Engine* e = op->engine;
  std::string error = op->inherited_error;
  if (err && *err) error = err;  // own failure wins over inherited

  std::vector<Opr*> ready;
  for (Var* v : op->const_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    --v->active_readers;
    DispatchVar(e, v, &ready);
  }
  std::vector<Var*> dead;
  for (Var* v : op->mut_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->active_writer = false;
    if (!error.empty()) { v->error = error; v->has_error = true; }
    DispatchVar(e, v, &ready);
    if (v->to_delete && v->queue.empty() && v->active_readers == 0 &&
        !v->active_writer)
      dead.push_back(v);
  }
  for (Var* v : dead) delete v;
  if (!error.empty() && op->fn) {
    std::lock_guard<std::mutex> lk(e->err_mu);
    e->global_errors.push_back(op->name.empty() ? error
                                                : op->name + ": " + error);
  }
  e->executed.fetch_add(1);
  Signal* notify = op->notify;
  delete op;
  for (Opr* r : ready) Schedule(e, r);
  {
    // Decrement + notify under wait_mu: a waiter in eng_wait_all /
    // eng_destroy may delete the Engine the instant it observes
    // pending==0, so nothing may touch *e after this block — and the
    // notify must be inside the lock or it could land on freed memory.
    std::lock_guard<std::mutex> lk(e->wait_mu);
    e->pending.fetch_sub(1);
    e->wait_cv.notify_all();
  }
  if (notify) notify->Notify();
}

void ExecuteOpr(Engine* e, Opr* op) {
  if (!op->fn) {  // internal op (delete-var marker / wait signal)
    CompleteOpr(op, nullptr);
    return;
  }
  // The callback owns completion: it must call eng_on_complete(op, err),
  // synchronously or from any other thread later.  On skip it still
  // fires so the caller can release the payload (no closure leaks).
  op->fn(op->payload, op, op->inherited_error.empty() ? 0 : 1);
}

void WorkerLoop(Engine* e) {
  for (;;) {
    Opr* op = nullptr;
    {
      std::unique_lock<std::mutex> lk(e->task_mu);
      e->task_cv.wait(lk, [&] { return e->shutdown || !e->tasks.empty(); });
      if (e->shutdown && e->tasks.empty()) return;
      op = e->tasks.top();
      e->tasks.pop();
    }
    ExecuteOpr(e, op);
  }
}

int FillErr(const std::string& msg, char* buf, int len) {
  if (msg.empty()) return 0;
  if (buf && len > 0) {
    std::snprintf(buf, static_cast<size_t>(len), "%s", msg.c_str());
  }
  return 1;
}

}  // namespace

extern "C" {

void* eng_create(int num_workers, int naive) {
  auto* e = new Engine();
  e->naive = naive != 0;
  if (!e->naive) {
    if (num_workers <= 0) num_workers = 4;
    for (int i = 0; i < num_workers; ++i)
      e->workers.emplace_back(WorkerLoop, e);
  }
  return e;
}

void eng_destroy(void* h) {
  auto* e = static_cast<Engine*>(h);
  {
    std::unique_lock<std::mutex> lk(e->wait_mu);
    e->wait_cv.wait(lk, [&] { return e->pending.load() == 0; });
  }
  {
    std::lock_guard<std::mutex> lk(e->task_mu);
    e->shutdown = true;
  }
  e->task_cv.notify_all();
  for (auto& t : e->workers) t.join();
  delete e;
}

void* eng_new_var(void* /*h*/) { return new Var(); }

static Opr* MakeOpr(Engine* e, EngFn fn, void* payload, void** const_vars,
                    int n_const, void** mut_vars, int n_mut, int priority,
                    const char* name) {
  auto* op = new Opr();
  op->engine = e;
  op->fn = fn;
  op->payload = payload;
  op->priority = priority;
  op->seq = e->seq.fetch_add(1);
  if (name) op->name = name;
  // Dedupe, and drop const vars that are also mutated: a read token
  // queued behind the same op's write token would deadlock the var.
  for (int i = 0; i < n_mut; ++i) {
    Var* v = static_cast<Var*>(mut_vars[i]);
    bool dup = false;
    for (Var* u : op->mut_vars) dup = dup || (u == v);
    if (!dup) op->mut_vars.push_back(v);
  }
  for (int i = 0; i < n_const; ++i) {
    Var* v = static_cast<Var*>(const_vars[i]);
    bool dup = false;
    for (Var* u : op->const_vars) dup = dup || (u == v);
    for (Var* u : op->mut_vars) dup = dup || (u == v);
    if (!dup) op->const_vars.push_back(v);
  }
  return op;
}

// Append tokens to every dep var; opr runs when all are granted.
static void PushOpr(Engine* e, Opr* op) {
  e->pending.fetch_add(1);
  int n = static_cast<int>(op->const_vars.size() + op->mut_vars.size());
  op->wait.store(n + 1);  // +1 guard so it can't fire mid-append
  std::vector<Opr*> ready;
  {
    std::lock_guard<std::mutex> plk(e->push_mu);
    for (Var* v : op->const_vars) {
      std::lock_guard<std::mutex> lk(v->mu);
      v->queue.emplace_back(op, false);
      DispatchVar(e, v, &ready);
    }
    for (Var* v : op->mut_vars) {
      std::lock_guard<std::mutex> lk(v->mu);
      v->queue.emplace_back(op, true);
      DispatchVar(e, v, &ready);
    }
  }
  if (op->wait.fetch_sub(1) == 1) ready.push_back(op);  // drop the guard
  for (Opr* r : ready) Schedule(e, r);
}

int eng_push(void* h, EngFn fn, void* payload, void** const_vars,
             int n_const, void** mut_vars, int n_mut, int priority,
             const char* name) {
  auto* e = static_cast<Engine*>(h);
  auto* op = MakeOpr(e, fn, payload, const_vars, n_const, mut_vars, n_mut,
                     priority, name);
  if (e->naive) {
    // Block until THIS op completed (deps are already clear in naive
    // mode, but on_complete may arrive from another thread).
    Signal sig;
    op->notify = &sig;
    PushOpr(e, op);
    sig.Wait();
  } else {
    PushOpr(e, op);
  }
  return 0;
}

void eng_on_complete(void* opr_handle, const char* err) {
  auto* op = static_cast<Opr*>(opr_handle);
  CompleteOpr(op, err);
}

void eng_delete_var(void* h, void* var) {
  auto* e = static_cast<Engine*>(h);
  auto* v = static_cast<Var*>(var);
  bool free_now = false;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    v->to_delete = true;
    free_now = v->queue.empty() && v->active_readers == 0 &&
               !v->active_writer;
  }
  // If busy, the last CompleteOpr touching it frees it; but a var only
  // reaches that path as a mut var.  Push a no-op writer so read-only
  // vars are reaped too.
  if (free_now) {
    delete v;
  } else {
    void* mv[1] = {v};
    auto* op = MakeOpr(e, nullptr, nullptr, nullptr, 0, mv, 1, 1 << 20,
                       "delete_var");
    PushOpr(e, op);
  }
}

// Blocks until every opr touching `var` at call time completed.
// Returns 1 + fills err_buf if the var carries an async error.
int eng_wait_for_var(void* h, void* var, char* err_buf, int err_len) {
  auto* e = static_cast<Engine*>(h);
  auto* v = static_cast<Var*>(var);
  Signal sig;
  void* cv[1] = {v};
  auto* op = MakeOpr(e, nullptr, nullptr, cv, 1, nullptr, 0, 1 << 20,
                     "wait_for_var");
  op->notify = &sig;
  PushOpr(e, op);
  sig.Wait();
  std::string msg;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->has_error) msg = v->error;
  }
  return FillErr(msg, err_buf, err_len);
}

// Blocks until the engine drains.  Returns 1 + first async error (and
// clears the global error list), 0 if clean.
int eng_wait_all(void* h, char* err_buf, int err_len) {
  auto* e = static_cast<Engine*>(h);
  {
    std::unique_lock<std::mutex> lk(e->wait_mu);
    e->wait_cv.wait(lk, [&] { return e->pending.load() == 0; });
  }
  std::string msg;
  {
    std::lock_guard<std::mutex> lk(e->err_mu);
    if (!e->global_errors.empty()) {
      msg = e->global_errors.front();
      e->global_errors.clear();
    }
  }
  return FillErr(msg, err_buf, err_len);
}

int64_t eng_num_pending(void* h) {
  return static_cast<Engine*>(h)->pending.load();
}

uint64_t eng_num_executed(void* h) {
  return static_cast<Engine*>(h)->executed.load();
}

// Clear a var's sticky error (reference: exception cleared once thrown).
void eng_clear_var_error(void* /*h*/, void* var) {
  auto* v = static_cast<Var*>(var);
  std::lock_guard<std::mutex> lk(v->mu);
  v->has_error = false;
  v->error.clear();
}

}  // extern "C"
