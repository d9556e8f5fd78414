// Threaded vectorized MuJoCo stepping engine (the port's own copy of
// harl_tpu/native/vec_mujoco.cc).
//
// Replaces the reference's per-env subprocess workers
// (harl/envs/env_wrappers.py:220-295: one OS process + Pipe round-trip per
// env per step). Here N mjData instances share one mjModel and step in a
// persistent C++ thread pool within the training process: no pickling, no
// pipes, no process scheduling; the state is written straight into
// caller-provided buffers.
//
// A plain C ABI consumed through ctypes. All buffers are row-major double
// arrays owned by the caller.
//
// Build: harl_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -std=c++17
// -pthread, linked against the mujoco wheel's libmujoco.so).

#include <mujoco/mujoco.h>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------ thread pool
class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false), pending_(0), generation_(0) {
    for (int t = 0; t < n_threads; ++t) {
      workers_.emplace_back([this, t] { Worker(t); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      ++generation_;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  // Runs fn(thread_idx, n_threads) on every worker and waits for completion.
  void Run(const std::function<void(int, int)>& fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      task_ = fn;
      pending_ = static_cast<int>(workers_.size());
      ++generation_;
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  void Worker(int idx) {
    long seen = 0;
    for (;;) {
      std::function<void(int, int)> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this, &seen] { return stop_ || generation_ != seen; });
        if (stop_) return;
        seen = generation_;
        fn = task_;
      }
      fn(idx, size());
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::function<void(int, int)> task_;
  bool stop_;
  int pending_;
  long generation_;
};

struct VecMj {
  mjModel* model = nullptr;
  std::vector<mjData*> data;
  Pool* pool = nullptr;
  int n_envs = 0;
};

}  // namespace

extern "C" {

void* vmj_create(const char* xml_path, int n_envs, int n_threads) {
  char err[1024] = {0};
  mjModel* m = mj_loadXML(xml_path, nullptr, err, sizeof(err));
  if (!m) return nullptr;
  auto* h = new VecMj;
  h->model = m;
  h->n_envs = n_envs;
  h->data.reserve(n_envs);
  for (int i = 0; i < n_envs; ++i) h->data.push_back(mj_makeData(m));
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_envs) n_threads = n_envs;
  h->pool = new Pool(n_threads);
  return h;
}

int vmj_nq(void* vh) { return static_cast<VecMj*>(vh)->model->nq; }
int vmj_nv(void* vh) { return static_cast<VecMj*>(vh)->model->nv; }
int vmj_nu(void* vh) { return static_cast<VecMj*>(vh)->model->nu; }
double vmj_timestep(void* vh) {
  return static_cast<VecMj*>(vh)->model->opt.timestep;
}

void vmj_qpos0(void* vh, double* out) {
  auto* h = static_cast<VecMj*>(vh);
  std::memcpy(out, h->model->qpos0, sizeof(double) * h->model->nq);
}

// Overwrite qpos/qvel of env idx (resets warm-start accumulators too).
void vmj_set_state(void* vh, int idx, const double* qpos, const double* qvel) {
  auto* h = static_cast<VecMj*>(vh);
  mjData* d = h->data[idx];
  mj_resetData(h->model, d);
  std::memcpy(d->qpos, qpos, sizeof(double) * h->model->nq);
  std::memcpy(d->qvel, qvel, sizeof(double) * h->model->nv);
}

// Gather qpos/qvel of all envs into (n_envs, nq) / (n_envs, nv) buffers.
void vmj_get_state(void* vh, double* qpos_out, double* qvel_out) {
  auto* h = static_cast<VecMj*>(vh);
  const int nq = h->model->nq, nv = h->model->nv;
  for (int i = 0; i < h->n_envs; ++i) {
    std::memcpy(qpos_out + static_cast<size_t>(i) * nq, h->data[i]->qpos,
                sizeof(double) * nq);
    std::memcpy(qvel_out + static_cast<size_t>(i) * nv, h->data[i]->qvel,
                sizeof(double) * nv);
  }
}

// Step every env frame_skip times with ctrl (n_envs, nu), in parallel.
// active: optional per-env byte mask (null = all active).
void vmj_step(void* vh, const double* ctrl, int frame_skip,
              const unsigned char* active) {
  auto* h = static_cast<VecMj*>(vh);
  mjModel* m = h->model;
  const int nu = m->nu, n = h->n_envs;
  h->pool->Run([=](int t, int nt) {
    for (int i = t; i < n; i += nt) {
      if (active && !active[i]) continue;
      mjData* d = h->data[i];
      std::memcpy(d->ctrl, ctrl + static_cast<size_t>(i) * nu,
                  sizeof(double) * nu);
      for (int k = 0; k < frame_skip; ++k) mj_step(m, d);
    }
  });
}

void vmj_destroy(void* vh) {
  auto* h = static_cast<VecMj*>(vh);
  delete h->pool;
  for (auto* d : h->data) mj_deleteData(d);
  mj_deleteModel(h->model);
  delete h;
}

}  // extern "C"
