// GAE and discounted-return recursions over time, staged through shared
// memory with every load in flight before the recursion waits on any.
//
// Replaces the two Pallas TPU kernels of harl_tpu/ops/pallas_gae.py:
//   gae_pallas / _gae_kernel                       -> harl_gae
//   discounted_returns_pallas / _returns_kernel    -> harl_discounted_returns
//
// Layout: time-major (T, b) row-major float32, where b is the product of the
// trailing dims. values, masks and bad_masks are the (T+1, b) tensors the
// caller holds; rows t and t+1 are read in place through offsets, and the
// ragged last tile is masked here (no padding of b).
//
// Bound: each element is read once and the output written once, so GAE with
// bad masks moves (5T+1)*b*4 bytes and does ~8 flops an element: it is bound
// by bytes. At the main path's shape (T=32, b=4096) that is 2.64 MB, 0.787 us
// at an H100 SXM's 3.35 TB/s.
//
// Why the earlier design was latency-bound: one thread per column walked
// t = T-1 .. 0 and loaded its four inputs for step t only when it reached t,
// in blocks of 128 threads. None of those loads depends on the carry, but
// each step still waited on its own: at T=32, b=4096 that is 32 dependent
// L2 round trips in 32 blocks on 132 SMs, 5.0-5.2 us on an NVIDIA H100 80GB
// HBM3 at a 700 W power limit, 15% of the bound; 255 us at T=1024.
//
// This design: a block of kThreads threads owns W consecutive columns
// (W = 8, 16 or 32, chosen by the caller so that the main path's shape gives
// at least 128 blocks). Time is cut into chunks of Tc rows, walked from the
// last backwards through a ring of kStages shared-memory stages. All threads
// of the block copy a chunk's row segments (rewards and values rows t, masks
// and bad masks rows t+1) into a stage with cp.async, one commit group a
// chunk; the first kStages chunks are issued before the recursion waits, and
// each stage is refilled with the chunk kStages further down as soon as the
// recursion has left it. Tc is all of T up to 1024/W rows, so the main path
// (T=32, W=32) and the SMACLite FP shape (T=70, b=1280, W=8) are one chunk:
// every load of the block in flight at once, one wait, one barrier. Rows
// are copied 16 bytes at a time where every base pointer is 16-byte aligned
// and b is a multiple of 4, 4 bytes at a time otherwise.
//
// The recursion is the plain version's: one thread per column walks t
// downwards with the carry in a register, in the same per-step arithmetic
// (no reassociation over time). It reads the stage kGroup rows at a time,
// all loads of a group before its first step, and steps a precomputed
// output pointer back one row a step, so that the dependent chain holds
// nothing but the carry's multiply-adds: with the loads inside each step
// (where a branch per step lets the compiler sink them), or the store's
// address rebuilt in it, each step waited on a shared-memory load or on
// that address. V_{t+1} at a chunk's top edge is the register v_next left
// by the chunk above; the first chunk takes V_T (GAE) or next_value (the
// returns) from global memory. With bad_masks=None the bad plane holds ones,
// which leave each step exact.
//
// Measured on the same card (scripts/torch_gae_turns.py, in turns with the
// earlier design): 3.1 us at T=32, b=4096 (the earlier 5.0), 3.8 us at T=70,
// b=1280 (8.6), 33 us at T=1024, b=4096 (255, bound 25); an empty launch
// back to back takes 1.7 us there, so a time within twice the bound at the
// main path's shape (1.57 us) is below what one launch can reach.
//
// The geometry (W, Tc, stages, shared bytes, grid) is computed by
// harl_tpu_torch/ops/gae_kernels.py:_launch_geometry and checked here.
// Plain C interface, loaded with ctypes (harl_tpu_torch/ops/_build.py). Each
// entry returns a cudaError_t: cudaErrorInvalidValue for a geometry it does
// not take, else cudaGetLastError() after the launch; 0 means launched.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kArrays = 4;                  // rewards, values, masks, bad masks
constexpr int kGroup = 8;                   // rows the recursion loads at once
constexpr int kDefaultSmem = 48 * 1024;     // above this only after the opt-in
constexpr int kMaxSmem = 232448;            // 227 KB, a block's most on sm_90

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Problem {
  const float* rew;    // (T, b)
  const float* val;    // (T+1, b); rows 0..T-1 are staged
  const float* mask;   // (T+1, b); rows 1..T are staged
  const float* bad;    // (T+1, b) or null; rows 1..T are staged
  const float* init;   // b floats: V_T for GAE, next_value for the returns
  float* out;          // (T, b)
  int T, b, Tc;
  float gamma, gamma_lam;
};

// Copies chunk k (rows k*Tc .. min(T, (k+1)*Tc) - 1) of the block's W
// columns into one stage: [array][row][column], Tc*W floats an array.
template <int W, int VEC>
__device__ __forceinline__ void stage_chunk(const Problem& p, float* stage, int k, int j0) {
  constexpr int kVecs = W / VEC;
  const int t0 = k * p.Tc;
  const int rows = min(p.Tc, p.T - t0);
  const int plane = p.Tc * W;
  for (int idx = threadIdx.x; idx < rows * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * VEC;
    if (j0 + c >= p.b) continue;   // VEC == 4 only when b % 4 == 0: whole vectors
    const size_t i = static_cast<size_t>(t0 + r) * p.b + j0 + c;
    float* d = stage + r * W + c;
    cp_async<VEC>(d, p.rew + i);
    cp_async<VEC>(d + plane, p.val + i);
    cp_async<VEC>(d + 2 * plane, p.mask + i + p.b);
    if (p.bad != nullptr) cp_async<VEC>(d + 3 * plane, p.bad + i + p.b);
  }
}

template <bool kGae, int W, int VEC>
__global__ void __launch_bounds__(kThreads) recursion_kernel(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.x * W;
  const int nchunks = (p.T + p.Tc - 1) / p.Tc;
  const int plane = p.Tc * W;
  const int stage_floats = kArrays * plane;

  // The carry's seed, loaded first: the first step waits on it and on the
  // first chunk together. GAE: carry = gae_{t+1} (0 at T), v_next = V_{t+1}.
  // Returns: carry = ret_{t+1}, seeded with next_value.
  const int col = j0 + static_cast<int>(threadIdx.x);
  const bool walks = threadIdx.x < W && col < p.b;
  const float seed = walks ? p.init[col] : 0.0f;
  float carry = kGae ? 0.0f : seed;
  float v_next = kGae ? seed : 0.0f;

  // Chunks are walked from the last (k = nchunks-1) down; the i-th of them
  // goes through stage i % kStages. One commit group per chunk, empty ones
  // included, so that waiting for chunk i is always wait_group(kStages-1).
  for (int s = 0; s < kStages; ++s) {
    if (nchunks - 1 - s >= 0) stage_chunk<W, VEC>(p, smem + s * stage_floats, nchunks - 1 - s, j0);
    cp_async_commit();
  }
  if (p.bad == nullptr) {
    // no truncations: bad masks of 1, which leave every step exact
    for (int i = threadIdx.x; i < min(nchunks, kStages) * plane; i += kThreads) {
      smem[(i / plane) * stage_floats + 3 * plane + i % plane] = 1.0f;
    }
  }

  for (int i = 0; i < nchunks; ++i) {
    const int k = nchunks - 1 - i;
    float* stage = smem + (i % kStages) * stage_floats;
    cp_async_wait<kStages - 1>();
    __syncthreads();   // every thread's copies of chunk k have landed
    if (walks) {
      const int t0 = k * p.Tc;
      const float* s = stage + threadIdx.x;
      const long long b = p.b;
      float* o = p.out + (t0 + min(p.Tc, p.T - t0) - 1) * b + col;   // row `top`
      // kGroup rows at a time, from row `top` down: every shared load of the
      // group first, then the dependent steps with nothing between them but
      // arithmetic and a store to a pointer stepped back one row at a time.
      // A group that reaches below row 0 (the last of a ragged chunk) reads
      // row 0 in their place and masks those steps with selects.
      auto group = [&](auto masked, int top) {
        constexpr bool kMasked = decltype(masked)::value;
        float rw[kGroup], v[kGroup], m[kGroup], bm[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int r = kMasked ? max(top - u, 0) : top - u;
          rw[u] = s[r * W];
          v[u] = s[plane + r * W];
          m[u] = s[2 * plane + r * W];
          bm[u] = s[3 * plane + r * W];
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const bool live = !kMasked || top - u >= 0;
          float next, out;
          if constexpr (kGae) {
            // delta_t = r_t + g*V_{t+1}*m_{t+1} - V_t
            // gae_t   = (delta_t + g*lam*m_{t+1}*gae_{t+1}) * bad_{t+1}
            // out_t   = gae_t + V_t
            const float delta = rw[u] + p.gamma * v_next * m[u] - v[u];
            next = (delta + p.gamma_lam * m[u] * carry) * bm[u];
            out = next + v[u];
            v_next = live ? v[u] : v_next;
          } else {
            // ret_t = (ret_{t+1}*g*m_{t+1} + r_t)*bad_{t+1} + (1 - bad_{t+1})*V_t
            next = (carry * p.gamma * m[u] + rw[u]) * bm[u] + (1.0f - bm[u]) * v[u];
            out = next;
          }
          carry = live ? next : carry;
          if (live) *o = out;
          o -= b;
        }
      };
      int top = min(p.Tc, p.T - t0) - 1;
      for (; top >= kGroup - 1; top -= kGroup) group(std::false_type{}, top);
      if (top >= 0) group(std::true_type{}, top);
    }
    __syncthreads();   // the stage is free again
    if (k - kStages >= 0) stage_chunk<W, VEC>(p, stage, k - kStages, j0);
    cp_async_commit();
  }
}

template <bool kGae, int W, int VEC>
int launch(const Problem& p, int smem_bytes, int grid, cudaStream_t stream) {
  auto kernel = recursion_kernel<kGae, W, VEC>;
  if (smem_bytes > kDefaultSmem) {
    // once per kernel: allow dynamic shared memory up to the block's maximum
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <bool kGae>
int dispatch(const Problem& p, int W, int stages, int smem_bytes, int grid, void* stream) {
  if (p.T <= 0 || p.b <= 0) return 0;
  const int nchunks = (p.T + p.Tc - 1) / p.Tc;
  const int slots = nchunks < kStages ? nchunks : kStages;   // ring stages in use
  const bool geometry_ok =
      (W == 8 || W == 16 || W == 32) && p.Tc >= 1 && stages == kStages &&
      grid == (p.b + W - 1) / W &&
      smem_bytes == slots * kArrays * p.Tc * W * static_cast<int>(sizeof(float)) &&
      smem_bytes <= kMaxSmem;
  if (!geometry_ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = p.b % 4 == 0 && aligned16(p.rew) && aligned16(p.val) &&
                    aligned16(p.mask) && aligned16(p.bad);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8:
      return vec4 ? launch<kGae, 8, 4>(p, smem_bytes, grid, s)
                  : launch<kGae, 8, 1>(p, smem_bytes, grid, s);
    case 16:
      return vec4 ? launch<kGae, 16, 4>(p, smem_bytes, grid, s)
                  : launch<kGae, 16, 1>(p, smem_bytes, grid, s);
    default:
      return vec4 ? launch<kGae, 32, 4>(p, smem_bytes, grid, s)
                  : launch<kGae, 32, 1>(p, smem_bytes, grid, s);
  }
}

}  // namespace

extern "C" int harl_gae(const float* rew, const float* val, const float* mask,
                        const float* bad, float* out, int T, int b, int W, int Tc,
                        int stages, int smem_bytes, int grid, float gamma,
                        float gamma_lam, void* stream) {
  const Problem p{rew, val, mask, bad, val + static_cast<size_t>(T) * b, out,
                  T, b, Tc, gamma, gamma_lam};
  return dispatch<true>(p, W, stages, smem_bytes, grid, stream);
}

extern "C" int harl_discounted_returns(const float* rew, const float* val,
                                       const float* mask, const float* bad,
                                       const float* next_value, float* out, int T,
                                       int b, int W, int Tc, int stages,
                                       int smem_bytes, int grid, float gamma,
                                       void* stream) {
  const Problem p{rew, val, mask, bad, next_value, out, T, b, Tc, gamma, 0.0f};
  return dispatch<false>(p, W, stages, smem_bytes, grid, stream);
}
