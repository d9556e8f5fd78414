// GAE and discounted-return recursions over time, one thread per column.
//
// Replaces the two Pallas TPU kernels of harl_tpu/ops/pallas_gae.py:
//   gae_pallas / _gae_kernel                       -> harl_gae
//   discounted_returns_pallas / _returns_kernel    -> harl_discounted_returns
//
// Layout: time-major (T, b) row-major float32, where b is the product of the
// trailing dims. values, masks and bad_masks are the (T+1, b) tensors the
// caller holds; the kernel reads rows t and t+1 through offsets instead of
// materialising shifted copies, and masks the ragged last block itself (no
// padding of b).
//
// Bound: each element is read once and the output written once, so the
// kernel moves ~(4*T + 3)*b*4 bytes (GAE with bad masks) and does ~8 flops
// per element: it is bound by bytes. At the main-path shape (T=32, b=4096)
// that is ~2.7 MB, ~0.8 us at 3.35 TB/s. A thread walks t = T-1 .. 0 with
// the carry in a register; at every t the threads of a warp read 32
// neighbouring floats of one row, so every load and store coalesces. With
// b=4096 only 32 blocks of 128 threads exist, far fewer than the 132 SMs can
// hold, so the kernel is latency-bound at that size.
//
// Plain C interface, loaded with ctypes (harl_tpu_torch/ops/_build.py). Each
// entry returns cudaGetLastError() after the launch; 0 means launched.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void gae_kernel(const float* __restrict__ rew,
                           const float* __restrict__ val,
                           const float* __restrict__ mask,
                           const float* __restrict__ bad,
                           float* __restrict__ out,
                           int T, int b, float gamma, float gamma_lam) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  // delta_t = r_t + g*V_{t+1}*m_{t+1} - V_t
  // gae_t   = (delta_t + g*lam*m_{t+1}*gae_{t+1}) * bad_{t+1}
  // out_t   = gae_t + V_t
  float v_next = val[static_cast<size_t>(T) * b + j];
  float gae = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * b + j;
    const size_t n = i + b;
    const float m = mask[n];
    const float v = val[i];
    const float delta = rew[i] + gamma * v_next * m - v;
    gae = delta + gamma_lam * m * gae;
    if (bad != nullptr) gae *= bad[n];
    out[i] = gae + v;
    v_next = v;
  }
}

__global__ void returns_kernel(const float* __restrict__ rew,
                               const float* __restrict__ val,
                               const float* __restrict__ mask,
                               const float* __restrict__ bad,
                               const float* __restrict__ next_value,
                               float* __restrict__ out,
                               int T, int b, float gamma) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  // ret_t = (ret_{t+1}*g*m_{t+1} + r_t)*bad_{t+1} + (1 - bad_{t+1})*V_t
  float ret = next_value[j];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * b + j;
    const size_t n = i + b;
    const float bm = bad != nullptr ? bad[n] : 1.0f;
    ret = (ret * gamma * mask[n] + rew[i]) * bm + (1.0f - bm) * val[i];
    out[i] = ret;
  }
}

}  // namespace

extern "C" int harl_gae(const float* rew, const float* val, const float* mask,
                        const float* bad, float* out, int T, int b,
                        float gamma, float gamma_lam, void* stream) {
  if (T <= 0 || b <= 0) return 0;
  const int grid = (b + kBlock - 1) / kBlock;
  gae_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rew, val, mask, bad, out, T, b, gamma, gamma_lam);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int harl_discounted_returns(const float* rew, const float* val,
                                       const float* mask, const float* bad,
                                       const float* next_value, float* out,
                                       int T, int b, float gamma,
                                       void* stream) {
  if (T <= 0 || b <= 0) return 0;
  const int grid = (b + kBlock - 1) / kBlock;
  returns_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      rew, val, mask, bad, next_value, out, T, b, gamma);
  return static_cast<int>(cudaGetLastError());
}
