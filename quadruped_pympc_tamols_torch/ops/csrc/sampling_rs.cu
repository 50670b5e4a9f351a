// Random-sampling MPC iteration (kernel K1a) for NVIDIA Hopper (sm_90a).
//
// Replaces the main-path variant of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (random_sampling, one group, fused combine, one iteration; pl.pallas_call at :818).
// One solve is two launches on the caller's stream:
//
//   rs_rollout_kernel  one thread per sample: Philox4x32-10 noise (three-band
//                      mixture), params = incumbent + noise, per-leg spline basis
//                      product, H-step Euler SRB rollout under the force model,
//                      quadratic cost with NaN/Inf -> 1e6, all N costs written out,
//                      and the global argmin folded into one 64-bit atomicMin on
//                      (cost bits << 32 | sample index).
//   rs_extract_kernel  one small block: reads the argmin, regenerates the winner's
//                      parameters from Philox (the noise matrix is never stored),
//                      and writes [best cost, step-0 GRFs (12), one-step state (12),
//                      index, winner parameters (P)].
//
// What bounds it: operations, not bytes. W is block-diagonal per leg, so per
// sample the basis product needs H*12 x P_leg FMAs (144 x 24 at the main path),
// the rollout ~250 flops a step and the noise 4*P_leg/2 Box-Muller pairs; inputs
// and outputs are a few hundred KB. At N = 10 000 that is ~0.13 GFLOP, about
// 2 us of FP32 peak, so the kernel sits near the launch floor. The design keeps
// every sample's parameters in registers (no (P, N) noise matrix and no
// (H, 12, N) force tensor touch device memory), uses only the nonzero leg block
// of W (H*12 x P_leg, held in
// shared memory and read as broadcasts), and spreads N over ceil(N/64) blocks of
// 64 threads (157 blocks at N = 10 000, more than the 132 SMs).
//
// Costs are sums of non-negative squares or the 1e6 saturation, so their f32 bit
// patterns order like their values and the packed 64-bit atomicMin returns the
// lowest cost with the lowest index on ties (jnp.argmin / torch.argmin
// semantics). Clamps propagate NaN as torch.clamp does. The random numbers go
// through __fmul_rn/__fadd_rn so that both kernels derive bit-identical
// parameters for the winner. Build without --use_fast_math: the saturation
// depends on isnan/isinf. The device code it shares with sampling_softmax.cu
// (Philox, Box-Muller, the clamps, the SRB step, the rollout cost, the step-0
// extraction) lives in sampling_common.cuh; its noise and the extraction kernel,
// which K1e launches too, in sampling_rs.cuh.
#include "sampling_rs.cuh"

template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
rs_rollout_kernel(const RSArgs a, const float* __restrict__ w_blk,
                  const float* __restrict__ incumbent, const float* __restrict__ noise_in,
                  float* __restrict__ noise_out, float* __restrict__ costs,
                  unsigned long long* __restrict__ argmin) {
  constexpr int P = 4 * PL;
  __shared__ float w_s[H * 12 * PL];
  __shared__ float inc_s[P];
  for (int k = threadIdx.x; k < H * 12 * PL; k += blockDim.x) w_s[k] = w_blk[k];
  for (int k = threadIdx.x; k < P; k += blockDim.x) inc_s[k] = incumbent[k];
  __syncthreads();

  const int N = a.num_samples;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long key = ~0ull;
  if (i < N) {
    float prm[P];
#pragma unroll
    for (int k = 0; k < P / 4; ++k) {
      float4 z;
      if (noise_in != nullptr) {
        z = load_noise4(noise_in, N, i, k);
      } else {
        z = rs_noise4(a.seed, a.offset, a.band1, a.band2, a.sigma1, a.sigma2, a.sigma3, i, k);
      }
      if (noise_out != nullptr) store_noise4(noise_out, N, i, k, z);
      prm[4 * k + 0] = __fadd_rn(inc_s[4 * k + 0], z.x);
      prm[4 * k + 1] = __fadd_rn(inc_s[4 * k + 1], z.y);
      prm[4 * k + 2] = __fadd_rn(inc_s[4 * k + 2], z.z);
      prm[4 * k + 3] = __fadd_rn(inc_s[4 * k + 3], z.w);
    }

    const float cost = rollout_cost<H, PL>(a, w_s, prm);
    costs[i] = cost;
    key = cost_key(cost, i);
  }
  fold_argmin(key, argmin);
}

template <int H, int PL>
static int rs_launch_t(const RSArgs* a, const float* w_blk, const float* incumbent,
                       const float* noise_in, float* noise_out, float* costs,
                       unsigned long long* argmin, float* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
  rs_rollout_kernel<H, PL><<<blocks, RS_BLOCK, 0, stream>>>(*a, w_blk, incumbent, noise_in,
                                                            noise_out, costs, argmin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rs_extract_kernel<H, PL><<<1, RS_BLOCK, 0, stream>>>(*a, w_blk, incumbent, noise_in, argmin, out);
  return (int)cudaGetLastError();
}

extern "C" {

int rs_args_size(void) { return (int)sizeof(RSArgs); }

const char* rs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Returns 0, a CUDA error code, or -1 for a shape this build does not instantiate.
// Only the main path's shape is built: horizon 12, cubic splines with 2 splines
// (24 parameters per leg). Each fully unrolled instantiation adds ~30 s of nvcc.
int rs_launch(const RSArgs* a, int params_per_leg, const float* w_blk, const float* incumbent,
              const float* noise_in, float* noise_out, float* costs,
              unsigned long long* argmin, float* out, void* stream) {
  if (a->horizon != 12 || params_per_leg != 24 || a->num_samples < 1) return -1;
  return rs_launch_t<12, 24>(a, w_blk, incumbent, noise_in, noise_out, costs, argmin, out,
                             (cudaStream_t)stream);
}

}  // extern "C"
