// Random-sampling MPC iteration (kernel K1a) for NVIDIA Hopper (sm_90a).
//
// Replaces the main-path variant of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (random_sampling, one group, fused combine, one iteration; pl.pallas_call at :818).
// One solve is a memset and two launches on the caller's stream:
//
//   rollout_kernel     the shared rollout pass of sampling_common.cuh, four lanes
//                      per sample (one per leg): Philox4x32-10 noise (three-band
//                      mixture), params = incumbent + noise, the leg's spline
//                      basis rows, H-step Euler SRB rollout under the force model,
//                      quadratic cost with NaN/Inf -> 1e6, all N costs written out,
//                      and the global argmin folded into one 64-bit atomicMin on
//                      (cost bits << 32 | sample index).
//   rs_extract_kernel  one small block: reads the argmin, regenerates the winner's
//                      parameters from Philox (the noise matrix is never stored),
//                      extracts its step-0 GRFs and one-step state on four lanes,
//                      one per leg, and writes [best cost, step-0 GRFs (12),
//                      one-step state (12), index, winner parameters (P)].
//
// What bounds it: latency, not bytes or FP32 throughput. W is block-diagonal per
// leg with at most four adjacent nonzeros a row, so per sample the basis product
// needs H*12 x 4 FMAs on the rows' windows, the rollout ~250 flops a step and the
// noise 4*P_leg/2 Box-Muller pairs; inputs and outputs are a few hundred KB. At N = 10 000 that is
// ~0.13 GFLOP, about 2 us of FP32 peak, but one thread per sample left each
// scheduler less than a warp to hide the latency of a long dependent chain. The
// rollout pass therefore runs a sample on four lanes with its basis rows off the
// step loop's chain (see sampling_common.cuh); every sample's parameters stay in
// registers, and neither the noise nor the forces touch device memory.
//
// Costs are sums of non-negative squares or the 1e6 saturation, so their f32 bit
// patterns order like their values and the packed 64-bit atomicMin returns the
// lowest cost with the lowest index on ties (jnp.argmin / torch.argmin
// semantics). Clamps propagate NaN as torch.clamp does. The random numbers go
// through __fmul_rn/__fadd_rn so that both kernels derive bit-identical
// parameters for the winner. Build without --use_fast_math: the saturation
// depends on isnan/isinf. Its noise and the extraction kernel, which K1e
// launches too, are in sampling_rs.cuh.
#include "sampling_rs.cuh"

template <int H, int PL>
static int rs_launch_t(const RSArgs* a, const BasisWindow* win, const float* incumbent,
                       const float* noise_in, float* noise_out, float* costs,
                       unsigned long long* argmin, float* out, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_rollout<H, PL>(*a, RandomBands{}, StaticSource<H, PL>{win, a->num_samples, 1},
                             incumbent, noise_in, noise_out, costs, argmin, stream);
  if (err != cudaSuccess) return (int)err;
  rs_extract_kernel<H, PL><<<1, RS_BLOCK, 0, stream>>>(*a, win, incumbent, noise_in, argmin, out);
  return (int)cudaGetLastError();
}

extern "C" {

int rs_args_size(void) { return (int)sizeof(RSArgs); }

int rs_rollout_samples(void) { return ROLLOUT_SAMPLES; }

int rs_horizon(void) { return SAMPLING_H; }

int rs_params_per_leg(void) { return SAMPLING_PL; }

// Bytes of a basis window (sampling_kernel.basis_windows).
int rs_window_bytes(void) { return (int)sizeof(BasisWindow); }

const char* rs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// win: the (H*12) basis windows. Returns 0, a CUDA error code, or -1 for a shape
// this build does not instantiate (a horizon or parameter count other than
// SAMPLING_H, SAMPLING_PL) or windows that are not 16-byte aligned (the bulk
// copy's rule).
int rs_launch(const RSArgs* a, int params_per_leg, const BasisWindow* win, const float* incumbent,
              const float* noise_in, float* noise_out, float* costs,
              unsigned long long* argmin, float* out, void* stream) {
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL || a->num_samples < 1) return -1;
  if (((uintptr_t)win & 15) != 0) return -1;
  return rs_launch_t<SAMPLING_H, SAMPLING_PL>(a, win, incumbent, noise_in, noise_out, costs,
                                              argmin, out, (cudaStream_t)stream);
}

}  // extern "C"
