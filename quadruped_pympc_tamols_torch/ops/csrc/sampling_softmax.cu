// MPPI and CEM-MPPI iterations (kernels K1b and K1c) for NVIDIA Hopper (sm_90a).
//
// Replaces the mppi and cem_mppi variants of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (pl.pallas_call at :818): the softmax partials (:475-484) and their log-sum-exp
// merge (:510-529), the per-tile top-K (:538-569), the global elite merge
// (:571-602) and the sigma refit (:604-623). It follows the XLA solver's forms
// (controllers/sampling/sampling_mpc.py:166-176): new parameters = incumbent +
// sum_i w_i noise_i / sum_i w_i with w_i = exp(-(c_i - beta)/T) and beta the lowest
// cost; CEM refits sigma from the K lowest-cost samples' noise (ddof 1, + 1e-8,
// sqrt, clipped). Chained iterations (K1d) are successive launches of this
// function on one stream: each reads the previous one's parameters and sigma from
// device memory. One iteration is a memset and three launches:
//
//   rollout_kernel     the shared rollout pass of sampling_common.cuh, four lanes
//                      per sample (one per leg): Philox4x32-10 normals times sigma
//                      (sigma_mppi, or CEM's per-parameter sigma), params =
//                      incumbent + noise, the H-step rollout of K1a, all N costs
//                      written out, beta folded into a 64-bit atomicMin on
//                      (cost bits << 32 | index).
//   sm_weights_kernel  one thread per sample: w = exp(-(c - beta)/T); samples whose
//                      weight is not 0 regenerate their noise from its Philox
//                      counter. Each block sums its 64 rows of (w * noise, w)
//                      through shared memory in thread order and writes one row of
//                      (B, P + 1) partials. For CEM each block also ranks its keys
//                      and writes its K lowest to a (B, K) buffer.
//   sm_finish_kernel   one block: sums the partials over blocks in block order,
//                      writes incumbent + S / Z; for CEM merges the B*K candidate
//                      keys into the global K lowest (K rounds of a block min),
//                      regenerates those elites' noise and refits sigma; then the
//                      step-0 GRFs and one-step state of the new parameters.
//                      Output layout as K1a: [beta, grf(12), state(12), index of
//                      beta, new parameters (P)], plus sigma' (P) and the elite
//                      indices (K) for CEM.
//
// What bounds it: the rollout pass, as in K1a (latency; see sampling_common.cuh),
// plus ~2P + 20 flops per sample for the weight and the weighted sum. No float
// atomicAdd: every sum runs in a fixed order, so the same inputs give the same
// bits from run to run. At T = 1 most weights underflow to exactly 0, and those samples skip the
// regeneration. Keys order like (cost, index), so the elites are the lowest costs
// with the lowest index first on ties, as jax.lax.top_k picks them: ties are real
// at the 1e6 saturation.
#include "sampling_softmax.cuh"

template <int H, int PL>
static int sm_launch_t(const RSArgs* a, const SMKnobs* kn, const float* w_blk,
                       const float* incumbent, const float* sigma_in, const float* noise_in,
                       float* noise_out, float* costs, unsigned long long* argmin,
                       float* partials, unsigned long long* block_keys, float* out,
                       float* sigma_out, int* elites, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_rollout<H, PL>(*a, scaled_normals(*kn, sigma_in),
                             StaticSource<H, PL>{w_blk, a->num_samples, 1}, incumbent, noise_in,
                             noise_out, costs, argmin, stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
  sm_weights_kernel<PL><<<blocks, RS_BLOCK, 0, stream>>>(*a, *kn, sigma_in, noise_in, costs,
                                                         argmin, partials, block_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sm_finish_kernel<PL><<<1, SM_FINISH_THREADS, 0, stream>>>(
      *a, *kn, w_blk, incumbent, sigma_in, noise_in, argmin, partials, block_keys, blocks, out,
      sigma_out, elites);
  return (int)cudaGetLastError();
}

extern "C" {

int sm_args_size(void) { return (int)sizeof(RSArgs); }

int sm_knobs_size(void) { return (int)sizeof(SMKnobs); }

int sm_block(void) { return RS_BLOCK; }

int sm_rollout_samples(void) { return ROLLOUT_SAMPLES; }

int sm_max_elite(void) { return SM_KMAX; }

const char* sm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One MPPI (kn->cem == 0) or CEM-MPPI iteration. Scratch: argmin (1), partials
// (B, P + 1) and, for CEM, block_keys (B, K), with B = ceil(N / sm_block()).
// sigma_in, sigma_out and elites are read or written only for CEM. Returns 0, a
// CUDA error code, or -1 for a shape or knob this build does not take or a basis
// that is not 16-byte aligned. Only the main path's shape is built: horizon 12,
// 24 parameters per leg.
int sm_launch(const RSArgs* a, const SMKnobs* kn, int params_per_leg, const float* w_blk,
              const float* incumbent, const float* sigma_in, const float* noise_in,
              float* noise_out, float* costs, unsigned long long* argmin, float* partials,
              unsigned long long* block_keys, float* out, float* sigma_out, int* elites,
              void* stream) {
  if (a->horizon != 12 || params_per_leg != 24 || a->num_samples < 1) return -1;
  if (((uintptr_t)w_blk & 15) != 0) return -1;
  if (!(kn->temperature > 0.f)) return -1;
  if (kn->cem && (kn->n_elite < 2 || kn->n_elite > SM_KMAX || kn->n_elite > a->num_samples))
    return -1;
  return sm_launch_t<12, 24>(a, kn, w_blk, incumbent, sigma_in, noise_in, noise_out, costs,
                             argmin, partials, block_keys, out, sigma_out, elites,
                             (cudaStream_t)stream);
}

}  // extern "C"
