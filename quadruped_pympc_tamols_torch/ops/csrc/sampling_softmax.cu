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
// sqrt, clipped). Chained iterations (K1d) run in one launch of the chain kernel
// (sampling_chain.cu), which runs these passes' device code. One iteration here is
// a memset (the argmin key and the update pass's ticket) and two launches:
//
//   rollout_kernel     the shared rollout pass of sampling_common.cuh, four lanes
//                      per sample (one per leg): Philox4x32-10 normals times sigma
//                      (sigma_mppi, or CEM's per-parameter sigma), params =
//                      incumbent + noise, the H-step rollout of K1a, all N costs
//                      written out, beta folded into a 64-bit atomicMin on
//                      (cost bits << 32 | index).
//   sm_update_kernel   the update pass of sampling_softmax.cuh, one block per 64
//                      samples: w = exp(-(c - beta)/T); the samples whose weight is
//                      not 0 compacted and their noise read back (noise_in, or the
//                      noise the rollout pass wrote to noise_out); each block's
//                      (P + 1) partial row of (w * noise, w) and, for CEM, its K
//                      lowest keys (K <= SM_KMAX). The
//                      block that takes the last ticket sums the partials in block
//                      order and writes incumbent + S / Z, then on warp 0 the
//                      step-0 GRFs and one-step state of the new parameters (four
//                      lanes, one per leg) and, for CEM, on warps 4-15 the global K
//                      lowest of the B*K candidate keys (above SM_KMAX elites: a
//                      radix select over the N keys), those elites' noise and the
//                      sigma refit. Output layout as K1a: [beta, grf(12),
//                      state(12), index of beta, new parameters (P)], plus sigma'
//                      (P) and the elite indices (K) for CEM.
//
// What bounds it: the rollout pass, as in K1a (latency; see sampling_common.cuh),
// plus ~2P + 20 flops per sample for the weight and the weighted sum. No float
// atomicAdd: every sum runs in a fixed order, so the same inputs give the same
// bits from run to run. Samples whose weight underflows to exactly 0 are skipped.
// Keys order like (cost, index), so the elites are
// the lowest costs with the lowest index first on ties, as jax.lax.top_k picks
// them: ties are real at the 1e6 saturation.
#include "sampling_softmax.cuh"

template <int H, int PL>
static int sm_launch_t(const RSArgs* a, const SMKnobs* kn, const BasisWindow* win,
                       const float* incumbent, const float* sigma_in, const float* noise_in,
                       float* noise_out, float* costs, unsigned long long* argmin,
                       float* partials, unsigned long long* block_keys, float* out,
                       float* sigma_out, int* elites, int phases, const float* beta_in,
                       float* sums_out, cudaStream_t stream) {
  if (phases & SM_PHASE_ROLLOUT) {
    cudaError_t err = cudaMemsetAsync(argmin, 0xFF, 2 * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_rollout<H, PL>(*a, scaled_normals(*kn, sigma_in),
                               StaticSource<H, PL>{win, a->num_samples, 1}, incumbent, noise_in,
                               noise_out, costs, argmin, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(phases & SM_PHASE_UPDATE)) return 0;
  return (int)launch_update<PL>(*a, *kn, win, incumbent, noise_in ? noise_in : noise_out,
                                costs, argmin, partials, block_keys, out, sigma_out, elites,
                                stream, beta_in, sums_out);
}

extern "C" {

int sm_args_size(void) { return (int)sizeof(RSArgs); }

int sm_knobs_size(void) { return (int)sizeof(SMKnobs); }

int sm_block(void) { return RS_BLOCK; }

int sm_rollout_samples(void) { return ROLLOUT_SAMPLES; }

// The most elites whose CEM keeps per-block key lists; above it the radix select.
int sm_list_elite(void) { return SM_KMAX; }

int sm_horizon(void) { return SAMPLING_H; }

int sm_params_per_leg(void) { return SAMPLING_PL; }

// Bytes of a basis window (sampling_kernel.basis_windows).
int sm_window_bytes(void) { return (int)sizeof(BasisWindow); }

// The phase bits of sm_launch (ops/sampling_softmax.py checks its constants).
int sm_phase_rollout(void) { return SM_PHASE_ROLLOUT; }

int sm_phase_update(void) { return SM_PHASE_UPDATE; }

// Blocks of the update pass that one SM holds at once for an iteration of
// num_samples samples (cem, n_elite as SMKnobs), from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus a CUDA error code.
int sm_update_blocks_per_sm(int cem, int n_elite, int num_samples) {
  return update_blocks_per_sm<SAMPLING_PL>(cem, n_elite, num_samples);
}

const char* sm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One MPPI (kn->cem == 0) or CEM-MPPI iteration. Scratch: argmin (2: the argmin key
// and the update pass's ticket), partials (B, P + 1) and, for CEM with K <= SM_KMAX,
// block_keys (B, K), with B = ceil(N / sm_block()); block_keys and partials 16-byte
// aligned. CEM takes 2 <= K <= N elites; above SM_KMAX they are selected from the
// costs, block_keys is not read, and elites lists them in index order (else in
// (cost, index) order).
// sigma_in, sigma_out and elites are read or written only for CEM. The update
// pass reads the iteration's noise back: noise_in, or else noise_out, which the
// rollout pass fills, so one of them must be given. Returns 0, a CUDA error code,
// or -1 for a shape or knob this build does not take (a horizon or parameter
// count other than SAMPLING_H, SAMPLING_PL), no noise buffer, or windows (as
// rs_launch's) or partials that are not 16-byte aligned.
//
// phases: SM_PHASE_ROLLOUT (the memset and the rollout pass), SM_PHASE_UPDATE
// (the update pass, after a launch of the rollout phase with the same buffers),
// or both, the whole iteration. A sample-sharded solve runs them apart, to merge
// the shards' lowest costs between them: beta_in (one float on the card), if not
// nullptr, is then the weights' beta in place of this launch's lowest cost, and
// sums_out (P + 1), if not nullptr, receives the unnormalized sums [S (P), Z] of
// the finish. The default (both phases, two nullptrs) is the plain iteration.
int sm_launch(const RSArgs* a, const SMKnobs* kn, int params_per_leg, const BasisWindow* win,
              const float* incumbent, const float* sigma_in, const float* noise_in,
              float* noise_out, float* costs, unsigned long long* argmin, float* partials,
              unsigned long long* block_keys, float* out, float* sigma_out, int* elites,
              int phases, const float* beta_in, float* sums_out, void* stream) {
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL || a->num_samples < 1) return -1;
  if (phases < 1 || phases > (SM_PHASE_ROLLOUT | SM_PHASE_UPDATE)) return -1;
  if (((uintptr_t)win & 15) != 0) return -1;
  if (!(kn->temperature > 0.f)) return -1;
  if ((noise_in == nullptr && noise_out == nullptr) || ((uintptr_t)partials & 15) != 0) return -1;
  if (kn->cem && (kn->n_elite < 2 || kn->n_elite > a->num_samples)) return -1;
  return sm_launch_t<SAMPLING_H, SAMPLING_PL>(a, kn, win, incumbent, sigma_in, noise_in,
                                              noise_out, costs, argmin, partials, block_keys,
                                              out, sigma_out, elites, phases, beta_in, sums_out,
                                              (cudaStream_t)stream);
}

}  // extern "C"
