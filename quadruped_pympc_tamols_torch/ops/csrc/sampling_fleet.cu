// Scenario-axis sampling iterations (kernel K1f) for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the card's counterpart of the JAX scenario
// fleet's solve, quadruped_pympc_tamols_tpu/parallel/scenario_engine.py, which
// jax.vmaps the XLA solver controllers/sampling/sampling_mpc.py:make_sampling_solver
// over the scenarios. K1a-K1c solve one problem a launch with the tick's inputs
// riding the launch by value, so S scenarios would cost S launches and S host
// round trips a tick. Here one iteration for all S scenarios is a memset (every
// scenario's argmin key and ticket) and two launches:
//
//   fleet_rollout_kernel  the rollout pass of sampling_common.cuh over a grid
//                         (ceil(N/16), S): block (x, s) stages scenario s's row of
//                         the tick buffer [state (12) | effective feet (12) | ref
//                         (12) | contact (H, 4) | share (H, 4)] and its Philox
//                         seed and offset into a shared copy of the argument
//                         block, bulk-copies the shared basis, and runs K1a's
//                         draw_params and lane_rollout_cost on it: noise keyed on
//                         (the scenario's seed, its offset + iteration, the sample
//                         index within the scenario), sample 0 the incumbent,
//                         costs (S, N), and one 64-bit atomicMin a scenario.
//   then, over the S scenarios: K1a's extraction (rs_extract) in one block a
//   scenario, or the update pass of sampling_softmax.cuh (update_tile,
//   last_ticket, update_finish) over a grid (ceil(N/64), S) with each scenario's
//   own beta, partials, elites, sigma refit and completion ticket.
//
// At S = 1 with K1a's seed and offset the arithmetic is K1a's (K1b's, K1c's),
// so the costs and outputs are theirs bit for bit.
//
// What bounds it: at the fleet's small N (128 samples, 8 rollout blocks a
// scenario) the rollout pass is latency-bound as K1a is (see sampling_common.cuh);
// at S * N = 640 000 (64 scenarios of 10 000) it has 40 000 blocks, 300 a SM, and
// the SMs' issue rate for the rollout's ~250 flops a step and the basis product
// becomes the limit. The bytes stay small: the noise, for MPPI and CEM, is the
// one large buffer (S, P, N), written once and read back once.
#include "sampling_rs.cuh"
#include "sampling_softmax.cuh"

// Floats of a scenario's row of the tick buffer (before padding to scen_stride).
#define FLEET_ROW(H) (36 + 8 * (H))

// The launch's layout, passed by value beside RSArgs (whose per-tick fields the
// fleet takes from the tick buffer, not from here).
struct FleetArgs {
  int num_scenarios;  // S
  int scen_stride;    // floats between two scenarios' rows of the tick buffer
  int inc_stride;     // floats between two scenarios' incumbents
  int iteration;      // added to every scenario's Philox offset
  int part_stride;    // floats of a scenario's partials (a multiple of 4)
  int key_stride;     // words of a scenario's CEM block keys (even)
};

// a_s = a with scenario s's per-tick fields, seed and offset, in shared memory, by
// the whole block; ends in a barrier.
template <int H>
__device__ __forceinline__ void stage_scenario(const RSArgs& a, const FleetArgs& f,
                                               const float* __restrict__ scen,
                                               const unsigned long long* __restrict__ seeds,
                                               const unsigned long long* __restrict__ offsets,
                                               int s, RSArgs* a_s) {
  static_assert(sizeof(RSArgs) % 4 == 0, "the argument block copies as words");
  const int* src = reinterpret_cast<const int*>(&a);
  int* dst = reinterpret_cast<int*>(a_s);
  for (int k = threadIdx.x; k < (int)(sizeof(RSArgs) / 4); k += blockDim.x) dst[k] = src[k];
  __syncthreads();
  const float* row = scen + (size_t)s * f.scen_stride;
  for (int k = threadIdx.x; k < FLEET_ROW(H); k += blockDim.x) {
    const float v = __ldg(&row[k]);
    if (k < 12) {
      a_s->state[k] = v;
    } else if (k < 24) {
      a_s->feet[k - 12] = v;
    } else if (k < 36) {
      a_s->ref[k - 24] = v;
    } else if (k < 36 + 4 * H) {
      a_s->contact[k - 36] = v;
    } else {
      a_s->share[k - 36 - 4 * H] = v;
    }
  }
  if (threadIdx.x == 0) {
    a_s->seed = __ldg(&seeds[s]);
    a_s->offset = __ldg(&offsets[s]) + (unsigned long long)f.iteration;
  }
  __syncthreads();
}

// The rollout pass with a scenario axis; METHOD 0 random sampling (K1a's bands),
// 1 MPPI, 2 CEM-MPPI (normals times sigma_mppi or the scenario's sigma).
template <int H, int PL, int METHOD>
__global__ void __launch_bounds__(ROLLOUT_THREADS, ROLLOUT_MIN_BLOCKS)
fleet_rollout_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                     const float sigma_mppi, const float* __restrict__ w_blk,
                     const float* __restrict__ scen, const unsigned long long* __restrict__ seeds,
                     const unsigned long long* __restrict__ offsets,
                     const float* __restrict__ incumbent, const float* __restrict__ sigma,
                     const float* __restrict__ noise_in, float* __restrict__ noise_out,
                     float* __restrict__ costs, unsigned long long* __restrict__ argmin) {
  static_assert(ROLLOUT_LANES == 4, "one lane per leg");
  constexpr int P = 4 * PL;
  constexpr int PLP = padded_pl(PL);
  constexpr int bytes = H * 12 * PLP * 4;
  static_assert(bytes % 16 == 0, "bulk copies move multiples of 16 bytes");
  __shared__ __align__(16) float w_s[H * 12 * PLP];
  __shared__ __align__(16) RSArgs a_s;
  __shared__ __align__(8) unsigned long long bar;
  const int s = blockIdx.y;
  if (threadIdx.x == 0) bulk_barrier_init(&bar);
  stage_scenario<H>(a, f, scen, seeds, offsets, s, &a_s);
  if (threadIdx.x == 0) {
    bulk_expect(&bar, bytes);
    bulk_load(w_s, w_blk, bytes, &bar);
  }

  // The noise and the parameters overlap the copy: they do not read it.
  const int N = a.num_samples;
  const size_t PN = (size_t)P * N;
  const int leg = threadIdx.x % ROLLOUT_LANES;
  const int j = blockIdx.x * ROLLOUT_SAMPLES + threadIdx.x / ROLLOUT_LANES;
  const bool live = j < N;
  const int i = live ? j : N - 1;
  const float* inc = incumbent + (size_t)s * f.inc_stride;
  const float* nin = noise_in != nullptr ? noise_in + s * PN : nullptr;
  float* nout = noise_out != nullptr ? noise_out + s * PN : nullptr;
  float prm[PL];
  if constexpr (METHOD == 0) {
    draw_params<PL, Read::ReadOnly>(a_s, RandomBands{}, a_s.offset, inc, nin, nout, i, live, leg,
                                    prm);
  } else {
    const ScaledNormals<> noise{METHOD == 2 ? sigma + (size_t)s * P : nullptr, sigma_mppi};
    draw_params<PL, Read::ReadOnly>(a_s, noise, a_s.offset, inc, nin, nout, i, live, leg, prm);
  }
  bulk_wait(&bar, 0);

  const float cost = lane_rollout_cost<H, PL>(a_s, w_s, prm, a_s.contact, a_s.share, leg);
  if (live && leg == 0) costs[(size_t)s * N + j] = cost;
  fold_argmin(live ? cost_key(cost, j) : ~0ull, argmin + 2 * s);
}

// Random sampling's extraction, one block a scenario: K1a's rs_extract on the
// scenario's staged arguments, argmin key, incumbent and output row.
template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
fleet_extract_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                     const float* __restrict__ w_blk, const float* __restrict__ scen,
                     const unsigned long long* __restrict__ seeds,
                     const unsigned long long* __restrict__ offsets,
                     const float* __restrict__ incumbent, const float* __restrict__ noise_in,
                     const unsigned long long* __restrict__ argmin, float* __restrict__ out) {
  constexpr int P = 4 * PL;
  __shared__ __align__(16) RSArgs a_s;
  const int s = blockIdx.x;
  stage_scenario<H>(a, f, scen, seeds, offsets, s, &a_s);
  const float* nin =
      noise_in != nullptr ? noise_in + (size_t)s * P * a.num_samples : nullptr;
  rs_extract<PL, Read::ReadOnly>(a_s, a_s.offset, w_blk, incumbent + (size_t)s * f.inc_stride,
                                 nin, argmin[2 * s], out + (size_t)s * (RS_OUT_WINNER + P));
}

// The update pass with a scenario axis: block (b, s) runs tile b of scenario s;
// the scenario's last block to take its ticket finishes it on the scenario's
// staged arguments. argmin holds (key, ticket) pairs, one a scenario.
template <int H, int PL>
__global__ void __launch_bounds__(SM_UPDATE_THREADS, SM_UPDATE_MIN_BLOCKS)
fleet_update_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                    const SMKnobs kn, const float* __restrict__ w_blk,
                    const float* __restrict__ scen, const unsigned long long* __restrict__ seeds,
                    const unsigned long long* __restrict__ offsets,
                    const float* __restrict__ incumbent, const float* __restrict__ noise,
                    const float* __restrict__ costs, unsigned long long* argmin,
                    float* partials, unsigned long long* block_keys, float* __restrict__ out,
                    float* __restrict__ sigma_out, int* __restrict__ elites) {
  constexpr int P = 4 * PL;
  extern __shared__ __align__(16) unsigned char arena[];
  __shared__ __align__(16) RSArgs a_s;
  const int s = blockIdx.y;
  const int N = a.num_samples;
  float inc_r[(P + SM_COL_THREADS - 1) / SM_COL_THREADS];
  finish_incumbent<PL, Read::ReadOnly>(incumbent + (size_t)s * f.inc_stride, inc_r);
  const unsigned long long best_key = argmin[2 * s];
  const float* noise_s = noise + (size_t)s * P * N;
  float* part_s = partials + (size_t)s * f.part_stride;
  unsigned long long* keys_s = kn.cem ? block_keys + (size_t)s * f.key_stride : nullptr;
  update_tile<PL, Read::ReadOnly>(a, kn, noise_s, costs + (size_t)s * N,
                                  __uint_as_float((unsigned int)(best_key >> 32)), blockIdx.x,
                                  part_s, keys_s, arena);
  if (!last_ticket(argmin + 2 * s + 1, gridDim.x)) return;
  __threadfence();
  stage_scenario<H>(a, f, scen, seeds, offsets, s, &a_s);
  update_finish<PL, Read::ReadOnly>(a_s, kn, w_blk, inc_r, noise_s, best_key, gridDim.x, part_s,
                                    keys_s, out + (size_t)s * (RS_OUT_WINNER + P),
                                    kn.cem ? sigma_out + (size_t)s * P : nullptr,
                                    kn.cem ? elites + (size_t)s * kn.n_elite : nullptr, arena);
}

// Above 48 KB of dynamic shared memory needs an opt-in, given once for the most
// the update pass can ask for (as update_opt_in does for sm_update_kernel).
template <int H, int PL>
static cudaError_t fleet_update_opt_in() {
  static bool opted_in = false;
  if (opted_in) return cudaSuccess;
  const int most = sm_tile_bytes(4 * PL, SM_TILE_ROWS) + (SM_STAGE_KEYS + SM_KMAX * SM_KMAX) * 8;
  cudaError_t err = cudaFuncSetAttribute(fleet_update_kernel<H, PL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fleet_update_kernel<H, PL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  opted_in = err == cudaSuccess;
  return err;
}

template <int H, int PL>
static int fleet_launch_t(const RSArgs* a, const FleetArgs* f, const SMKnobs* kn, int method,
                          const float* w_blk, const float* scen, const unsigned long long* seeds,
                          const unsigned long long* offsets, const float* incumbent,
                          const float* sigma_in, const float* noise_in, float* noise_out,
                          float* costs, unsigned long long* argmin, float* partials,
                          unsigned long long* block_keys, float* out, float* sigma_out,
                          int* elites, cudaStream_t stream) {
  const int S = f->num_scenarios;
  cudaError_t err =
      cudaMemsetAsync(argmin, 0xFF, 2 * (size_t)S * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a->num_samples + ROLLOUT_SAMPLES - 1) / ROLLOUT_SAMPLES, S);
  if (method == 0) {
    fleet_rollout_kernel<H, PL, 0><<<grid, ROLLOUT_THREADS, 0, stream>>>(
        *a, *f, kn->sigma_mppi, w_blk, scen, seeds, offsets, incumbent, sigma_in, noise_in,
        noise_out, costs, argmin);
  } else if (method == 1) {
    fleet_rollout_kernel<H, PL, 1><<<grid, ROLLOUT_THREADS, 0, stream>>>(
        *a, *f, kn->sigma_mppi, w_blk, scen, seeds, offsets, incumbent, sigma_in, noise_in,
        noise_out, costs, argmin);
  } else {
    fleet_rollout_kernel<H, PL, 2><<<grid, ROLLOUT_THREADS, 0, stream>>>(
        *a, *f, kn->sigma_mppi, w_blk, scen, seeds, offsets, incumbent, sigma_in, noise_in,
        noise_out, costs, argmin);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (method == 0) {
    fleet_extract_kernel<H, PL><<<S, RS_BLOCK, 0, stream>>>(*a, *f, w_blk, scen, seeds, offsets,
                                                            incumbent, noise_in, argmin, out);
    return (int)cudaGetLastError();
  }
  err = fleet_update_opt_in<H, PL>();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
  const int smem = sm_update_smem(4 * PL, kn->cem, kn->n_elite, blocks);
  fleet_update_kernel<H, PL><<<dim3(blocks, S), SM_UPDATE_THREADS, smem, stream>>>(
      *a, *f, *kn, w_blk, scen, seeds, offsets, incumbent, noise_in ? noise_in : noise_out, costs,
      argmin, partials, block_keys, out, sigma_out, elites);
  return (int)cudaGetLastError();
}

extern "C" {

int fleet_args_size(void) { return (int)sizeof(RSArgs); }

int fleet_layout_size(void) { return (int)sizeof(FleetArgs); }

int fleet_knobs_size(void) { return (int)sizeof(SMKnobs); }

int fleet_block(void) { return RS_BLOCK; }

int fleet_rollout_samples(void) { return ROLLOUT_SAMPLES; }

int fleet_max_elite(void) { return SM_KMAX; }

int fleet_horizon(void) { return SAMPLING_H; }

int fleet_params_per_leg(void) { return SAMPLING_PL; }

int fleet_padded_params_per_leg(void) { return padded_pl(SAMPLING_PL); }

// Floats of a scenario's row of the tick buffer before padding.
int fleet_row_floats(void) { return FLEET_ROW(SAMPLING_H); }

const char* fleet_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One iteration of `method` (0 random sampling, 1 MPPI, 2 CEM-MPPI; kn->cem set for
// 2 only) for S = f->num_scenarios scenarios of a->num_samples samples each.
// scen (S, scen_stride): the tick buffer; seeds, offsets (S): each scenario's
// Philox key and offset, to which f->iteration is added; incumbent (S, P) at
// f->inc_stride; sigma_in (S, P) for CEM; noise_in or noise_out (S, P, N) (the
// update pass reads the noise back, so MPPI and CEM need one); costs (S, N); out
// (S, 26 + P) packed as K1a's; sigma_out (S, P) and elites (S, K) for CEM.
// Scratch: argmin (2 S: each scenario's key and ticket, reset here), partials
// (S, part_stride) and, for CEM, block_keys (S, key_stride), with part_stride >=
// B (P + 1) and key_stride >= B K for B = ceil(N / fleet_block()). Returns 0, a
// CUDA error code, or -1 for a shape, knob, layout or alignment this build does
// not take.
int fleet_launch(const RSArgs* a, const FleetArgs* f, const SMKnobs* kn, int method,
                 int params_per_leg, const float* w_blk, const float* scen,
                 const unsigned long long* seeds, const unsigned long long* offsets,
                 const float* incumbent, const float* sigma_in, const float* noise_in,
                 float* noise_out, float* costs, unsigned long long* argmin, float* partials,
                 unsigned long long* block_keys, float* out, float* sigma_out, int* elites,
                 void* stream) {
  constexpr int P = 4 * SAMPLING_PL;
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL || a->num_samples < 1) return -1;
  if (f->num_scenarios < 1 || f->num_scenarios > 65535 ||
      f->scen_stride < FLEET_ROW(SAMPLING_H) || f->inc_stride < P)
    return -1;
  if (((uintptr_t)w_blk & 15) != 0) return -1;
  if (method < 0 || method > 2 || (kn->cem != 0) != (method == 2)) return -1;
  if (method > 0) {
    const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
    if (!(kn->temperature > 0.f) || (noise_in == nullptr && noise_out == nullptr)) return -1;
    if (((uintptr_t)partials & 15) != 0 || f->part_stride % 4 != 0 ||
        f->part_stride < blocks * (P + 1))
      return -1;
    if (method == 2 && (kn->n_elite < 2 || kn->n_elite > SM_KMAX || kn->n_elite > a->num_samples ||
                        ((uintptr_t)block_keys & 15) != 0 || f->key_stride % 2 != 0 ||
                        f->key_stride < blocks * kn->n_elite))
      return -1;
  }
  return fleet_launch_t<SAMPLING_H, SAMPLING_PL>(a, f, kn, method, w_blk, scen, seeds, offsets,
                                                 incumbent, sigma_in, noise_in, noise_out, costs,
                                                 argmin, partials, block_keys, out, sigma_out,
                                                 elites, (cudaStream_t)stream);
}

}  // extern "C"
