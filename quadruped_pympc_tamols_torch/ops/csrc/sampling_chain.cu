// Chained sampling iterations (kernel K1d) for NVIDIA Hopper (sm_90a): all the
// iterations of a tick in one cooperative, persistent launch.
//
// Replaces the num_chained > 1 variant of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (pl.pallas_call at :818, grid (num_chained, G, T) at :793, G = 1): its outer
// grid axis runs the solver's iterations one after the other inside one launch,
// and the first tile of iteration i publishes iteration i - 1's result as the
// incumbent (:190-200, :298-332). Random sampling (K1a), MPPI (K1b) and CEM-MPPI
// (K1c) each chain.
//
// The grid is as many blocks of CHAIN_THREADS threads as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), launched by
// cudaLaunchCooperativeKernel, whose co-residency guarantee is what makes the grid
// barrier (cooperative_groups' grid.sync) safe; a grid that would not be
// co-resident is refused. Each block stages the basis windows and the contact
// and share columns in shared memory once, block 0 sets the argmin key and the
// ticket, and after a grid barrier, for iteration i:
//
//   1. the rollout pass of sampling_common.cuh: the blocks stride over its
//      16-sample tiles, chain_tiles<PL>() at once a block (eight up to PL = 72;
//      the lanes' staged parameters share the update pass's arena), spread over
//      the blocks first. Each sample's parameters are drawn at Philox offset
//      offset + i around the incumbent (the caller's at i = 0, then iteration
//      i - 1's new parameters), with CEM's sigma likewise; the costs (and, for
//      MPPI and CEM, the noise) are written and the argmin key folded.
//   2. A grid barrier.
//   3. MPPI and CEM: the update pass of sampling_softmax.cuh, the blocks striding
//      over its 64-sample tiles, a ticket a tile; the block whose tile takes the
//      last ticket finishes (the partial rows summed in tile order, the step-0
//      extraction, for CEM the elites and the sigma refit). Random sampling:
//      block 0 extracts the winner on four lanes (rs_extract of sampling_rs.cuh).
//      The finishing block then sets the argmin key and the ticket back to all
//      ones for the next iteration.
//   4. A grid barrier (none after the last iteration).
//
// Iteration i's costs, out, sigma and elites go to slice i of the outputs. Every
// sum runs in the order of the one-iteration kernels (per tile in thread order,
// then over tiles in tile order), which does not depend on the block that runs a
// tile, so iteration i has the bits of one K1a/K1b/K1c iteration launched from
// iteration i - 1's outputs, at any grid size. What an earlier phase of the launch
// wrote is never read through the read-only path, which could return a stale
// copy: each block stages the iteration's incumbent (and CEM's sigma) in shared
// memory from L2 after the barrier, and reads the costs, the noise and the argmin
// key from L2 (Read::Shared and Read::L2 in sampling_common.cuh).
//
// What bounds it: as K1a-K1c, the rollout pass's serial chain (see
// sampling_common.cuh). One launch in place of a memset and two launches an
// iteration takes the host's enqueue out of the iterations; the card pays two
// grid barriers an iteration and one at the start.
#include <cooperative_groups.h>

#include "sampling_rs.cuh"
#include "sampling_softmax.cuh"

namespace cg = cooperative_groups;

// The update pass's block: up to eight rollout tiles at once, as many as the
// lanes' staged parameters (PL floats a lane) allow in CHAIN_PARAM_BYTES: eight up
// to PL = 72, two at PL = 255.
#define CHAIN_THREADS SM_UPDATE_THREADS
#define CHAIN_PARAM_BYTES (8 * 72 * ROLLOUT_THREADS * 4)
template <int PL>
__host__ __device__ constexpr int chain_tiles() {
  return CHAIN_PARAM_BYTES / lane_param_bytes<PL>() < CHAIN_THREADS / ROLLOUT_THREADS
             ? CHAIN_PARAM_BYTES / lane_param_bytes<PL>()
             : CHAIN_THREADS / ROLLOUT_THREADS;
}

// The chain's device buffers; iteration i's outputs are costs + i * N,
// out + i * (26 + P), sigma_out + i * P and elites + i * K.
struct ChainBuffers {
  const BasisWindow* win;  // (H*12), 16-byte aligned
  const float* incumbent;  // (P,) iteration 0's
  const float* sigma_in;   // (P,) iteration 0's (CEM)
  float* noise;            // (P, N), written by the rollout pass and read back (MPPI, CEM)
  float* costs;
  unsigned long long* scratch;  // [argmin key, ticket]
  float* partials;              // (B, P + 1), 16-byte aligned (MPPI, CEM)
  unsigned long long* block_keys;  // (B, K) (CEM)
  float* out;
  float* sigma_out;  // CEM
  int* elites;       // CEM
};

template <int H, int PL, bool RS>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
chain_kernel(const RSArgs a, const SMKnobs kn, const ChainBuffers buf, int iterations) {
  constexpr int P = 4 * PL;
  constexpr int OUT = RS_OUT_WINNER + P;
  constexpr int TILES = chain_tiles<PL>();
  static_assert(CHAIN_THREADS % ROLLOUT_THREADS == 0 && TILES >= 1, "whole rollout tiles");
  // The staged windows (window_smem: the start of the dynamic shared memory above
  // H = 64), then the arena: the rollout lanes' parameters (TILES, PL,
  // ROLLOUT_THREADS), and in its place the update pass's buffers.
  extern __shared__ __align__(16) unsigned char dyn_s[];
  BasisWindow* w_s = window_smem<H>(dyn_s);
  unsigned char* arena = dyn_s + window_dyn_bytes<H>();
  __shared__ __align__(16) float c_s[H * 4];
  __shared__ __align__(16) float sh_s[H * 4];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float inc_s[P];
  __shared__ float sig_s[P];
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int N = a.num_samples;
  unsigned long long* argmin = buf.scratch;
  unsigned long long* ticket = buf.scratch + 1;
  const StaticSource<H, PL> src{buf.win, N, 1};
  if (t == 0) bulk_barrier_init(&bar);
  src.stage(a, c_s, sh_s);
  if (blockIdx.x == 0 && t == 0) {
    *argmin = ~0ull;
    *ticket = ~0ull;
  }
  __syncthreads();
  if (t == 0) src.copy(w_s, c_s, sh_s, &bar);
  bulk_wait(&bar, 0);
  grid.sync();

  const int tiles = (N + ROLLOUT_SAMPLES - 1) / ROLLOUT_SAMPLES;
  const int B = (N + RS_BLOCK - 1) / RS_BLOCK;
  const int sub = t / ROLLOUT_THREADS, leg = t % ROLLOUT_LANES;
  const int slot = (t % ROLLOUT_THREADS) / ROLLOUT_LANES;
  float* prm = reinterpret_cast<float*>(arena) + sub * PL * ROLLOUT_THREADS + t % ROLLOUT_THREADS;
  for (int it = 0; it < iterations; ++it) {
    const unsigned long long offset = a.offset + (unsigned long long)it;
    const float* inc =
        it == 0 ? buf.incumbent : buf.out + (size_t)(it - 1) * OUT + RS_OUT_WINNER;
    const float* sig =  // CEM's sigma; MPPI's noise takes sigma_mppi
        !kn.cem ? nullptr : it == 0 ? buf.sigma_in : buf.sigma_out + (size_t)(it - 1) * P;
    float* costs = buf.costs + (size_t)it * N;
    float* out = buf.out + (size_t)it * OUT;
    // The incumbent and sigma in shared memory; the previous barrier ordered every
    // read of the last iteration's copies before these writes.
    for (int p = t; p < P; p += CHAIN_THREADS) {
      inc_s[p] = __ldcg(&inc[p]);
      if (sig != nullptr) sig_s[p] = __ldcg(&sig[p]);
    }
    __syncthreads();

    // 1. The rollout pass, on the block's first TILES 64-thread tiles. Both warps
    // of a tile take the same sample tiles, so every lane reaches the exchanges and
    // the argmin fold. 2. A grid barrier.
    for (int tile = blockIdx.x + sub * gridDim.x; sub < TILES && tile < tiles;
         tile += TILES * gridDim.x) {
      const int j = tile * ROLLOUT_SAMPLES + slot;
      const bool live = j < N;
      const int i = live ? j : N - 1;
      if constexpr (RS) {
        draw_params<PL, Read::Shared>(a, RandomBands{}, offset, inc_s, nullptr, nullptr, i, live,
                                      leg, prm);
      } else {
        draw_params<PL, Read::Shared>(a,
                                      ScaledNormals<Read::Shared>{sig ? sig_s : nullptr,
                                                                  kn.sigma_mppi},
                                      offset, inc_s, nullptr, buf.noise, i, live, leg, prm);
      }
      const float cost = lane_rollout_cost<H, PL>(a, w_s, prm, c_s, sh_s, leg);
      if (live && leg == 0) costs[i] = cost;
      fold_argmin(live ? cost_key(cost, i) : ~0ull, argmin);
    }
    grid.sync();

    // 3. The optimizer step, finished by one block, which resets the key and the
    // ticket: every other reader of the key has read it before then.
    if constexpr (RS) {
      if (blockIdx.x == 0) {
        rs_extract<PL, Read::Shared>(a, offset, buf.win, inc_s, nullptr, __ldcg(argmin), out);
        if (t == 0) *argmin = ~0ull;
      }
    } else {
      float inc_r[(P + SM_COL_THREADS - 1) / SM_COL_THREADS];
      finish_incumbent<PL, Read::Shared>(inc_s, inc_r);
      const unsigned long long best_key = blockIdx.x < B ? __ldcg(argmin) : ~0ull;
      const float beta = __uint_as_float((unsigned int)(best_key >> 32));
      for (int b = blockIdx.x; b < B; b += gridDim.x) {
        update_tile<PL, Read::L2>(a, kn, buf.noise, costs, beta, b, buf.partials,
                                  buf.block_keys, arena);
        if (last_ticket(ticket, B)) {
          __threadfence();
          update_finish<PL, Read::L2>(a, kn, buf.win, inc_r, buf.noise, costs, best_key, B,
                                      buf.partials, buf.block_keys, out,
                                      kn.cem ? buf.sigma_out + (size_t)it * P : nullptr,
                                      kn.cem ? buf.elites + (size_t)it * kn.n_elite : nullptr,
                                      arena);
          if (t == 0) {
            *argmin = ~0ull;
            *ticket = ~0ull;
          }
        }
      }
    }
    if (it + 1 < iterations) grid.sync();
  }
}

// The arena of a chain launch: the rollout lanes' parameters, or the update
// pass's buffers (none for random sampling) where they take more.
static inline int chain_arena(int update_bytes) {
  const int prm = lane_param_bytes<SAMPLING_PL>(chain_tiles<SAMPLING_PL>());
  return prm > update_bytes ? prm : update_bytes;
}

// Above 48 KB dynamic shared memory needs an opt-in, given once for the most a
// launch can ask for: the staged windows where they are dynamic and the largest
// arena (the update pass's as update_opt_in's).
template <int H, int PL, bool RS>
static cudaError_t chain_opt_in() {
  static bool opted_in = false;
  if (opted_in) return cudaSuccess;
  const int most =
      window_dyn_bytes<H>() +
      chain_arena(RS ? 0
                     : sm_tile_bytes(4 * PL, SM_TILE_ROWS) +
                           (SM_STAGE_KEYS + SM_KMAX * SM_KMAX) * 8);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<H, PL, RS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_kernel<H, PL, RS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  opted_in = err == cudaSuccess;
  return err;
}

// Dynamic shared memory of a chain launch: the staged windows where they are
// dynamic, then the arena.
static int chain_smem(int method, const SMKnobs& kn, int num_samples) {
  const int update = method == 0 ? 0
                                 : sm_update_smem(4 * SAMPLING_PL, kn.cem, kn.n_elite,
                                                  (num_samples + RS_BLOCK - 1) / RS_BLOCK);
  return window_dyn_bytes<SAMPLING_H>() + chain_arena(update);
}

// Blocks of the chain kernel one SM holds at once with smem bytes of dynamic
// shared memory, or minus a CUDA error code.
template <int H, int PL, bool RS>
static int chain_blocks_per_sm_t(int smem) {
  cudaError_t err = chain_opt_in<H, PL, RS>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, chain_kernel<H, PL, RS>,
                                                        CHAIN_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

static int chain_blocks_per_sm_of(int method, int smem) {
  return method == 0 ? chain_blocks_per_sm_t<SAMPLING_H, SAMPLING_PL, true>(smem)
                     : chain_blocks_per_sm_t<SAMPLING_H, SAMPLING_PL, false>(smem);
}

// The cooperative launch over the co-resident grid (or max_blocks of it).
template <int H, int PL, bool RS>
static int chain_launch_t(const RSArgs* a, const SMKnobs* kn, int iterations, int max_blocks,
                          int smem, const ChainBuffers& buf, cudaStream_t stream) {
  const int per_sm = chain_blocks_per_sm_t<H, PL, RS>(smem);
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int resident = per_sm * sms;
  if (resident < 1 || max_blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = max_blocks > 0 ? max_blocks : resident;
  ChainBuffers b = buf;
  RSArgs args = *a;
  SMKnobs knobs = *kn;
  void* params[] = {&args, &knobs, &b, &iterations};
  return (int)cudaLaunchCooperativeKernel((const void*)chain_kernel<H, PL, RS>, dim3(grid),
                                          dim3(CHAIN_THREADS), params, smem, stream);
}

extern "C" {

int chain_args_size(void) { return (int)sizeof(RSArgs); }

int chain_knobs_size(void) { return (int)sizeof(SMKnobs); }

int chain_block(void) { return RS_BLOCK; }

int chain_horizon(void) { return SAMPLING_H; }

int chain_params_per_leg(void) { return SAMPLING_PL; }

// Bytes of a basis window (sampling_kernel.basis_windows).
int chain_window_bytes(void) { return (int)sizeof(BasisWindow); }

// Rollout tiles a chain block runs at once.
int chain_rollout_tiles(void) { return chain_tiles<SAMPLING_PL>(); }

const char* chain_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Blocks of the chain kernel that one SM holds at once for a chain of method
// (0 random sampling, 1 MPPI, 2 CEM-MPPI; kn as SMKnobs) over num_samples
// samples, from cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus a CUDA
// error code. The launch's grid is this times the SMs.
int chain_blocks_per_sm(int method, int cem, int n_elite, int num_samples) {
  SMKnobs kn{};
  kn.cem = cem;
  kn.n_elite = n_elite;
  return chain_blocks_per_sm_of(method, chain_smem(method, kn, num_samples));
}

// `iterations` chained iterations of method 0 (random sampling), 1 (MPPI) or 2
// (CEM-MPPI, kn->cem set for 2 only) in one cooperative launch on `stream`.
// Iteration i draws at Philox offset a->offset + i around the previous iteration's
// new parameters (iteration 0: incumbent, sigma_in) and writes costs (iterations,
// N), out (iterations, 26 + P) and, for CEM, sigma_out (iterations, P) and elites
// (iterations, K). Scratch as sm_launch: scratch (2 words plus, for MPPI and CEM,
// block_keys (B, K) for CEM and partials (B, P + 1), B = ceil(N / chain_block())),
// noise (P, N) for MPPI and CEM; above SM_KMAX elites block_keys is not read and
// each iteration's elites are in index order. The kernel sets the scratch words itself; nothing
// needs a memset. max_blocks: 0 for the co-resident grid, or fewer blocks (the
// bits do not depend on it). Returns 0, a CUDA error code (among them
// cudaErrorCooperativeLaunchTooLarge for a grid that would not be co-resident, and
// cudaErrorNotSupported for a device without cooperative launches), or -1 for a
// shape or knob this build does not take, a missing buffer, or windows or partials
// that are not 16-byte aligned.
int chain_launch(const RSArgs* a, const SMKnobs* kn, int method, int params_per_leg,
                 int iterations, int max_blocks, const BasisWindow* win, const float* incumbent,
                 const float* sigma_in, float* noise, float* costs, unsigned long long* scratch,
                 float* partials, unsigned long long* block_keys, float* out, float* sigma_out,
                 int* elites, void* stream) {
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL || a->num_samples < 1) return -1;
  if (iterations < 1 || max_blocks < 0 || ((uintptr_t)win & 15) != 0) return -1;
  if (method < 0 || method > 2 || (kn->cem != 0) != (method == 2)) return -1;
  if (incumbent == nullptr || costs == nullptr || scratch == nullptr || out == nullptr) return -1;
  if (method > 0 && (!(kn->temperature > 0.f) || noise == nullptr || partials == nullptr ||
                     ((uintptr_t)partials & 15) != 0))
    return -1;
  if (method == 2 && (kn->n_elite < 2 || kn->n_elite > a->num_samples || sigma_in == nullptr ||
                      (kn->n_elite <= SM_KMAX && block_keys == nullptr) ||
                      ((uintptr_t)block_keys & 15) != 0 || sigma_out == nullptr ||
                      elites == nullptr))
    return -1;
  const ChainBuffers buf{win,      incumbent,  sigma_in, noise, costs,    scratch,
                         partials, block_keys, out,      sigma_out, elites};
  const int smem = chain_smem(method, *kn, a->num_samples);
  if (method == 0)
    return chain_launch_t<SAMPLING_H, SAMPLING_PL, true>(a, kn, iterations, max_blocks, smem, buf,
                                                         (cudaStream_t)stream);
  return chain_launch_t<SAMPLING_H, SAMPLING_PL, false>(a, kn, iterations, max_blocks, smem, buf,
                                                        (cudaStream_t)stream);
}

}  // extern "C"
