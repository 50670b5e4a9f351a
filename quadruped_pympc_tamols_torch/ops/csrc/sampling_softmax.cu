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
//   sm_rollout_kernel  one thread per sample: Philox4x32-10 normals times sigma
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
// What bounds it: operations, as K1a (the rollout is the same), plus ~2P + 20
// flops per sample for the weight and the weighted sum. No float atomicAdd: every
// sum runs in a fixed order, so the same inputs give the same bits from run to
// run. At T = 1 most weights underflow to exactly 0, and those samples skip the
// regeneration. Keys order like (cost, index), so the elites are the lowest costs
// with the lowest index first on ties, as jax.lax.top_k picks them: ties are real
// at the 1e6 saturation.
#include "sampling_common.cuh"

#define SM_KMAX 32
#define SM_FINISH_THREADS 128

// The optimizer's constants, passed by value beside RSArgs (whose random-sampling
// band fields these kernels do not read).
struct SMKnobs {
  int cem;            // 0: MPPI, noise N(0, sigma_mppi); 1: CEM-MPPI, noise N(0, sigma[p])
  int n_elite;        // K (CEM)
  float temperature;  // T
  float sigma_mppi;
  float sigma_min, sigma_max;  // CEM refit clip
};

// Noise of parameters 4k..4k+3 of sample i: standard normals from counter
// (i, k, offset) times s. Sample 0 is the incumbent.
__device__ __forceinline__ float4 sm_noise4(unsigned long long seed, unsigned long long offset,
                                            int i, int k, float4 s) {
  if (i == 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 z = normals4(philox_words(seed, offset, i, k));
  return make_float4(__fmul_rn(z.x, s.x), __fmul_rn(z.y, s.y), __fmul_rn(z.z, s.z),
                     __fmul_rn(z.w, s.w));
}

// Sigma of every parameter into shared memory.
__device__ __forceinline__ void load_sigma(const SMKnobs& kn, const float* sigma_in, float* sig_s,
                                           int P) {
  for (int k = threadIdx.x; k < P; k += blockDim.x) sig_s[k] = kn.cem ? sigma_in[k] : kn.sigma_mppi;
}

__device__ __forceinline__ float4 noise4(const RSArgs& a, const float* noise_in, const float* sig_s,
                                         int i, int k) {
  if (noise_in != nullptr) return load_noise4(noise_in, a.num_samples, i, k);
  return sm_noise4(a.seed, a.offset, i, k,
                   make_float4(sig_s[4 * k], sig_s[4 * k + 1], sig_s[4 * k + 2], sig_s[4 * k + 3]));
}

template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
sm_rollout_kernel(const RSArgs a, const SMKnobs kn, const float* __restrict__ w_blk,
                  const float* __restrict__ incumbent, const float* __restrict__ sigma_in,
                  const float* __restrict__ noise_in, float* __restrict__ noise_out,
                  float* __restrict__ costs, unsigned long long* __restrict__ argmin) {
  constexpr int P = 4 * PL;
  __shared__ float w_s[H * 12 * PL];
  __shared__ float inc_s[P];
  __shared__ float sig_s[P];
  for (int k = threadIdx.x; k < H * 12 * PL; k += blockDim.x) w_s[k] = w_blk[k];
  for (int k = threadIdx.x; k < P; k += blockDim.x) inc_s[k] = incumbent[k];
  load_sigma(kn, sigma_in, sig_s, P);
  __syncthreads();

  const int N = a.num_samples;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long key = ~0ull;
  if (i < N) {
    float prm[P];
#pragma unroll
    for (int k = 0; k < P / 4; ++k) {
      const float4 z = noise4(a, noise_in, sig_s, i, k);
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

template <int PL>
__global__ void __launch_bounds__(RS_BLOCK)
sm_weights_kernel(const RSArgs a, const SMKnobs kn, const float* __restrict__ sigma_in,
                  const float* __restrict__ noise_in, const float* __restrict__ costs,
                  const unsigned long long* __restrict__ argmin, float* __restrict__ partials,
                  unsigned long long* __restrict__ block_keys) {
  constexpr int P = 4 * PL;
  constexpr int ROW = P + 1;  // odd: row writes and column reads are free of bank conflicts
  __shared__ float sig_s[P];
  __shared__ float acc_s[RS_BLOCK * ROW];
  __shared__ unsigned long long key_s[RS_BLOCK];
  load_sigma(kn, sigma_in, sig_s, P);
  __syncthreads();

  const int N = a.num_samples;
  const int t = threadIdx.x;
  const int i = blockIdx.x * RS_BLOCK + t;
  const float beta = __uint_as_float((unsigned int)(*argmin >> 32));
  float w = 0.f;
  unsigned long long key = ~0ull;
  if (i < N) {
    const float c = costs[i];
    w = expf(-(c - beta) / kn.temperature);
    key = cost_key(c, i);
  }
  float* row = &acc_s[t * ROW];
  for (int k = 0; k < P / 4; ++k) {
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w != 0.f) z = noise4(a, noise_in, sig_s, i, k);
    row[4 * k + 0] = w * z.x;
    row[4 * k + 1] = w * z.y;
    row[4 * k + 2] = w * z.z;
    row[4 * k + 3] = w * z.w;
  }
  row[P] = w;
  key_s[t] = key;
  __syncthreads();

  for (int col = t; col < ROW; col += RS_BLOCK) {
    float s = 0.f;
    for (int u = 0; u < RS_BLOCK; ++u) s += acc_s[u * ROW + col];
    partials[(size_t)blockIdx.x * ROW + col] = s;
  }
  if (kn.cem) {
    // Rank of this key in the block; equal keys (only the ~0ull of missing
    // samples) rank by thread.
    int rank = 0;
    for (int u = 0; u < RS_BLOCK; ++u) {
      const unsigned long long ku = key_s[u];
      rank += (ku < key || (ku == key && u < t)) ? 1 : 0;
    }
    if (rank < kn.n_elite) block_keys[(size_t)blockIdx.x * kn.n_elite + rank] = key;
  }
}

// The lowest of every thread's v, returned to all threads of the block.
__device__ __forceinline__ unsigned long long block_min(unsigned long long v,
                                                        unsigned long long* red_s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red_s[0];
  for (int wi = 1; wi < (int)(blockDim.x >> 5); ++wi) v = red_s[wi] < v ? red_s[wi] : v;
  __syncthreads();
  return v;
}

template <int PL>
__global__ void __launch_bounds__(SM_FINISH_THREADS)
sm_finish_kernel(const RSArgs a, const SMKnobs kn, const float* __restrict__ w_blk,
                 const float* __restrict__ incumbent, const float* __restrict__ sigma_in,
                 const float* __restrict__ noise_in,
                 const unsigned long long* __restrict__ argmin,
                 const float* __restrict__ partials,
                 const unsigned long long* __restrict__ block_keys, int num_blocks,
                 float* __restrict__ out, float* __restrict__ sigma_out, int* __restrict__ elites) {
  constexpr int P = 4 * PL;
  constexpr int ROW = P + 1;
  __shared__ float sum_s[ROW];
  __shared__ float prm_s[P];
  __shared__ int elite_s[SM_KMAX];
  __shared__ unsigned long long red_s[SM_FINISH_THREADS / 32];
  const int t = threadIdx.x;
  const int N = a.num_samples;

  for (int col = t; col < ROW; col += blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < num_blocks; ++b) s += partials[(size_t)b * ROW + col];
    sum_s[col] = s;
  }
  __syncthreads();
  for (int p = t; p < P; p += blockDim.x) {
    const float v = incumbent[p] + sum_s[p] / sum_s[P];
    prm_s[p] = v;
    out[RS_OUT_WINNER + p] = v;
  }

  if (kn.cem) {
    // The e-th elite is the lowest key above the (e-1)-th: the candidates hold
    // each block's K lowest keys, a superset of the global K lowest.
    const int K = kn.n_elite;
    const int M = num_blocks * K;
    unsigned long long last = 0ull;
    for (int e = 0; e < K; ++e) {
      unsigned long long best = ~0ull;
      for (int c = t; c < M; c += blockDim.x) {
        const unsigned long long k = block_keys[c];
        if ((e == 0 || k > last) && k < best) best = k;
      }
      last = block_min(best, red_s);
      if (t == 0) elite_s[e] = (int)(last & 0xffffffffull);
    }
    __syncthreads();
    for (int p = t; p < P; p += blockDim.x) {
      const float s = sigma_in[p];
      float x[SM_KMAX];
      float mean = 0.f;
      for (int e = 0; e < K; ++e) {
        const int idx = elite_s[e];
        float z;
        if (noise_in != nullptr) {
          z = noise_in[(size_t)p * N + idx];
        } else if (idx == 0) {
          z = 0.f;
        } else {
          const float4 z4 = normals4(philox_words(a.seed, a.offset, idx, p >> 2));
          const int j = p & 3;
          z = __fmul_rn(j == 0 ? z4.x : j == 1 ? z4.y : j == 2 ? z4.z : z4.w, s);
        }
        x[e] = z;
        mean += z;
      }
      mean = mean / (float)K;
      float ss = 0.f;
      for (int e = 0; e < K; ++e) {
        const float d = x[e] - mean;
        ss += d * d;
      }
      const float var = ss / (float)(K - 1) + 1e-8f;
      sigma_out[p] = clip_nan(sqrtf(var), kn.sigma_min, kn.sigma_max);
    }
    if (t < K) elites[t] = elite_s[t];
  }
  __syncthreads();
  if (t == 0) {
    const unsigned long long key = *argmin;
    step0_extract<PL>(a, w_blk, prm_s, out);
    out[0] = __uint_as_float((unsigned int)(key >> 32));
    out[25] = (float)(int)(key & 0xffffffffull);
  }
}

template <int H, int PL>
static int sm_launch_t(const RSArgs* a, const SMKnobs* kn, const float* w_blk,
                       const float* incumbent, const float* sigma_in, const float* noise_in,
                       float* noise_out, float* costs, unsigned long long* argmin,
                       float* partials, unsigned long long* block_keys, float* out,
                       float* sigma_out, int* elites, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
  sm_rollout_kernel<H, PL><<<blocks, RS_BLOCK, 0, stream>>>(*a, *kn, w_blk, incumbent, sigma_in,
                                                            noise_in, noise_out, costs, argmin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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

int sm_max_elite(void) { return SM_KMAX; }

const char* sm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One MPPI (kn->cem == 0) or CEM-MPPI iteration. Scratch: argmin (1), partials
// (B, P + 1) and, for CEM, block_keys (B, K), with B = ceil(N / sm_block()).
// sigma_in, sigma_out and elites are read or written only for CEM. Returns 0, a
// CUDA error code, or -1 for a shape or knob this build does not take. Only the
// main path's shape is built: horizon 12, 24 parameters per leg.
int sm_launch(const RSArgs* a, const SMKnobs* kn, int params_per_leg, const float* w_blk,
              const float* incumbent, const float* sigma_in, const float* noise_in,
              float* noise_out, float* costs, unsigned long long* argmin, float* partials,
              unsigned long long* block_keys, float* out, float* sigma_out, int* elites,
              void* stream) {
  if (a->horizon != 12 || params_per_leg != 24 || a->num_samples < 1) return -1;
  if (!(kn->temperature > 0.f)) return -1;
  if (kn->cem && (kn->n_elite < 2 || kn->n_elite > SM_KMAX || kn->n_elite > a->num_samples))
    return -1;
  return sm_launch_t<12, 24>(a, kn, w_blk, incumbent, sigma_in, noise_in, noise_out, costs,
                             argmin, partials, block_keys, out, sigma_out, elites,
                             (cudaStream_t)stream);
}

}  // extern "C"
