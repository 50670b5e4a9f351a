// K1b/K1c's knobs, noise and optimizer-step kernels (weights, finish), shared by
// sampling_softmax.cu (K1b-K1d) and sampling_groups.cu (K1e).
#pragma once

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

// K1b/K1c's noise for rollout_kernel: sigma (P,) for CEM, nullptr for MPPI's
// sigma_mppi.
struct ScaledNormals {
  const float* sigma;
  float sigma_mppi;
  __device__ float4 operator()(const RSArgs& a, int i, int k) const {
    const float4 s = sigma != nullptr ? make_float4(__ldg(&sigma[4 * k]), __ldg(&sigma[4 * k + 1]),
                                                    __ldg(&sigma[4 * k + 2]),
                                                    __ldg(&sigma[4 * k + 3]))
                                      : make_float4(sigma_mppi, sigma_mppi, sigma_mppi, sigma_mppi);
    return sm_noise4(a.seed, a.offset, i, k, s);
  }
};

static inline ScaledNormals scaled_normals(const SMKnobs& kn, const float* sigma_in) {
  return ScaledNormals{kn.cem ? sigma_in : nullptr, kn.sigma_mppi};
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
