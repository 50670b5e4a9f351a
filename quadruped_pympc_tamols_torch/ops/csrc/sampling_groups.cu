// Gait-adaptive sampling iteration (kernel K1e) for NVIDIA Hopper (sm_90a).
//
// Replaces the group-axis variant of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (num_groups = K > 1, fused per group, one iteration; pl.pallas_call at :818), in the
// XLA solver's forms (controllers/sampling/gait_adaptive.py:184-226). The N samples
// are partitioned into K groups, one per candidate step frequency: group k holds
// samples [k*Ng, (k+1)*Ng) with Ng = N / K, and the last N - K*Ng are not evaluated.
// One solve is a memset and:
//
//   sg_rollout_kernel  grid (ceil(Ng/64), K), one thread per sample, each block inside
//                      one group: the group's own-leg basis blocks, contact and share
//                      columns and cost offset in shared memory; the method's noise
//                      (K1a's three bands, or K1b/K1c's normals times sigma) from
//                      Philox keyed on the GLOBAL sample index, with the band edges
//                      of N; K1a's rollout; the group's offset added after the
//                      saturation; every cost written out and (cost bits << 32 |
//                      index) folded into one 64-bit atomicMin.
//   then, over the K*Ng samples, K1a's rs_extract_kernel (random sampling) or
//   K1b/K1c's sm_weights_kernel and sm_finish_kernel (MPPI, CEM-MPPI): the argmin,
//   or the softmax update with beta from the atomicMin, the elites and the refit.
//   Their step-0 extraction reads step 0 of the argument block's contact and share
//   (the host's contact sequence column and its gravity share) and the static
//   basis's first 12 rows, which are the counter-zero basis: not the winning group's.
//
// What bounds it: operations, as K1a, with the same work per sample. Costs plus
// offsets are >= 0, so the keys still order like (cost, index): the argmin and the
// elites take the lowest index on ties. The groups' operators reach the card in one
// host-to-device copy per tick, [blocks (K, H*12, PL) | contact (K, H, 4) | share
// (K, H, 4) | offsets (K)]: the basis blocks (41 KB at K = 3) do not fit in the 4 KB
// of kernel parameters, and building them here would repeat the spline formulas in
// device code.
#include "sampling_rs.cuh"
#include "sampling_softmax.cuh"

template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
sg_rollout_kernel(const RSArgs a, const SMKnobs kn, int random_sampling, int group_size,
                  const float* __restrict__ groups, const float* __restrict__ incumbent,
                  const float* __restrict__ sigma_in, const float* __restrict__ noise_in,
                  float* __restrict__ noise_out, float* __restrict__ costs,
                  unsigned long long* __restrict__ argmin) {
  constexpr int P = 4 * PL;
  constexpr int WG = H * 12 * PL;
  __shared__ float w_s[WG];
  __shared__ float c_s[H * 4];
  __shared__ float sh_s[H * 4];
  __shared__ float inc_s[P];
  __shared__ float sig_s[P];
  const int g = blockIdx.y;
  const int K = gridDim.y;
  const float* w_g = groups + (size_t)g * WG;
  const float* c_g = groups + (size_t)K * WG + (size_t)g * H * 4;
  const float* sh_g = c_g + (size_t)K * H * 4;
  const float offset = groups[(size_t)K * WG + (size_t)2 * K * H * 4 + g];
  for (int k = threadIdx.x; k < WG; k += blockDim.x) w_s[k] = w_g[k];
  for (int k = threadIdx.x; k < H * 4; k += blockDim.x) {
    c_s[k] = c_g[k];
    sh_s[k] = sh_g[k];
  }
  for (int k = threadIdx.x; k < P; k += blockDim.x) inc_s[k] = incumbent[k];
  load_sigma(kn, sigma_in, sig_s, P);
  __syncthreads();

  const int N = a.num_samples;  // K * Ng: the noise matrices' row length
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = g * group_size + j;
  unsigned long long key = ~0ull;
  if (j < group_size) {
    float prm[P];
#pragma unroll
    for (int k = 0; k < P / 4; ++k) {
      const float4 z =
          (random_sampling && noise_in == nullptr)
              ? rs_noise4(a.seed, a.offset, a.band1, a.band2, a.sigma1, a.sigma2, a.sigma3, i, k)
              : noise4(a, noise_in, sig_s, i, k);
      if (noise_out != nullptr) store_noise4(noise_out, N, i, k, z);
      prm[4 * k + 0] = __fadd_rn(inc_s[4 * k + 0], z.x);
      prm[4 * k + 1] = __fadd_rn(inc_s[4 * k + 1], z.y);
      prm[4 * k + 2] = __fadd_rn(inc_s[4 * k + 2], z.z);
      prm[4 * k + 3] = __fadd_rn(inc_s[4 * k + 3], z.w);
    }
    const float cost = __fadd_rn(rollout_cost_cols<H, PL>(a, w_s, c_s, sh_s, prm), offset);
    costs[i] = cost;
    key = cost_key(cost, i);
  }
  fold_argmin(key, argmin);
}

template <int H, int PL>
static int sg_launch_t(const RSArgs* a, const SMKnobs* kn, int method, int num_groups,
                       int group_size, const float* groups, const float* w0_blk,
                       const float* incumbent, const float* sigma_in, const float* noise_in,
                       float* noise_out, float* costs, unsigned long long* argmin,
                       float* partials, unsigned long long* block_keys, float* out,
                       float* sigma_out, int* elites, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((group_size + RS_BLOCK - 1) / RS_BLOCK, num_groups);
  sg_rollout_kernel<H, PL><<<grid, RS_BLOCK, 0, stream>>>(*a, *kn, method == 0, group_size,
                                                          groups, incumbent, sigma_in, noise_in,
                                                          noise_out, costs, argmin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (method == 0) {
    rs_extract_kernel<H, PL><<<1, RS_BLOCK, 0, stream>>>(*a, w0_blk, incumbent, noise_in, argmin,
                                                         out);
    return (int)cudaGetLastError();
  }
  const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
  sm_weights_kernel<PL><<<blocks, RS_BLOCK, 0, stream>>>(*a, *kn, sigma_in, noise_in, costs,
                                                         argmin, partials, block_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sm_finish_kernel<PL><<<1, SM_FINISH_THREADS, 0, stream>>>(
      *a, *kn, w0_blk, incumbent, sigma_in, noise_in, argmin, partials, block_keys, blocks, out,
      sigma_out, elites);
  return (int)cudaGetLastError();
}

extern "C" {

int sg_args_size(void) { return (int)sizeof(RSArgs); }

int sg_knobs_size(void) { return (int)sizeof(SMKnobs); }

int sg_block(void) { return RS_BLOCK; }

const char* sg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One gait-adaptive iteration: method 0 random sampling, 1 MPPI, 2 CEM-MPPI
// (kn->cem set for 2 only). a->num_samples is K * Ng, the samples evaluated, and
// a->band1, a->band2 are N's band edges. groups: the per-group buffer described
// above; w0_blk: the static basis's own-leg blocks, of which rows 0..11 are read.
// Scratch as sm_launch: argmin (1), partials (B, P + 1) and, for CEM, block_keys
// (B, K), with B = ceil(K * Ng / sg_block()). Returns 0, a CUDA error code, or -1
// for a shape or knob this build does not take. Only the main path's shape is
// built: horizon 12, 24 parameters per leg.
int sg_launch(const RSArgs* a, const SMKnobs* kn, int method, int params_per_leg, int num_groups,
              int group_size, const float* groups, const float* w0_blk, const float* incumbent,
              const float* sigma_in, const float* noise_in, float* noise_out, float* costs,
              unsigned long long* argmin, float* partials, unsigned long long* block_keys,
              float* out, float* sigma_out, int* elites, void* stream) {
  if (a->horizon != 12 || params_per_leg != 24) return -1;
  if (method < 0 || method > 2 || (kn->cem != 0) != (method == 2)) return -1;
  if (num_groups < 1 || num_groups > 65535 || group_size < 1 ||
      (long long)num_groups * group_size != a->num_samples)
    return -1;
  if (method > 0 && !(kn->temperature > 0.f)) return -1;
  if (method == 2 && (kn->n_elite < 2 || kn->n_elite > SM_KMAX || kn->n_elite > a->num_samples))
    return -1;
  return sg_launch_t<12, 24>(a, kn, method, num_groups, group_size, groups, w0_blk, incumbent,
                             sigma_in, noise_in, noise_out, costs, argmin, partials, block_keys,
                             out, sigma_out, elites, (cudaStream_t)stream);
}

}  // extern "C"
