// Gait-adaptive sampling iteration (kernel K1e) for NVIDIA Hopper (sm_90a).
//
// Replaces the group-axis variant of the Pallas TPU kernel
// quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:make_pallas_iteration(...).kernel
// (num_groups = K > 1, fused per group, one iteration; pl.pallas_call at :818), in the
// XLA solver's forms (controllers/sampling/gait_adaptive.py:184-226). The N samples
// are partitioned into K groups, one per candidate step frequency: group k holds
// samples [k*Ng, (k+1)*Ng) with Ng = N / K, and the last N - K*Ng are not evaluated.
// One solve is a memset (the argmin key and, for MPPI and CEM, the update pass's
// ticket) and two launches:
//
//   rollout_kernel     the shared rollout pass of sampling_common.cuh over a grid
//                      (ceil(Ng/16), K), four lanes per sample (one per leg), each
//                      block inside one group: the group's basis windows and
//                      contact and share columns bulk-copied into shared memory, and
//                      its cost offset; the method's noise (K1a's three bands, or
//                      K1b/K1c's normals times sigma) from Philox keyed on the
//                      GLOBAL sample index, with the band edges of N; K1a's
//                      rollout; the group's offset added after the saturation;
//                      every cost written out and (cost bits << 32 | index) folded
//                      into one 64-bit atomicMin.
//   then, over the K*Ng samples, K1a's rs_extract_kernel (random sampling) or
//   K1b/K1c's update pass sm_update_kernel (MPPI, CEM-MPPI): the argmin, or the
//   softmax update with beta from the atomicMin, the elites and the refit.
//   Their step-0 extraction reads step 0 of the argument block's contact and share
//   (the host's contact sequence column and its gravity share) and the static
//   basis's first 12 windows, which are the counter-zero basis: not the winning
//   group's.
//
// What bounds it: the rollout pass, as in K1a (latency; see sampling_common.cuh),
// with the same work per sample. Costs plus offsets are >= 0, so the keys still
// order like (cost, index): the argmin and the elites take the lowest index on
// ties. The groups' operators reach the card in one host-to-device copy per tick,
// [windows (K, H*12) | contact (K, H, 4) | share (K, H, 4) | offsets (K)]: the
// windows (13.8 KB at K = 3 and H = 12, whatever PL) would crowd the kernel
// parameters, and building them here would repeat the spline formulas in device
// code. Every row of the gait-adaptive traced basis (stance counters for the
// spline phase) holds its nonzeros in four adjacent parameters, as the static
// basis does; the host's basis_windows refuses one that does not.
#include "sampling_rs.cuh"
#include "sampling_softmax.cuh"

// K1e's noise for rollout_kernel: K1a's bands or K1b/K1c's scaled normals, as
// the method says (uniform over the grid).
struct GroupNoise {
  int random_sampling;
  ScaledNormals<> normals;
  __device__ float4 operator()(const RSArgs& a, unsigned long long offset, int i, int k, int p,
                               int valid) const {
    return random_sampling ? RandomBands{}(a, offset, i, k, p, valid)
                           : normals(a, offset, i, k, p, valid);
  }
};

// K1e's column source: group blockIdx.y's basis windows, contact and share columns
// (bulk-copied) and cost offset, from the per-tick buffer [windows (K, H*12) |
// contact (K, H, 4) | share (K, H, 4) | offsets (K)] (16-byte aligned).
template <int H, int PL>
struct GroupSource {
  const float* groups;
  int group_size;  // Ng
  int num_groups;  // K

  __device__ void stage(const RSArgs&, float*, float*) const {}
  __device__ void copy(BasisWindow* w_s, float* c_s, float* sh_s, unsigned long long* bar) const {
    constexpr int WG = window_bytes<H>() / 4;  // floats of a group's windows
    const size_t g = blockIdx.y, K = num_groups;
    const float* c_g = groups + K * WG + g * H * 4;
    bulk_expect(bar, (WG + 2 * H * 4) * 4);
    bulk_load(w_s, groups + g * WG, WG * 4, bar);
    bulk_load(c_s, c_g, H * 4 * 4, bar);
    bulk_load(sh_s, c_g + K * H * 4, H * 4 * 4, bar);
  }
  __device__ float finish(float cost) const {
    constexpr int WG = window_bytes<H>() / 4;
    const size_t K = num_groups;
    return __fadd_rn(cost, __ldg(&groups[K * WG + 2 * K * H * 4 + blockIdx.y]));
  }
};

template <int H, int PL>
static int sg_launch_t(const RSArgs* a, const SMKnobs* kn, int method, int num_groups,
                       int group_size, const float* groups, const BasisWindow* win0,
                       const float* incumbent, const float* sigma_in, const float* noise_in,
                       float* noise_out, float* costs, unsigned long long* argmin,
                       float* partials, unsigned long long* block_keys, float* out,
                       float* sigma_out, int* elites, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(argmin, 0xFF, 2 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_rollout<H, PL>(*a, GroupNoise{method == 0, scaled_normals(*kn, sigma_in)},
                             GroupSource<H, PL>{groups, group_size, num_groups}, incumbent,
                             noise_in, noise_out, costs, argmin, stream);
  if (err != cudaSuccess) return (int)err;
  if (method == 0) {
    rs_extract_kernel<H, PL><<<1, RS_BLOCK, 0, stream>>>(*a, win0, incumbent, noise_in, argmin,
                                                         out);
    return (int)cudaGetLastError();
  }
  return (int)launch_update<PL>(*a, *kn, win0, incumbent, noise_in ? noise_in : noise_out,
                                costs, argmin, partials, block_keys, out, sigma_out, elites,
                                stream);
}

extern "C" {

int sg_args_size(void) { return (int)sizeof(RSArgs); }

int sg_knobs_size(void) { return (int)sizeof(SMKnobs); }

int sg_block(void) { return RS_BLOCK; }

int sg_rollout_samples(void) { return ROLLOUT_SAMPLES; }

int sg_horizon(void) { return SAMPLING_H; }

int sg_params_per_leg(void) { return SAMPLING_PL; }

// Bytes of a basis window (sampling_kernel.basis_windows).
int sg_window_bytes(void) { return (int)sizeof(BasisWindow); }

const char* sg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One gait-adaptive iteration: method 0 random sampling, 1 MPPI, 2 CEM-MPPI
// (kn->cem set for 2 only). a->num_samples is K * Ng, the samples evaluated, and
// a->band1, a->band2 are N's band edges. groups: the per-group buffer described
// above; win0: the static basis's windows, of which rows 0..11 are read.
// Scratch, and for MPPI and CEM the noise buffer, as sm_launch: argmin (2),
// partials (B, P + 1) and, for CEM with K <= SM_KMAX, block_keys (B, K), with
// B = ceil(K * Ng / sg_block()). Returns 0, a CUDA error code, or -1 for a shape
// or knob this build does not take (a horizon or parameter count other than
// SAMPLING_H, SAMPLING_PL), no noise buffer, or a buffer that is not 16-byte
// aligned (the bulk copy's and cp.async's rule).
int sg_launch(const RSArgs* a, const SMKnobs* kn, int method, int params_per_leg, int num_groups,
              int group_size, const float* groups, const BasisWindow* win0, const float* incumbent,
              const float* sigma_in, const float* noise_in, float* noise_out, float* costs,
              unsigned long long* argmin, float* partials, unsigned long long* block_keys,
              float* out, float* sigma_out, int* elites, void* stream) {
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL) return -1;
  if ((((uintptr_t)groups | (uintptr_t)win0) & 15) != 0) return -1;
  if (method < 0 || method > 2 || (kn->cem != 0) != (method == 2)) return -1;
  if (num_groups < 1 || num_groups > 65535 || group_size < 1 ||
      (long long)num_groups * group_size != a->num_samples)
    return -1;
  if (method > 0 && (!(kn->temperature > 0.f) || (noise_in == nullptr && noise_out == nullptr) ||
                     ((uintptr_t)partials & 15) != 0))
    return -1;
  if (method == 2 && (kn->n_elite < 2 || kn->n_elite > a->num_samples)) return -1;
  return sg_launch_t<SAMPLING_H, SAMPLING_PL>(a, kn, method, num_groups, group_size, groups,
                                              win0, incumbent, sigma_in, noise_in, noise_out,
                                              costs, argmin, partials, block_keys, out, sigma_out,
                                              elites, (cudaStream_t)stream);
}

}  // extern "C"
