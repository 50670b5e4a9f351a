// K1a's random-sampling noise and winner extraction, shared by sampling_rs.cu
// (K1a), sampling_groups.cu (K1e) and sampling_chain.cu (K1d).
#pragma once

#include "sampling_common.cuh"

// Noise of parameters 4k..4k+3 of sample i. Counter (i, k, offset), key seed.
// Sample 0 is the incumbent (zero) unless col0 (RSArgs::draw_col0), and then ~
// N(0, s2), as the JAX package's sharded solver draws it on its other shards;
// [1, band1) ~ N(0, s1), [band1, band2) ~ N(0, s2), the rest ~ U[-s3, s3).
__device__ __forceinline__ float4 rs_noise4(unsigned long long seed, unsigned long long offset,
                                            int band1, int band2, float s1, float s2, float s3,
                                            int i, int k, int col0) {
  if (i == 0 && !col0) return make_float4(0.f, 0.f, 0.f, 0.f);
  const uint4 x = philox_words(seed, offset, i, k);
  if (i >= band2) {
    const float w = __fmul_rn(2.0f, s3);
    return make_float4(__fadd_rn(-s3, __fmul_rn(w, u01(x.x))), __fadd_rn(-s3, __fmul_rn(w, u01(x.y))),
                       __fadd_rn(-s3, __fmul_rn(w, u01(x.z))), __fadd_rn(-s3, __fmul_rn(w, u01(x.w))));
  }
  const float s = (i > 0 && i < band1) ? s1 : s2;
  const float4 z = normals4(x);
  return make_float4(__fmul_rn(z.x, s), __fmul_rn(z.y, s), __fmul_rn(z.z, s), __fmul_rn(z.w, s));
}

// K1a's noise for rollout_kernel: Philox chunk k of sample i at the offset (the
// bands do not depend on the parameter).
struct RandomBands {
  __device__ float4 operator()(const RSArgs& a, unsigned long long offset, int i, int k, int,
                               int) const {
    return rs_noise4(a.seed, offset, a.band1, a.band2, a.sigma1, a.sigma2, a.sigma3, i, k,
                     a.draw_col0);
  }
};

// The winner's extraction, by one block (warp 0 extracts): reads the argmin key,
// regenerates the winner's parameters from Philox at the offset (or reads them
// from noise_in), and writes out = [best cost, step-0 GRFs (12), one-step state
// (12), index, winner parameters (P)]. The winner's parameters and the basis's
// first 12 windows (16-byte aligned) are staged in shared memory, and
// the GRFs and state come from step0_extract_lanes, one lane per leg, as the
// update pass extracts them: the same arithmetic as one thread, so the same bits.
// R: how the incumbent is read.
template <int PL, Read R>
__device__ __forceinline__ void rs_extract(const RSArgs& a, unsigned long long offset,
                                           const BasisWindow* win, const float* incumbent,
                                           const float* noise_in, unsigned long long key,
                                           float* out) {
  constexpr int P = 4 * PL;
  constexpr int CH = padded_pl(PL) / 4;  // Philox chunks of a leg, as rollout_kernel draws them
  __shared__ float prm_s[P];
  __shared__ BasisWindow w0_s[12];
  const int idx = (int)(key & 0xffffffffull);
  const int N = a.num_samples;
  cp_async_step0_windows(w0_s, win, threadIdx.x, blockDim.x);
  for (int k = threadIdx.x; k < 4 * CH; k += blockDim.x) {
    const int q = k % CH, p = (k / CH) * PL + 4 * q;  // chunk q of leg k / CH
    const int valid = min(4, PL - 4 * q);
    float4 z;
    if (noise_in != nullptr) {
      z = load_params4(noise_in, N, idx, p, valid);
    } else {
      z = rs_noise4(a.seed, offset, a.band1, a.band2, a.sigma1, a.sigma2, a.sigma3, idx, k,
                    a.draw_col0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < valid) {
        const float v = __fadd_rn(load_in<R>(&incumbent[p + j]), comp(z, j));
        prm_s[p + j] = v;
        out[RS_OUT_WINNER + p + j] = v;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) {
    step0_extract_lanes(a, w0_s, prm_s, out);
    if (threadIdx.x == 0) {
      out[0] = __uint_as_float((unsigned int)(key >> 32));
      out[25] = (float)idx;
    }
  }
}

template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
rs_extract_kernel(const RSArgs a, const BasisWindow* __restrict__ win,
                  const float* __restrict__ incumbent, const float* __restrict__ noise_in,
                  const unsigned long long* __restrict__ argmin, float* __restrict__ out) {
  rs_extract<PL, Read::ReadOnly>(a, a.offset, win, incumbent, noise_in, *argmin, out);
}
