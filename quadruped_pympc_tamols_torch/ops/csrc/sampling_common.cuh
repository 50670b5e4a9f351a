// Device code shared by the sampling-MPC kernels (sampling_rs.cu, K1a;
// sampling_softmax.cu, K1b-K1d; sampling_groups.cu, K1e): the per-tick argument
// block, Philox4x32-10 and Box-Muller, the NaN-propagating clamps, one SRB Euler
// step under the force model, the per-leg basis product, one sample's H-step
// rollout cost, the argmin fold and the step-0 extraction.
//
// The random numbers go through __fmul_rn/__fadd_rn so that a kernel that
// regenerates a sample's noise from its Philox counter gets the same bits as the
// kernel that drew it. Build without --use_fast_math: the cost saturation depends
// on isnan/isinf.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_HMAX 16
#define RS_BLOCK 64
#define RS_OUT_WINNER 26  // out = [cost, grf(12), state(12), index, parameters(P)]

struct RSModel {
  float mass, gravity;
  float inertia[9];
  float inertia_inv[9];
  float scale_x, scale_y, grf_min, grf_max, mu;
};

// Everything a solve needs besides W, the incumbent and the outputs. Passed by
// value as a kernel parameter, so the per-tick inputs ride the launch itself.
struct RSArgs {
  int num_samples;  // N
  int horizon;      // H
  int band1;        // first sample of the sigma2 band (1 + N/3); random sampling only
  int band2;        // first sample of the uniform band (1 + 2*(N/3)); random sampling only
  unsigned long long seed;
  unsigned long long offset;
  float dts[RS_HMAX];
  float q_diag[12];
  RSModel model;
  float sigma1, sigma2, sigma3;  // random sampling only
  float state[12];
  float feet[12];               // leg-major xyz
  float ref[12];
  float contact[RS_HMAX * 4];   // step-major: n*4 + leg
  float share[RS_HMAX * 4];     // step-major: n*4 + leg
};

__device__ __forceinline__ float max_nan(float x, float y) { return (x > y || x != x) ? x : y; }
__device__ __forceinline__ float min_nan(float x, float y) { return (x < y || x != x) ? x : y; }
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four random words of parameters 4k..4k+3 of sample i: counter (i, k, offset),
// key seed.
__device__ __forceinline__ uint4 philox_words(unsigned long long seed, unsigned long long offset,
                                              int i, int k) {
  const uint4 ctr = make_uint4((unsigned int)i, (unsigned int)k,
                               (unsigned int)(offset & 0xffffffffull),
                               (unsigned int)(offset >> 32));
  const uint2 key = make_uint2((unsigned int)(seed & 0xffffffffull), (unsigned int)(seed >> 32));
  return philox4x32_10(ctr, key);
}

// Uniform in [0, 1) from the top 24 bits.
__device__ __forceinline__ float u01(unsigned int x) {
  return __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ float2 box_muller(unsigned int a, unsigned int b) {
  const float u1 = __fsub_rn(1.0f, u01(a));  // (0, 1]: the log is finite
  const float u2 = u01(b);
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincospif(__fmul_rn(2.0f, u2), &s, &c);
  return make_float2(__fmul_rn(r, c), __fmul_rn(r, s));
}

// Four standard normals from four random words.
__device__ __forceinline__ float4 normals4(uint4 x) {
  const float2 z01 = box_muller(x.x, x.y);
  const float2 z23 = box_muller(x.z, x.w);
  return make_float4(z01.x, z01.y, z23.x, z23.y);
}

// Parameters 4k..4k+3 of sample i in a (P, N) noise matrix.
__device__ __forceinline__ float4 load_noise4(const float* __restrict__ noise, int N, int i, int k) {
  return make_float4(noise[(size_t)(4 * k + 0) * N + i], noise[(size_t)(4 * k + 1) * N + i],
                     noise[(size_t)(4 * k + 2) * N + i], noise[(size_t)(4 * k + 3) * N + i]);
}

__device__ __forceinline__ void store_noise4(float* __restrict__ noise, int N, int i, int k,
                                             float4 z) {
  noise[(size_t)(4 * k + 0) * N + i] = z.x;
  noise[(size_t)(4 * k + 1) * N + i] = z.y;
  noise[(size_t)(4 * k + 2) * N + i] = z.z;
  noise[(size_t)(4 * k + 3) * N + i] = z.w;
}

// One Euler step of the SRB model under the force model, in the order of
// operations of controllers/sampling/rollout.py. s (12) is updated in place and
// f (12) receives the clamped forces.
__device__ __forceinline__ void srb_step(float* s, const float* raw, const float* c,
                                         const float* sh, float dt, const float* feet,
                                         const RSModel& m, float* f) {
  const float px = s[0], py = s[1], pz = s[2];
  const float vx = s[3], vy = s[4], vz = s[5];
  const float rr = s[6], pp = s[7], yy = s[8];
  const float wx = s[9], wy = s[10], wz = s[11];
  float Fx = 0.f, Fy = 0.f, Fz = 0.f, Tx = 0.f, Ty = 0.f, Tz = 0.f;
#pragma unroll
  for (int leg = 0; leg < 4; ++leg) {
    const float cl = c[leg];
    float fx = raw[leg * 3 + 0] * (cl * m.scale_x);
    float fy = raw[leg * 3 + 1] * (cl * m.scale_y);
    const float fz = clip_nan((sh[leg] + raw[leg * 3 + 2]) * cl, m.grf_min, m.grf_max);
    const float lim = m.mu * fz;
    fx = clip_nan(fx, -lim, lim);
    fy = clip_nan(fy, -lim, lim);
    f[leg * 3 + 0] = fx;
    f[leg * 3 + 1] = fy;
    f[leg * 3 + 2] = fz;
    Fx = Fx + fx;
    Fy = Fy + fy;
    Fz = Fz + fz;
    const float rx = feet[leg * 3 + 0] - px;
    const float ry = feet[leg * 3 + 1] - py;
    const float rz = feet[leg * 3 + 2] - pz;
    Tx = Tx + (ry * fz - rz * fy);
    Ty = Ty + (rz * fx - rx * fz);
    Tz = Tz + (rx * fy - ry * fx);
  }
  const float ax = Fx / m.mass, ay = Fy / m.mass, az = Fz / m.mass - m.gravity;
  const float sr = sinf(rr), cr = cosf(rr);
  const float sp = sinf(pp), cp = cosf(pp);
  const float sy = sinf(yy), cy = cosf(yy);
  const float tp = sp / cp;
  const float r_dot = wx + sr * tp * wy + cr * tp * wz;
  const float p_dot = cr * wy - sr * wz;
  const float y_dot = (sr * wy + cr * wz) / cp;
  const float tbx = cp * cy * Tx + cp * sy * Ty - sp * Tz;
  const float tby = (sr * sp * cy - cr * sy) * Tx + (sr * sp * sy + cr * cy) * Ty + sr * cp * Tz;
  const float tbz = (cr * sp * cy + sr * sy) * Tx + (cr * sp * sy - sr * cy) * Ty + cr * cp * Tz;
  const float* I = m.inertia;
  const float* Ii = m.inertia_inv;
  const float Iwx = I[0] * wx + I[1] * wy + I[2] * wz;
  const float Iwy = I[3] * wx + I[4] * wy + I[5] * wz;
  const float Iwz = I[6] * wx + I[7] * wy + I[8] * wz;
  const float gx = wy * Iwz - wz * Iwy;
  const float gy = wz * Iwx - wx * Iwz;
  const float gz = wx * Iwy - wy * Iwx;
  const float mx = tbx - gx, my = tby - gy, mz = tbz - gz;
  const float wdx = Ii[0] * mx + Ii[1] * my + Ii[2] * mz;
  const float wdy = Ii[3] * mx + Ii[4] * my + Ii[5] * mz;
  const float wdz = Ii[6] * mx + Ii[7] * my + Ii[8] * mz;
  s[0] = px + vx * dt;
  s[1] = py + vy * dt;
  s[2] = pz + vz * dt;
  s[3] = vx + ax * dt;
  s[4] = vy + ay * dt;
  s[5] = vz + az * dt;
  s[6] = rr + r_dot * dt;
  s[7] = pp + p_dot * dt;
  s[8] = yy + y_dot * dt;
  s[9] = wx + wdx * dt;
  s[10] = wy + wdy * dt;
  s[11] = wz + wdz * dt;
}

// raw[r] = sum_j W_blk[row0 + r][j] * prm[leg(r) * PL + j] for the 12 rows of one step.
template <int PL>
__device__ __forceinline__ void step_forces(const float* w_rows, const float* prm, float* raw) {
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const int leg = r / 3;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) acc = fmaf(w_rows[r * PL + j], prm[leg * PL + j], acc);
    raw[r] = acc;
  }
}

// Cost of one sample's H-step rollout under parameters prm (4*PL), NaN/Inf -> 1e6.
// w_s holds the (H*12, PL) own-leg blocks of the basis, contact and share the
// step-major (n*4 + leg) stance masks and per-leg shares.
template <int H, int PL>
__device__ __forceinline__ float rollout_cost_cols(const RSArgs& a, const float* w_s,
                                                   const float* contact, const float* share,
                                                   const float* prm) {
  const RSModel md = a.model;
  float st[12], ft[12], ref[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    st[j] = a.state[j];
    ft[j] = a.feet[j];
    ref[j] = a.ref[j];
  }
  float cost = 0.f;
#pragma unroll
  for (int n = 0; n < H; ++n) {
    float raw[12], f[12], c[4], sh[4];
    step_forces<PL>(&w_s[n * 12 * PL], prm, raw);
#pragma unroll
    for (int leg = 0; leg < 4; ++leg) {
      c[leg] = contact[n * 4 + leg];
      sh[leg] = share[n * 4 + leg];
    }
    srb_step(st, raw, c, sh, a.dts[n], ft, md, f);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float w = a.q_diag[j];
      if (w != 0.f) {
        const float e = st[j] - ref[j];
        cost = cost + w * e * e;
      }
    }
  }
  if (isnan(cost) || isinf(cost)) cost = 1.0e6f;
  return cost;
}

// The same under the argument block's own contact and share columns.
template <int H, int PL>
__device__ __forceinline__ float rollout_cost(const RSArgs& a, const float* w_s, const float* prm) {
  return rollout_cost_cols<H, PL>(a, w_s, a.contact, a.share, prm);
}

// The (cost bits << 32 | index) key. Costs are >= 0 (sums of non-negative
// squares or the 1e6 saturation), so keys order like (cost, index): the lowest
// cost first and, among equal costs, the lowest index (jnp.argmin and
// jax.lax.top_k semantics).
__device__ __forceinline__ unsigned long long cost_key(float cost, int i) {
  return ((unsigned long long)__float_as_uint(cost) << 32) | (unsigned long long)(unsigned int)i;
}

// Folds each warp's keys into one 64-bit atomicMin (~0ull marks "no sample").
__device__ __forceinline__ void fold_argmin(unsigned long long key, unsigned long long* argmin) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
    key = other < key ? other : key;
  }
  if ((threadIdx.x & 31) == 0 && key != ~0ull) atomicMin(argmin, key);
}

// Step-0 GRFs (12) and the one-step Euler state (12) under parameters prm,
// written to out[1..24]. One thread.
template <int PL>
__device__ __forceinline__ void step0_extract(const RSArgs& a, const float* w_blk,
                                              const float* prm, float* out) {
  const RSModel md = a.model;
  float st[12], ft[12], raw[12], f[12], c[4], sh[4];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    st[j] = a.state[j];
    ft[j] = a.feet[j];
  }
#pragma unroll
  for (int leg = 0; leg < 4; ++leg) {
    c[leg] = a.contact[leg];
    sh[leg] = a.share[leg];
  }
  step_forces<PL>(w_blk, prm, raw);
  srb_step(st, raw, c, sh, a.dts[0], ft, md, f);
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    out[1 + j] = f[j];
    out[13 + j] = st[j];
  }
}
