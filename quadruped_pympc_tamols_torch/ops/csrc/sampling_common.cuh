// Device code shared by the sampling-MPC kernels (sampling_rs.cu, K1a;
// sampling_softmax.cu, K1b-K1c; sampling_groups.cu, K1e; sampling_chain.cu, K1d;
// sampling_fleet.cu, K1f): the per-tick argument block, the basis windows,
// Philox4x32-10 and Box-Muller, the NaN-propagating
// clamps, the force model and the SRB Euler step, the argmin fold, the four-lane
// step-0 extraction, and the one rollout pass that all of them run
// (rollout_kernel, at the end; the chain kernel runs its parts in its own loop).
//
// What bounds the rollout pass on an H100: neither bytes (~0.05-0.2 MB a solve)
// nor FP32 throughput (~0.13 GFLOP a solve, ~2 us at peak) but latency. One
// thread per sample gave 10 000 threads, under one warp per scheduler on 132
// SMs, each running a ~13k-instruction dependent chain. So a sample is spread
// over four lanes, one per leg (40 000 threads): each lane draws its leg's noise
// and computes its leg's basis rows and forces, and the lanes share the body
// update's sines, cosines and divisions; blocks of ROLLOUT_SAMPLES samples (625
// at N = 10 000) spread evenly over the SMs, and the basis windows reach shared
// memory by a bulk asynchronous copy that overlaps the noise.
//
// The random numbers go through __fmul_rn/__fadd_rn so that a kernel that
// regenerates a sample's noise from its Philox counter gets the same bits as the
// kernel that drew it. Build without --use_fast_math: the cost saturation depends
// on isnan/isinf.
//
// Each library is built for one (horizon, parameters per leg) pair, given as
// -DSAMPLING_H and -DSAMPLING_PL: ops/build.py builds a pair's libraries the first
// time a solver asks for the pair, one nvcc per source. The kernels take H up to
// RS_MAX_H and PL up to RS_MAX_PL (P = 4 * PL <= 1024, the Pallas kernel's own
// bound). The basis reaches them as one BasisWindow a row (four weights and the
// first parameter's index; every row of every parametrization has at most four
// adjacent nonzero weights), and a lane stages its leg's parameters in shared
// memory, so neither grows with the product H * PL. A leg's PL parameters are
// drawn as ceil(PL/4) Philox chunks of four (the last one cut short when PL % 4
// != 0, as for linear splines with 9); every layout of parameters (the incumbent,
// sigma, the (P, N) noise, the outputs) keeps P = 4 * PL.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#if !defined(SAMPLING_H) || !defined(SAMPLING_PL)
#error "build with -DSAMPLING_H=<horizon> -DSAMPLING_PL=<parameters per leg> (see ops/build.py)"
#endif

// The bounds of ops/build.py:check_pair. RS_MAX_H: the chain kernel's staged
// windows (384 bytes a step) beside its largest arena; RS_MAX_PL: P = 4 * PL <= 1024.
#define RS_MAX_H 128
#define RS_MAX_PL 256
static_assert(SAMPLING_H >= 2 && SAMPLING_H <= RS_MAX_H && SAMPLING_PL >= 4 &&
                  SAMPLING_PL <= RS_MAX_PL,
              "ops/build.py:check_pair refuses the pair");
#define RS_BLOCK 64  // threads of the extraction kernel; samples a block of the update pass
// The rollout pass: lanes per sample (one per leg), samples per block, and the
// blocks per SM its register budget must allow (65 536 / (8 * 64) = 128 a thread).
#define ROLLOUT_LANES 4
#define ROLLOUT_SAMPLES 16
#define ROLLOUT_THREADS (ROLLOUT_LANES * ROLLOUT_SAMPLES)
#define ROLLOUT_MIN_BLOCKS 8
#define RS_OUT_WINNER 26  // out = [cost, grf(12), state(12), index, parameters(P)]

// A leg's parameters rounded up to whole Philox chunks of four: the values a lane
// draws.
__host__ __device__ constexpr int padded_pl(int PL) { return (PL + 3) / 4 * 4; }

struct RSModel {
  float mass, gravity;
  float inertia[9];
  float inertia_inv[9];
  float scale_x, scale_y, grf_min, grf_max, mu;
};

// Everything a solve needs besides the basis, the incumbent and the outputs.
// Passed by value as a kernel parameter, so the per-tick inputs ride the launch
// itself. The per-step arrays come last and are sized by the pair's horizon: 352 +
// 36 H bytes, 4 960 at H = 128, within the 32 KB of kernel parameters that CUDA
// 12.1 and later take (ops/sampling_kernel.py:args_type mirrors it).
struct RSArgs {
  int num_samples;  // N
  int horizon;      // H
  int band1;        // first sample of the sigma2 band (1 + N/3); random sampling only
  int band2;        // first sample of the uniform band (1 + 2*(N/3)); random sampling only
  unsigned long long seed;
  unsigned long long offset;
  float q_diag[12];
  RSModel model;
  float sigma1, sigma2, sigma3;  // random sampling only
  float state[12];
  float feet[12];  // leg-major xyz
  float ref[12];
  // 0: sample 0 is the incumbent (zero noise). 1: sample 0 draws noise as the
  // others do (random sampling: N(0, sigma2)), for the shards of a sample-sharded
  // solve other than the first, which must not each add a copy of the incumbent.
  int draw_col0;
  // The ZMP-band cost (config sampling.zmp_weight, zmp_margin; zmp_band); a
  // weight of 0 skips it.
  float zmp_weight, zmp_margin;
  int pad;  // the per-step arrays start at 352, 8-byte aligned, as in the ctypes mirror
  float dts[SAMPLING_H];
  float contact[SAMPLING_H * 4];  // step-major: n*4 + leg
  float share[SAMPLING_H * 4];    // step-major: n*4 + leg
};
static_assert(offsetof(RSArgs, dts) == 352, "the ctypes mirror's header");

// Row r of the basis as a window of four weights: w of parameters param ..
// param + 3 (leg-major, all within the row's own leg), every other weight of the
// row zero. Built once a plan (or once a tick for K1e's groups) by
// ops/sampling_kernel.py:basis_windows, which refuses a basis whose rows'
// nonzeros span more than four parameters (a cubic spline row holds 1 or 4
// contiguous nonzeros, a linear one 1 or 2, a zero-order hold 1). A window's sum
// in parameter order has the bits of the dense row's: the dense products outside
// it are fmaf(0, p, acc), which return acc for finite p.
#define RS_WINDOW 4
struct __align__(16) BasisWindow {
  float4 w;
  int param;
  int pad[3];
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

// How a kernel reads an input. ReadOnly: through the read-only (non-coherent)
// path, for what the launch never writes. L2: from L2 (ld.global.cg), for what an
// earlier phase of the same launch wrote (the chain kernel, sampling_chain.cu: the
// costs, the noise, the argmin key), which the read-only path and L1 may hold
// stale. Shared: a plain read of a copy in shared memory (the chain kernel stages
// each iteration's incumbent and CEM sigma there: read from L2 by every lane,
// those few lines made each rollout phase ~10 us slower, tools/chain_phases.py).
enum class Read { ReadOnly, L2, Shared };

template <Read R, class T>
__device__ __forceinline__ T load_in(const T* p) {
  if constexpr (R == Read::ReadOnly) {
    return __ldg(p);
  } else if constexpr (R == Read::L2) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Parameters 4k..4k+3 of sample i in a (P, N) noise matrix.
template <Read R = Read::ReadOnly>
__device__ __forceinline__ float4 load_noise4(const float* __restrict__ noise, int N, int i, int k) {
  return make_float4(load_in<R>(&noise[(size_t)(4 * k + 0) * N + i]),
                     load_in<R>(&noise[(size_t)(4 * k + 1) * N + i]),
                     load_in<R>(&noise[(size_t)(4 * k + 2) * N + i]),
                     load_in<R>(&noise[(size_t)(4 * k + 3) * N + i]));
}

// Component c of v.
__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Parameters p..p+valid-1 of sample i in a (P, N) noise matrix (zeros after them).
__device__ __forceinline__ float4 load_params4(const float* __restrict__ noise, int N, int i,
                                               int p, int valid) {
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = c < valid ? noise[(size_t)(p + c) * N + i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_params4(float* __restrict__ noise, int N, int i, int p,
                                              int valid, float4 z) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < valid) noise[(size_t)(p + c) * N + i] = comp(z, c);
}

// One leg's forces under the force model from its three raw basis rows: the x
// and y rows scaled by the stance mask, z the gravity share plus its row under
// the stance mask and clamped to [grf_min, grf_max], x and y clamped to the
// friction cone mu * fz.
__device__ __forceinline__ void leg_forces(float raw_x, float raw_y, float raw_z, float cl,
                                           float sh, const RSModel& m, float& fx, float& fy,
                                           float& fz) {
  fx = raw_x * (cl * m.scale_x);
  fy = raw_y * (cl * m.scale_y);
  fz = clip_nan((sh + raw_z) * cl, m.grf_min, m.grf_max);
  const float lim = m.mu * fz;
  fx = clip_nan(fx, -lim, lim);
  fy = clip_nan(fy, -lim, lim);
}

// Value v of lane q of this sample's ROLLOUT_LANES lanes.
__device__ __forceinline__ float from_lane(float v, int q) {
  return __shfl_sync(0xffffffffu, v, q, ROLLOUT_LANES);
}

// One Euler step of the SRB body under the clamped forces f (12, leg-major), in
// the order of operations of controllers/sampling/rollout.py: the force and
// torque sums over legs 0..3 in that order, then the body update. s (12) is
// updated in place. LANES: the four lanes of a sample call it together on the
// same s and f and share the step's branchy library calls: lane `leg` makes one
// sincosf (roll, pitch, yaw, yaw) and one IEEE division (Fx, Fy or Fz by the
// mass, or sin/cos of the pitch), exchanged by shuffles. The same functions of
// the same operands, so the same bits as one thread making every call, but three
// such calls a lane and step in place of eleven (y_dot's division stays on every
// lane).
// axy, if not nullptr, receives the step's horizontal accelerations (ax, ay), which
// the ZMP band reads.
template <bool LANES>
__device__ __forceinline__ void srb_body(float* s, const float* f, float dt, const float* feet,
                                         const RSModel& m, int leg, float* axy = nullptr) {
  const float px = s[0], py = s[1], pz = s[2];
  const float vx = s[3], vy = s[4], vz = s[5];
  const float rr = s[6], pp = s[7], yy = s[8];
  const float wx = s[9], wy = s[10], wz = s[11];
  float Fx = 0.f, Fy = 0.f, Fz = 0.f, Tx = 0.f, Ty = 0.f, Tz = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float fx = f[q * 3 + 0], fy = f[q * 3 + 1], fz = f[q * 3 + 2];
    Fx = Fx + fx;
    Fy = Fy + fy;
    Fz = Fz + fz;
    const float rx = feet[q * 3 + 0] - px;
    const float ry = feet[q * 3 + 1] - py;
    const float rz = feet[q * 3 + 2] - pz;
    Tx = Tx + (ry * fz - rz * fy);
    Ty = Ty + (rz * fx - rx * fz);
    Tz = Tz + (rx * fy - ry * fx);
  }
  float ax, ay, az, sr, cr, sp, cp, sy, cy, tp;
  if constexpr (LANES) {
    float sn, cs;
    sincosf(leg == 0 ? rr : leg == 1 ? pp : yy, &sn, &cs);
    sr = from_lane(sn, 0);
    cr = from_lane(cs, 0);
    sp = from_lane(sn, 1);
    cp = from_lane(cs, 1);
    sy = from_lane(sn, 2);
    cy = from_lane(cs, 2);
    const float q = (leg == 0 ? Fx : leg == 1 ? Fy : leg == 2 ? Fz : sp) / (leg == 3 ? cp : m.mass);
    ax = from_lane(q, 0);
    ay = from_lane(q, 1);
    az = from_lane(q, 2) - m.gravity;
    tp = from_lane(q, 3);
  } else {
    ax = Fx / m.mass;
    ay = Fy / m.mass;
    az = Fz / m.mass - m.gravity;
    sr = sinf(rr);
    cr = cosf(rr);
    sp = sinf(pp);
    cp = cosf(pp);
    sy = sinf(yy);
    cy = cosf(yy);
    tp = sp / cp;
  }
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
  if (axy != nullptr) {
    axy[0] = ax;
    axy[1] = ay;
  }
}

// The ZMP-band cost of one step, zmp_weight * pen, in the order of operations of
// controllers/sampling/rollout.py: the ZMP z = p_xy - (p_z / g) a_xy of the
// integrated position (px, py, pz) and the step's accelerations (ax, ay), and for
// each of the six two-stance pairs (i, j; k, l swing), masked by c_i c_j (1 - c_k)
// (1 - c_l) of the step's contact column c, the squared excess over zmp_margin of
// z's distance to the segment between feet i and j (ft, leg-major xyz).
__device__ __forceinline__ float zmp_band(const RSArgs& a, const float* c, const float* ft,
                                          float px, float py, float pz, float ax, float ay) {
  // Pair q (i, j, k, l) in byte q, two bits a leg (i highest): (0,3,1,2) (1,2,0,3)
  // (0,2,1,3) (1,3,0,2) (0,1,2,3) (2,3,0,1).
  constexpr unsigned long long PAIRS = 0xB11B72276336ull;
  const float g = a.model.gravity;
  const float zx = px - (pz / g) * ax;
  const float zy = py - (pz / g) * ay;
  float pen = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int b = (int)((PAIRS >> (8 * q)) & 0xFFull);
    const int i = b >> 6, j = (b >> 4) & 3, k = (b >> 2) & 3, l = b & 3;
    const float mask = c[i] * c[j] * (1.f - c[k]) * (1.f - c[l]);
    const float axp = ft[3 * i], ayp = ft[3 * i + 1];
    const float vxp = ft[3 * j] - axp, vyp = ft[3 * j + 1] - ayp;
    const float denom = vxp * vxp + vyp * vyp + 1e-9f;
    const float t = clip_nan(((zx - axp) * vxp + (zy - ayp) * vyp) / denom, 0.f, 1.f);
    const float dxp = zx - (axp + t * vxp);
    const float dyp = zy - (ayp + t * vyp);
    const float dist = sqrtf(dxp * dxp + dyp * dyp + 1e-12f);
    const float e = max_nan(dist - a.zmp_margin, 0.f);
    pen = pen + mask * (e * e);
  }
  return a.zmp_weight * pen;
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

// Row c of this leg's window w under the parameters x, where parameter j of the
// window is x[j * stride]: the window's four products in parameter order.
__device__ __forceinline__ float window_sum(float4 w, const float* x, int stride) {
  float acc = 0.f;
  acc = fmaf(w.x, x[0], acc);
  acc = fmaf(w.y, x[stride], acc);
  acc = fmaf(w.z, x[2 * stride], acc);
  acc = fmaf(w.w, x[3 * stride], acc);
  return acc;
}

// Step-0 GRFs (12) and one-step state (12) under parameters prm (P, leg-major)
// and the basis's first 12 windows w0, written to out[1..24], by the four lanes of
// each group of a full warp (lane % 4 = leg): the plain version's arithmetic
// (forces row by row in parameter order, legs summed 0..3), with the body update
// of the rollout pass.
__device__ __forceinline__ void step0_extract_lanes(const RSArgs& a, const BasisWindow* w0,
                                                    const float* prm, float* out) {
  const int leg = threadIdx.x % ROLLOUT_LANES;
  const RSModel md = a.model;
  float raw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) raw[c] = window_sum(w0[3 * leg + c].w, prm + w0[3 * leg + c].param, 1);
  float fx, fy, fz, f[12], st[12], ft[12];
  leg_forces(raw[0], raw[1], raw[2], a.contact[leg], a.share[leg], md, fx, fy, fz);
#pragma unroll
  for (int q = 0; q < ROLLOUT_LANES; ++q) {
    f[q * 3 + 0] = from_lane(fx, q);
    f[q * 3 + 1] = from_lane(fy, q);
    f[q * 3 + 2] = from_lane(fz, q);
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    st[j] = a.state[j];
    ft[j] = a.feet[j];
  }
  srb_body<true>(st, f, a.dts[0], ft, md, leg);
  // Constant indices only, so that f and st stay in registers.
  if (threadIdx.x < ROLLOUT_LANES) {
    out[1 + 3 * leg + 0] = fx;
    out[1 + 3 * leg + 1] = fy;
    out[1 + 3 * leg + 2] = fz;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 12; ++j) out[13 + j] = st[j];
  }
}

// -- the rollout pass (K1a-K1f) ------------------------------------------------------
//
// One sample is one group of ROLLOUT_LANES = 4 lanes of a warp, one lane per leg.
// The parameters are leg-major (leg * PL + j), and W is block-diagonal per leg,
// so lane `leg` draws and multiplies only its leg's PL parameters (Philox chunks
// leg * CH .. leg * CH + CH - 1 with CH = ceil(PL/4); when PL % 4 == 0 these are
// the counters one thread per sample drew for parameters 4k..4k+3), and each
// step computes its leg's 3 raw force rows, each on its row's window of four
// weights, and applies the force model to its leg. The four lanes then exchange
// their clamped forces with __shfl_sync and run the body update of
// srb_body<true> on the same twelve values, summing the legs in order 0..3, and
// share the step's sine-cosine pairs and divisions. The same arithmetic as one
// thread per sample, so the same bits.
//
// A lane stages its leg's parameters in shared memory, parameter j at
// prm[j * ROLLOUT_THREADS] from its own column (lane_params): a step's window
// starts at a parameter the step decides, which a register array cannot be
// indexed by, and at PL = 255 (zero-order holds at H = 85) a leg's parameters
// would not fit in registers anyway. The four legs of a uniform basis read the
// same j, so a warp's reads fall on 32 distinct banks.
//
// What the H100 showed (tools/rollout_variants.py times each choice): the pass
// is bound by each sample's serial chain more than by the SM's issue rate (with
// the step loop unrolled it takes as long at N = 1 250 as at N = 10 000).
// Library sinf/cosf and IEEE divisions are branchy sequences that do not
// overlap, so the lanes share a step's sines, cosines and four of its five
// divisions; and the unrolled loop cost more in instruction fetch than its
// scheduling freedom saved, so it is rolled.

// The staged windows and lane parameters of a rollout block. Up to
// RS_STATIC_WINDOW_BYTES of windows (H <= 64) and RS_STATIC_PARAM_BYTES of
// parameters (PL <= 64) they are static shared arrays; above, they take the
// kernel's dynamic shared memory (windows first), which its launch asks for and
// opts in to above 48 KB. At the flagship's (12, 24): 4.6 KB of windows and 6 KB of
// parameters, both static. With both always dynamic (these two bounds at 0) the
// flagship's rollout pass kept its bits and took 16.56-16.67 us against 15.88-15.98
// for K1b and K1c and 16.19-16.22 against 15.83-15.88 for K1e-mppi (H100,
// tools/pass_times.py static, dynamic, dynamic, static in one call; PERF.md §6).
#define RS_STATIC_WINDOW_BYTES 24576
#define RS_STATIC_PARAM_BYTES 16384
template <int H>
__host__ __device__ constexpr int window_bytes() {
  return H * 12 * (int)sizeof(BasisWindow);
}
template <int H>
__host__ __device__ constexpr int window_dyn_bytes() {
  return window_bytes<H>() > RS_STATIC_WINDOW_BYTES ? window_bytes<H>() : 0;
}
// Bytes of the parameters of `tiles` rollout tiles of ROLLOUT_THREADS lanes.
template <int PL>
__host__ __device__ constexpr int lane_param_bytes(int tiles = 1) {
  return tiles * PL * ROLLOUT_THREADS * 4;
}
template <int PL>
__host__ __device__ constexpr int lane_param_dyn_bytes() {
  return lane_param_bytes<PL>() > RS_STATIC_PARAM_BYTES ? lane_param_bytes<PL>() : 0;
}
template <int H, int PL>
__host__ __device__ constexpr int rollout_dyn_bytes() {
  return window_dyn_bytes<H>() + lane_param_dyn_bytes<PL>();
}
// The staged windows of the pair: a static array, or the start of dyn.
template <int H>
__device__ __forceinline__ BasisWindow* window_smem(unsigned char* dyn) {
  if constexpr (window_dyn_bytes<H>() > 0) {
    return reinterpret_cast<BasisWindow*>(dyn);
  } else {
    __shared__ BasisWindow w_s[H * 12];
    return w_s;
  }
}
// The block's lane parameters (PL, ROLLOUT_THREADS): a static array, or dyn after
// the windows.
template <int H, int PL>
__device__ __forceinline__ float* lane_param_smem(unsigned char* dyn) {
  if constexpr (lane_param_dyn_bytes<PL>() > 0) {
    return reinterpret_cast<float*>(dyn + window_dyn_bytes<H>());
  } else {
    __shared__ __align__(16) float prm_s[PL * ROLLOUT_THREADS];
    return prm_s;
  }
}

// Opts kernel in to `bytes` of dynamic shared memory once (a launch needs it when
// its static and dynamic shared memory pass 48 KB together), with the carveout
// that gives shared memory the most of an SM.
template <class Kernel>
static cudaError_t opt_in_smem(Kernel kernel, int bytes, bool& done) {
  if (done || bytes == 0) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

// Shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A 16-byte asynchronous copy from global (through L2 only, .cg) into shared
// memory, and the wait for every such copy of this thread.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// The first 12 windows (step 0's rows) into w0_s by cp.async, by threads t of
// `threads` (the caller waits with cp_async_wait_all and syncs).
__device__ __forceinline__ void cp_async_step0_windows(BasisWindow* w0_s, const BasisWindow* win,
                                                       int t, int threads) {
  static_assert(sizeof(BasisWindow) == 32, "two 16-byte copies a window");
  for (int q = t; q < 24; q += threads)
    cp_async16(reinterpret_cast<float4*>(w0_s) + q, reinterpret_cast<const float4*>(win) + q);
}

// An mbarrier that completes when one arrival and the announced bytes have landed.
__device__ __forceinline__ void bulk_barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival, announcing the bytes the bulk copies will deliver.
__device__ __forceinline__ void bulk_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Hopper's bulk asynchronous copy (the TMA without a tensor map): bytes (a
// multiple of 16) from 16-byte aligned global memory into 16-byte aligned shared
// memory, completing on bar. One thread issues it; no thread moves the data.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits until bar's phase `parity` has completed.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "BULK_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra BULK_WAIT;\n"
      "}\n"
      :
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// One lane's share of a sample's H-step rollout cost, NaN/Inf -> 1e6: prm holds
// this lane's leg's PL parameters (parameter j at prm[j * ROLLOUT_THREADS]), w_s
// the (H*12) windows, c_s and sh_s the step-major (n*4 + leg) stance masks and
// per-leg shares. All four lanes of the sample return the same cost.
template <int H, int PL>
__device__ __forceinline__ float lane_rollout_cost(const RSArgs& a, const BasisWindow* w_s,
                                                   const float* prm, const float* c_s,
                                                   const float* sh_s, int leg) {
  const RSModel md = a.model;
  float st[12], ft[12], ref[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    st[j] = a.state[j];
    ft[j] = a.feet[j];
    ref[j] = a.ref[j];
  }
  float cost = 0.f;
#pragma unroll 1  // see the note above: rolled, the body fits the instruction cache
  for (int n = 0; n < H; ++n) {
    // This leg's rows n*12 + 3*leg + c on their windows; they do not depend on
    // the state, so they overlap the previous step's chain.
    float raw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const BasisWindow& bw = w_s[n * 12 + 3 * leg + c];
      raw[c] = window_sum(bw.w, prm + (bw.param - leg * PL) * ROLLOUT_THREADS, ROLLOUT_THREADS);
    }
    float fx, fy, fz, f[12];
    leg_forces(raw[0], raw[1], raw[2], c_s[n * 4 + leg], sh_s[n * 4 + leg], md, fx, fy, fz);
#pragma unroll
    for (int q = 0; q < ROLLOUT_LANES; ++q) {
      f[q * 3 + 0] = from_lane(fx, q);
      f[q * 3 + 1] = from_lane(fy, q);
      f[q * 3 + 2] = from_lane(fz, q);
    }
    float axy[2];
    srb_body<true>(st, f, a.dts[n], ft, md, leg, axy);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float w = a.q_diag[j];
      if (w != 0.f) {
        const float e = st[j] - ref[j];
        cost = cost + w * e * e;
      }
    }
    if (a.zmp_weight > 0.f)  // uniform over the grid
      cost = cost + zmp_band(a, &c_s[n * 4], ft, st[0], st[1], st[2], axy[0], axy[1]);
  }
  if (isnan(cost) || isinf(cost)) cost = 1.0e6f;
  return cost;
}

// The column source of K1a-K1c: one static set of windows (H*12) for every sample
// and the argument block's contact and share columns; no cost offset.
template <int H, int PL>
struct StaticSource {
  const BasisWindow* win;  // 16-byte aligned
  int group_size;          // N
  int num_groups;          // 1

  __device__ void stage(const RSArgs& a, float* c_s, float* sh_s) const {
    for (int k = threadIdx.x; k < H * 4; k += blockDim.x) {
      c_s[k] = a.contact[k];
      sh_s[k] = a.share[k];
    }
  }
  __device__ void copy(BasisWindow* w_s, float*, float*, unsigned long long* bar) const {
    constexpr int bytes = window_bytes<H>();
    bulk_expect(bar, bytes);
    bulk_load(w_s, win, bytes, bar);
  }
  __device__ float finish(float cost) const { return cost; }
};

// This lane's PL parameters of sample i (its leg `leg`), incumbent[leg * PL + j] +
// noise into prm[j * ROLLOUT_THREADS]: Noise(a, offset, i, k, p, valid) gives the
// noise of parameters p..p+valid-1 of sample i from its Philox chunk k at the
// offset (unless noise_in is given; the rest of the float4 is not used), written
// to noise_out for a live sample. R: how the incumbent is read.
template <int PL, Read R, class Noise>
__device__ __forceinline__ void draw_params(const RSArgs& a, const Noise& noise,
                                            unsigned long long offset, const float* incumbent,
                                            const float* noise_in, float* noise_out, int i,
                                            bool live, int leg, float* prm) {
  constexpr int CH = padded_pl(PL) / 4;  // Philox chunks of one leg
  constexpr int last = PL - 4 * (CH - 1);  // values of the leg's last chunk
  const int N = a.num_samples;
  auto chunk = [&](int q) {
    const int k = leg * CH + q, p = leg * PL + 4 * q;  // Philox chunk, first parameter
    const int valid = q < CH - 1 ? 4 : last;
    const float4 z = noise_in != nullptr ? load_params4(noise_in, N, i, p, valid)
                                         : noise(a, offset, i, k, p, valid);
    if (noise_out != nullptr && live) store_params4(noise_out, N, i, p, valid, z);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < PL)
        prm[(4 * q + e) * ROLLOUT_THREADS] = __fadd_rn(load_in<R>(&incumbent[p + e]), comp(z, e));
  };
  if constexpr (CH <= 18) {  // up to PL = 72: unrolled, as before the windows
#pragma unroll
    for (int q = 0; q < CH; ++q) chunk(q);
  } else {
#pragma unroll 2
    for (int q = 0; q < CH; ++q) chunk(q);
  }
}

// The rollout pass: grid (ceil(group_size / ROLLOUT_SAMPLES), num_groups), one
// sample per ROLLOUT_LANES lanes. Sample j of group g is global sample
// i = g * group_size + j, its parameters drawn by draw_params at a.offset; Source
// gives the block's windows, contact and share columns (bulk-copied or staged into
// shared memory) and the cost's offset. Writes every cost and folds (cost bits
// << 32 | i) into one 64-bit atomicMin. A sample past the group's end runs on the
// group's last sample, so that every lane reaches the exchanges, and writes
// nothing.
template <int H, int PL, class Noise, class Source>
__global__ void __launch_bounds__(ROLLOUT_THREADS, ROLLOUT_MIN_BLOCKS)
rollout_kernel(const RSArgs a, const Noise noise, const Source src,
               const float* __restrict__ incumbent, const float* __restrict__ noise_in,
               float* __restrict__ noise_out, float* __restrict__ costs,
               unsigned long long* __restrict__ argmin) {
  static_assert(ROLLOUT_LANES == 4, "one lane per leg");
  static_assert(window_bytes<H>() % 16 == 0 && (H * 4 * 4) % 16 == 0,
                "bulk copies move multiples of 16 bytes");
  extern __shared__ __align__(16) unsigned char dyn_s[];
  BasisWindow* w_s = window_smem<H>(dyn_s);
  float* prm_s = lane_param_smem<H, PL>(dyn_s);
  __shared__ __align__(16) float c_s[H * 4];
  __shared__ __align__(16) float sh_s[H * 4];
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x == 0) bulk_barrier_init(&bar);
  src.stage(a, c_s, sh_s);
  __syncthreads();
  if (threadIdx.x == 0) src.copy(w_s, c_s, sh_s, &bar);

  // The noise and the parameters overlap the copy: they do not read it. Each lane
  // reads back only what it wrote itself.
  const int leg = threadIdx.x % ROLLOUT_LANES;
  const int j = blockIdx.x * ROLLOUT_SAMPLES + threadIdx.x / ROLLOUT_LANES;
  const bool live = j < src.group_size;
  const int i = blockIdx.y * src.group_size + (live ? j : src.group_size - 1);
  float* prm = prm_s + threadIdx.x;
  draw_params<PL, Read::ReadOnly>(a, noise, a.offset, incumbent, noise_in, noise_out, i, live, leg,
                                  prm);
  bulk_wait(&bar, 0);

  const float cost = src.finish(lane_rollout_cost<H, PL>(a, w_s, prm, c_s, sh_s, leg));
  if (live && leg == 0) costs[i] = cost;
  fold_argmin(live ? cost_key(cost, i) : ~0ull, argmin);
}

// The rollout pass's launch geometry, for every kernel that runs it.
template <int H, int PL, class Noise, class Source>
static cudaError_t launch_rollout(const RSArgs& a, const Noise& noise, const Source& src,
                                  const float* incumbent, const float* noise_in,
                                  float* noise_out, float* costs, unsigned long long* argmin,
                                  cudaStream_t stream) {
  constexpr int smem = rollout_dyn_bytes<H, PL>();
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(rollout_kernel<H, PL, Noise, Source>, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((src.group_size + ROLLOUT_SAMPLES - 1) / ROLLOUT_SAMPLES, src.num_groups);
  rollout_kernel<H, PL, Noise, Source><<<grid, ROLLOUT_THREADS, smem, stream>>>(
      a, noise, src, incumbent, noise_in, noise_out, costs, argmin);
  return cudaGetLastError();
}
