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
//   the rollout pass      in one of two layouts (below): each scenario's row of
//                         the tick buffer [state (12) | effective feet (12) | ref
//                         (12) | contact (H, 4) | share (H, 4)], its Philox seed
//                         and offset staged in shared memory; noise keyed on (the
//                         scenario's seed, its offset + iteration, the sample
//                         index within the scenario), sample 0 the incumbent,
//                         costs (S, N), and one 64-bit atomicMin a scenario.
//   then, over the S scenarios: K1a's extraction (rs_extract) in one block a
//   scenario, or the update pass of sampling_softmax.cuh (update_tile,
//   last_ticket, update_finish) over a grid (ceil(N/64), S) (FLEET_REGEN: two
//   tiles of 64 a block) with each scenario's own beta, partials, elites, sigma
//   refit and completion ticket.
//
// The layout is one int of the C entry (the wrapper picks it from S * N):
//
//   0            K1a's four-lane rollout (fleet_rollout_kernel, grid (ceil(N/16),
//                S)): block (x, s) stages a shared copy of the argument block and
//                bulk-copies the basis windows for its 16 samples, then runs K1a's
//                draw_params and lane_rollout_cost. Its latency per wave is K1a's,
//                so it is the faster layout while S * N fills the card about once;
//                the update pass reads back the (S, P, N) noise the rollout wrote.
//   FLEET_WIDE   the large-batch rollout (fleet_rollout_wide_kernel): one thread
//                a sample, fleet_wide_samples(P) samples of one scenario a block
//                (128 up to P = 288, 32 at P = 1024). It pays the staging once for
//                128 samples and runs the body update once a sample instead of on
//                four lanes; both layouts form the basis product on the same
//                windows (BasisWindow, built once a plan): about 14 000
//                instructions a sample, and half the four-lane layout's time at 64
//                x 10 000. A sample's parameters live in shared memory.
//   FLEET_REGEN  the update pass regenerates each nonzero-weight sample's noise
//                (and the CEM elites') from its Philox counter; the rollout writes
//                none, so no (S, P, N) buffer exists.
//
// Both layouts do the same arithmetic per sample: at S = 1 with K1a's seed and
// offset the costs and outputs are K1a's (K1b's, K1c's) bit for bit, and on
// finite inputs the layouts' costs, argmin keys and outputs are equal bit for bit
// (see fleet_rollout_wide_kernel for the one place where they could differ).
//
// What bounds it: at the fleet's small N (128 samples, 8 rollout blocks a
// scenario) the four-lane pass is latency-bound as K1a is (see
// sampling_common.cuh); at S * N = 640 000 (64 scenarios of 10 000) it had 40 000
// blocks in ~38 waves of 8 blocks an SM and paid its staging and its body update
// in every wave: the SMs' issue rate is the limit,
// which the large-batch layout spends on fewer instructions, and which bounds it
// in turn. The bytes stay small but for the noise of the read-back update, 2 x 4
// S P N bytes an iteration.
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
                     const float sigma_mppi, const BasisWindow* __restrict__ win,
                     const float* __restrict__ scen, const unsigned long long* __restrict__ seeds,
                     const unsigned long long* __restrict__ offsets,
                     const float* __restrict__ incumbent, const float* __restrict__ sigma,
                     const float* __restrict__ noise_in, float* __restrict__ noise_out,
                     float* __restrict__ costs, unsigned long long* __restrict__ argmin) {
  static_assert(ROLLOUT_LANES == 4, "one lane per leg");
  constexpr int P = 4 * PL;
  constexpr int bytes = window_bytes<H>();
  static_assert(bytes % 16 == 0, "bulk copies move multiples of 16 bytes");
  extern __shared__ __align__(16) unsigned char dyn_s[];
  BasisWindow* w_s = window_smem<H>(dyn_s);
  float* prm_s = lane_param_smem<H, PL>(dyn_s);
  __shared__ __align__(16) RSArgs a_s;
  __shared__ __align__(8) unsigned long long bar;
  const int s = blockIdx.y;
  if (threadIdx.x == 0) bulk_barrier_init(&bar);
  stage_scenario<H>(a, f, scen, seeds, offsets, s, &a_s);
  if (threadIdx.x == 0) {
    bulk_expect(&bar, bytes);
    bulk_load(w_s, win, bytes, &bar);
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
  float* prm = prm_s + threadIdx.x;
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

// The four-lane rollout's launch, with the dynamic shared memory of the largest
// pairs' staged windows and parameters (window_smem, lane_param_smem).
template <int H, int PL, int METHOD>
static cudaError_t launch_rollout_four(const RSArgs& a, const FleetArgs& f, float sigma_mppi,
                                       const BasisWindow* win, const float* scen,
                                       const unsigned long long* seeds,
                                       const unsigned long long* offsets, const float* incumbent,
                                       const float* sigma, const float* noise_in,
                                       float* noise_out, float* costs,
                                       unsigned long long* argmin, cudaStream_t stream) {
  constexpr int smem = rollout_dyn_bytes<H, PL>();
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(fleet_rollout_kernel<H, PL, METHOD>, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.num_samples + ROLLOUT_SAMPLES - 1) / ROLLOUT_SAMPLES, f.num_scenarios);
  fleet_rollout_kernel<H, PL, METHOD><<<grid, ROLLOUT_THREADS, smem, stream>>>(
      a, f, sigma_mppi, win, scen, seeds, offsets, incumbent, sigma, noise_in, noise_out, costs,
      argmin);
  return cudaGetLastError();
}

// -- the large-batch rollout (layout FLEET_WIDE) --------------------------------------

#define FLEET_WIDE 1   // layout bit: the rollout pass one thread a sample
#define FLEET_REGEN 2  // layout bit: the update pass regenerates the noise from Philox
// Samples (threads) of a block of the large-batch rollout: FLEET_WIDE_SAMPLES up
// to P = 288, where its parameters take at most FLEET_WIDE_PARAM_BYTES (48 KB at P
// = 96, so that four blocks fill an SM), and fewer whole warps above (32 at P =
// 1024); and the blocks an SM its register budget must allow (65 536 / (4 * 128)
// = 128 a thread).
#define FLEET_WIDE_SAMPLES 128
#define FLEET_WIDE_PARAM_BYTES (FLEET_WIDE_SAMPLES * 288 * 4)
#define FLEET_WIDE_MIN_BLOCKS 4
__host__ __device__ constexpr int fleet_wide_samples(int P) {
  return FLEET_WIDE_PARAM_BYTES / (P * 4) >= FLEET_WIDE_SAMPLES
             ? FLEET_WIDE_SAMPLES
             : (FLEET_WIDE_PARAM_BYTES / (P * 4) / 32 < 1 ? 32
                                                          : FLEET_WIDE_PARAM_BYTES / (P * 4) / 32 * 32);
}

// Noise of parameters p..p+valid-1 of sample i (its Philox chunk k) of a scenario
// with the given seed and offset, as the rollout pass draws it: K1a's bands
// (METHOD 0, RandomBands), or normals times (ScaledNormals) sigma_mppi where
// sigma is nullptr (MPPI) and the scenario's sigma (P,) else (CEM-MPPI).
template <int METHOD>
__device__ __forceinline__ float4 fleet_noise4(const RSArgs& a, unsigned long long seed,
                                               unsigned long long offset, float sigma_mppi,
                                               const float* sigma, int i, int k, int p,
                                               int valid) {
  if constexpr (METHOD == 0) {
    return rs_noise4(seed, offset, a.band1, a.band2, a.sigma1, a.sigma2, a.sigma3, i, k,
                     a.draw_col0);
  } else {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[c] = sigma == nullptr ? sigma_mppi : c < valid ? __ldg(&sigma[p + c]) : 0.f;
    return sm_noise4(seed, offset, i, k, make_float4(s[0], s[1], s[2], s[3]), a.draw_col0);
  }
}

// This thread's own value v through the exchange of srb_body<true>'s lanes: a
// shuffle within the group of ROLLOUT_LANES lanes from the thread itself. The
// value does not change; the shuffle keeps the compiler from seeing where it came
// from, as it cannot in srb_body<true>, so that the code that uses it compiles to
// the same operations there and here: nvcc and ptxas pick which products they
// fuse into FMAs from the shape of that code (a plain copy of srb_body fused one
// torque term of the body frame the other way and gave other bits).
__device__ __forceinline__ float via_lane(float v) {
  return __shfl_sync(0xffffffffu, v, threadIdx.x % ROLLOUT_LANES, ROLLOUT_LANES);
}

// srb_body<true> for one thread: f, the forces of all four legs, already through
// via_lane; this thread makes the step's three sincosf calls and four divisions
// that the four lanes share there and passes their results through via_lane as the
// lanes pass theirs through from_lane. The same functions of the same operands in
// code of the same shape, so the same bits.
__device__ __forceinline__ void srb_body_wide(float* s, const float* f, float dt,
                                              const float* feet, const RSModel& m, float* axy) {
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
  {
    float sn[3], cs[3];
    sincosf(rr, &sn[0], &cs[0]);
    sincosf(pp, &sn[1], &cs[1]);
    sincosf(yy, &sn[2], &cs[2]);
    sr = via_lane(sn[0]);
    cr = via_lane(cs[0]);
    sp = via_lane(sn[1]);
    cp = via_lane(cs[1]);
    sy = via_lane(sn[2]);
    cy = via_lane(cs[2]);
    ax = via_lane(Fx / m.mass);
    ay = via_lane(Fy / m.mass);
    az = via_lane(Fz / m.mass) - m.gravity;
    tp = via_lane(sp / cp);
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
  axy[0] = ax;
  axy[1] = ay;
}

// One sample's H-step rollout cost, NaN/Inf -> 1e6, by one thread: lane_rollout_cost
// of all four legs. prm: this thread's parameters in shared memory, parameter p at
// prm[p * T]; w_s, off_s: each row's window weights and its first parameter's
// offset (param * T); row_s the scenario's staged row.
template <int H, int PL>
__device__ __forceinline__ float wide_rollout_cost(const RSArgs& a, const float4* w_s,
                                                   const int* off_s, const float* prm,
                                                   const float* row_s) {
  constexpr int T = fleet_wide_samples(4 * PL);
  const RSModel md = a.model;
  const float* c_s = row_s + 36;
  const float* sh_s = row_s + 36 + 4 * H;
  float st[12], ft[12], ref[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    st[j] = row_s[j];
    ft[j] = row_s[12 + j];
    ref[j] = row_s[24 + j];
  }
  float cost = 0.f;
#pragma unroll 1
  for (int n = 0; n < H; ++n) {
    float fl[12], f[12];
#pragma unroll
    for (int leg = 0; leg < 4; ++leg) {
      // Rows n*12 + 3*leg + c on their windows, in parameter order as the four-lane
      // pass sums them over every j < PL: the products it forms outside the window
      // are fmaf(0, p, acc), which return acc for finite p.
      float raw[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int r = n * 12 + 3 * leg + c;
        raw[c] = window_sum(w_s[r], prm + off_s[r], T);
      }
      leg_forces(raw[0], raw[1], raw[2], c_s[n * 4 + leg], sh_s[n * 4 + leg], md, fl[3 * leg],
                 fl[3 * leg + 1], fl[3 * leg + 2]);
    }
#pragma unroll
    for (int j = 0; j < 12; ++j) f[j] = via_lane(fl[j]);
    float axy[2];
    srb_body_wide(st, f, a.dts[n], ft, md, axy);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float w = a.q_diag[j];
      if (w != 0.f) {
        const float e = st[j] - ref[j];
        cost = cost + w * e * e;
      }
    }
    if (a.zmp_weight > 0.f)  // the scenario's contact column n
      cost = cost + zmp_band(a, &c_s[n * 4], ft, st[0], st[1], st[2], axy[0], axy[1]);
  }
  if (isnan(cost) || isinf(cost)) cost = 1.0e6f;
  return cost;
}

// The large-batch rollout pass: grid (ceil(N / T), S) with T = fleet_wide_samples(P),
// thread t of block (x, s) sample j = x * T + t of scenario s. The block
// stages the basis windows and the scenario's row once; each thread draws its
// parameters (incumbent + noise, as draw_params: the noise from noise_in, or drawn
// and, given noise_out, written there) into shared memory and rolls its sample
// out. A sample past N runs on sample N - 1 and writes nothing. Costs and argmin
// keys as fleet_rollout_kernel's: bit-equal on finite inputs (a window skips only
// fmaf(0, p, acc) terms; for an infinite or NaN parameter outside a row's window
// the four-lane pass's cost saturates where this one's may not).
template <int H, int PL, int METHOD>
__global__ void __launch_bounds__(fleet_wide_samples(4 * PL), FLEET_WIDE_MIN_BLOCKS)
fleet_rollout_wide_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                          const float sigma_mppi, const BasisWindow* __restrict__ win,
                          const float* __restrict__ scen,
                          const unsigned long long* __restrict__ seeds,
                          const unsigned long long* __restrict__ offsets,
                          const float* __restrict__ incumbent, const float* __restrict__ sigma,
                          const float* __restrict__ noise_in, float* __restrict__ noise_out,
                          float* __restrict__ costs, unsigned long long* __restrict__ argmin) {
  constexpr int P = 4 * PL;
  constexpr int T = fleet_wide_samples(P);
  constexpr int CH = padded_pl(PL) / 4;  // Philox chunks of one leg
  static_assert(PL >= RS_WINDOW && T % 32 == 0, "a window within a leg; whole warps");
  extern __shared__ __align__(16) float prm_s[];  // (P, T): parameter p of thread t at p*T + t
  __shared__ float4 w_s[H * 12];
  __shared__ int off_s[H * 12];
  __shared__ float row_s[FLEET_ROW(H)];
  const int s = blockIdx.y, t = threadIdx.x;
  for (int r = t; r < H * 12; r += T) {
    w_s[r] = __ldg(&win[r].w);
    off_s[r] = __ldg(&win[r].param) * T;
  }
  const float* row = scen + (size_t)s * f.scen_stride;
  for (int k = t; k < FLEET_ROW(H); k += T) row_s[k] = __ldg(&row[k]);
  const unsigned long long seed = __ldg(&seeds[s]);
  const unsigned long long offset = __ldg(&offsets[s]) + (unsigned long long)f.iteration;

  const int N = a.num_samples;
  const size_t PN = (size_t)P * N;
  const int j = blockIdx.x * T + t;
  const bool live = j < N;
  const int i = live ? j : N - 1;
  const float* inc = incumbent + (size_t)s * f.inc_stride;
  const float* nin = noise_in != nullptr ? noise_in + s * PN : nullptr;
  float* nout = noise_out != nullptr ? noise_out + s * PN : nullptr;
  const float* sig = METHOD == 2 ? sigma + (size_t)s * P : nullptr;
  auto chunk = [&](int leg, int q) {
    const int k = leg * CH + q, p = leg * PL + 4 * q;  // Philox chunk, first parameter
    constexpr int last = PL - 4 * (CH - 1);           // values of the leg's last chunk
    const int valid = q < CH - 1 ? 4 : last;
    const float4 z = nin != nullptr
                         ? load_params4(nin, N, i, p, valid)
                         : fleet_noise4<METHOD>(a, seed, offset, sigma_mppi, sig, i, k, p, valid);
    if (nout != nullptr && live) store_params4(nout, N, i, p, valid, z);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < PL) prm_s[(p + e) * T + t] = __fadd_rn(__ldg(&inc[p + e]), comp(z, e));
  };
#pragma unroll 1
  for (int leg = 0; leg < 4; ++leg) {
    if constexpr (CH <= 18) {  // up to PL = 72: unrolled, as draw_params
#pragma unroll
      for (int q = 0; q < CH; ++q) chunk(leg, q);
    } else {
#pragma unroll 2
      for (int q = 0; q < CH; ++q) chunk(leg, q);
    }
  }
  __syncthreads();

  const float cost = wide_rollout_cost<H, PL>(a, w_s, off_s, prm_s + t, row_s);
  if (live) costs[(size_t)s * N + j] = cost;
  fold_argmin(live ? cost_key(cost, j) : ~0ull, argmin + 2 * s);
}

// The large-batch rollout's launch: its shared memory opted in once per
// instantiation (above 48 KB at P = 144), with the carveout that lets four blocks
// share an SM.
template <int H, int PL, int METHOD>
static cudaError_t launch_rollout_wide(const RSArgs& a, const FleetArgs& f, float sigma_mppi,
                                       const BasisWindow* win, const float* scen,
                                       const unsigned long long* seeds,
                                       const unsigned long long* offsets, const float* incumbent,
                                       const float* sigma, const float* noise_in,
                                       float* noise_out, float* costs,
                                       unsigned long long* argmin, cudaStream_t stream) {
  constexpr int T = fleet_wide_samples(4 * PL);
  constexpr int smem = 4 * PL * T * 4;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(fleet_rollout_wide_kernel<H, PL, METHOD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fleet_rollout_wide_kernel<H, PL, METHOD>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((a.num_samples + T - 1) / T, f.num_scenarios);
  fleet_rollout_wide_kernel<H, PL, METHOD><<<grid, T, smem, stream>>>(
      a, f, sigma_mppi, win, scen, seeds, offsets, incumbent, sigma, noise_in, noise_out, costs,
      argmin);
  return cudaGetLastError();
}

// Random sampling's extraction, one block a scenario: K1a's rs_extract on the
// scenario's staged arguments, argmin key, incumbent and output row.
template <int H, int PL>
__global__ void __launch_bounds__(RS_BLOCK)
fleet_extract_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                     const BasisWindow* __restrict__ win, const float* __restrict__ scen,
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
  rs_extract<PL, Read::ReadOnly>(a_s, a_s.offset, win, incumbent + (size_t)s * f.inc_stride,
                                 nin, argmin[2 * s], out + (size_t)s * (RS_OUT_WINNER + P));
}

// -- the update pass without the noise round trip (layout FLEET_REGEN) ---------------

// Tiles of RS_BLOCK samples a block of the regenerating update runs, one partial
// row and one list of block keys each, as update_tile writes them for one tile a
// block: a tile's fixed path (its costs' load, the weights, the barriers, the
// column sums, the ticket's fence and atomic) is latency, and at one tile a block
// it took 80 of the 131 us of MPPI's pass at 64 x 10 000 (tools/fleet_variants.py,
// regen-no-draw). Two tiles: 111 us; four (a 99 KB row buffer): 115.
#define FLEET_REGEN_TILES 2
// CEM block keys regen_cem_finish stages in shared memory (the rest it reads from
// L2), in place of update_finish's SM_STAGE_KEYS: at 64 x 10 000 (1570 keys a
// scenario) a CEM block then fits three to an SM as an MPPI block does, and the
// pass took 205 us in place of 227 (tools/fleet_variants.py, regen-stage-512).
#define FLEET_REGEN_STAGE_KEYS 512
// Bytes of the regenerating update's row buffer: every parameter of the
// FLEET_REGEN_TILES tiles' rows up to P = 288; above, the parameters in passes of
// regen_pass_chunks<PL>() Philox chunks (72, 288 parameters), each pass's columns
// summed over the same rows in the same order.
#define FLEET_REGEN_BUF_BYTES (FLEET_REGEN_TILES * RS_BLOCK * 289 * 4)
#define FLEET_REGEN_MAX_CHUNKS ((FLEET_REGEN_BUF_BYTES / (FLEET_REGEN_TILES * RS_BLOCK * 4) - 1) / 4)
template <int PL>
__host__ __device__ constexpr int regen_pass_chunks() {
  return 4 * (padded_pl(PL) / 4) <= FLEET_REGEN_MAX_CHUNKS ? 4 * (padded_pl(PL) / 4)
                                                           : FLEET_REGEN_MAX_CHUNKS;
}
// Floats of a row of that buffer (odd: no bank conflicts): P + 1 in one pass, the
// pass's parameters and the weight else.
template <int PL>
__host__ __device__ constexpr int regen_row_floats() {
  return regen_pass_chunks<PL>() == 4 * (padded_pl(PL) / 4) ? 4 * PL + 1
                                                            : 4 * regen_pass_chunks<PL>() + 1;
}

// v[i] of a register array by selects (an index unknown to the compiler would move
// the array to local memory).
template <int T>
__device__ __forceinline__ int pick(const int (&v)[T], int i) {
  int x = v[0];
#pragma unroll
  for (int u = 1; u < T; ++u)
    if (i == u) x = v[u];
  return x;
}

// update_tile for the FLEET_REGEN_TILES tiles b0, b0 + 1, ... (those below B) of
// one block, with each nonzero-weight sample's noise regenerated from its Philox
// counter (the scenario's seed and offset, sigma its CEM sigma or nullptr for
// MPPI's sigma_mppi) in place of read back from a (P, N) buffer. The rollout pass
// wrote exactly these values, and each tile's rows are compacted and summed in
// the same order, so every tile's partial row and keys keep update_tile's bits.
// The (row, Philox chunk) pairs of all the block's nonzero rows are spread over
// its threads, so that tiles with few nonzero weights keep every thread busy.
template <int PL>
__device__ __forceinline__ void regen_update_tiles(const RSArgs& a, const SMKnobs& kn,
                                                   unsigned long long seed,
                                                   unsigned long long offset, const float* sigma,
                                                   const float* costs, float beta, int b0, int B,
                                                   float* partials,
                                                   unsigned long long* block_keys,
                                                   unsigned char* arena) {
  constexpr int T = FLEET_REGEN_TILES;
  constexpr int P = 4 * PL;
  constexpr int CH = padded_pl(PL) / 4;  // Philox chunks of one leg
  constexpr int ROW = P + 1;
  constexpr int WT = RS_BLOCK / 32;      // warps of samples a tile
  constexpr int LANES = SM_UPDATE_THREADS / (T * RS_BLOCK);  // threads ranking one key
  static_assert(RS_BLOCK % 32 == 0 && LANES >= 1 && LANES * T * RS_BLOCK == SM_UPDATE_THREADS &&
                    (LANES & (LANES - 1)) == 0,
                "whole warps of samples; a power-of-two group of threads ranks each key");
  __shared__ int nz_s[T * RS_BLOCK];
  __shared__ float nzw_s[T * RS_BLOCK];
  __shared__ unsigned long long key_s[T * RS_BLOCK];
  __shared__ int count_s[T * WT];
  const int N = a.num_samples;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. Weights and keys, sample t % RS_BLOCK of tile t / RS_BLOCK; each tile's
  // nonzero weights compacted in thread order.
  const int i0 = b0 * RS_BLOCK;
  float w = 0.f;
  unsigned long long key = ~0ull;
  if (t < T * RS_BLOCK && i0 + t < N) {
    const float c = __ldg(&costs[i0 + t]);
    w = expf(-(c - beta) / kn.temperature);
    key = cost_key(c, i0 + t);
  }
  unsigned int nz = 0u;
  if (t < T * RS_BLOCK) {
    nz = __ballot_sync(0xffffffffu, w != 0.f);
    if (lane == 0) count_s[warp] = __popc(nz);
    key_s[t] = key;
  }
  __syncthreads();
  int m[T];  // nonzero rows of each tile
#pragma unroll
  for (int u = 0; u < T; ++u) {
    m[u] = 0;
#pragma unroll
    for (int v = 0; v < WT; ++v) m[u] += count_s[u * WT + v];
  }
  if (w != 0.f) {
    int pos = __popc(nz & ((1u << lane) - 1u));
    for (int u = (warp / WT) * WT; u < warp; ++u) pos += count_s[u];
    const int row = (warp / WT) * RS_BLOCK + pos;
    nz_s[row] = t % RS_BLOCK;
    nzw_s[row] = w;
  }
  __syncthreads();

  // 2. The tiles' rows of (w * noise, w): the (row, chunk) pairs of tile 0's m[0]
  // rows first, then tile 1's, ..., one pair a thread at a time, for the pass's
  // chunks [k0, k0 + kc), whose parameters [p_lo, p_hi) are contiguous. 3. Each
  // tile's partial row over the pass's columns (and, in the first pass, the
  // weights'): each column summed over the tile's nonzero rows in order.
  constexpr int KC = 4 * CH;  // Philox chunks of a sample
  constexpr int KB = regen_pass_chunks<PL>();
  constexpr int RB = regen_row_floats<PL>();  // buffer row; column RB - 1 the weight
  float* buf_s = reinterpret_cast<float*>(arena);  // (T * RS_BLOCK, RB)
  for (int k0 = 0; k0 < KC; k0 += KB) {
    const int kc = KC - k0 < KB ? KC - k0 : KB;
    const int p_lo = (k0 / CH) * PL + 4 * (k0 % CH);
    const int kl = k0 + kc - 1;
    const int p_hi = (kl / CH) * PL + 4 * (kl % CH) + min(4, PL - 4 * (kl % CH));
    int pairs = 0;
#pragma unroll
    for (int u = 0; u < T; ++u) pairs += m[u] * kc;
    for (int j = t; j < pairs; j += SM_UPDATE_THREADS) {
      int tl = 0, jj = j;
#pragma unroll
      for (int u = 0; u < T - 1; ++u)
        if (tl == u && jj >= m[u] * kc) {
          jj -= m[u] * kc;
          tl = u + 1;
        }
      const int nb = pick(m, tl);
      const int r = jj % nb, k = k0 + jj / nb;  // row of the tile, Philox chunk
      const int q = k % CH, p = (k / CH) * PL + 4 * q;
      const int valid = min(4, PL - 4 * q);
      const int row = tl * RS_BLOCK + r;
      const float wr = nzw_s[row];
      const float4 z = fleet_noise4<1>(a, seed, offset, kn.sigma_mppi, sigma,
                                       i0 + tl * RS_BLOCK + nz_s[row], k, p, valid);
      float* out_row = &buf_s[row * RB + p - p_lo];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < valid) out_row[c] = __fmul_rn(wr, comp(z, c));
    }
    if (k0 == 0 && t < T * RS_BLOCK && t % RS_BLOCK < pick(m, t / RS_BLOCK))
      buf_s[t * RB + RB - 1] = nzw_s[t];
    __syncthreads();
    for (int tc = t; tc < T * RB; tc += SM_UPDATE_THREADS) {
      const int tl = tc / RB, col = tc % RB, nb = pick(m, tl);
      const int gcol = col == RB - 1 ? (k0 == 0 ? P : -1) : (col < p_hi - p_lo ? p_lo + col : -1);
      if (gcol < 0) continue;
      float acc = 0.f;
      const float* rows = &buf_s[tl * RS_BLOCK * RB + col];
#pragma unroll 8
      for (int r = 0; r < nb; ++r) acc = __fadd_rn(acc, rows[r * RB]);
      if (b0 + tl < B) partials[(size_t)(b0 + tl) * ROW + gcol] = acc;
    }
    __syncthreads();
  }
  if (kn.cem && kn.n_elite <= SM_KMAX) {
    // Rank of each key in its tile, LANES threads a key; equal keys (only the ~0ull
    // of missing samples) rank by thread. The K lowest land in rank order.
    constexpr int SPAN = RS_BLOCK / LANES;
    const int kt = t / LANES, part = t % LANES;
    const int tl = kt / RS_BLOCK, kidx = kt % RS_BLOCK;
    const unsigned long long kk = key_s[kt];
    int rank = 0;
#pragma unroll
    for (int u = part * SPAN; u < (part + 1) * SPAN; ++u) {
      const unsigned long long ku = key_s[tl * RS_BLOCK + u];
      rank += (ku < kk || (ku == kk && u < kidx)) ? 1 : 0;
    }
#pragma unroll
    for (int off = 1; off < LANES; off <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (part == 0 && rank < kn.n_elite && b0 + tl < B)
      block_keys[(size_t)(b0 + tl) * kn.n_elite + rank] = kk;
  }
}

// update_finish's CEM half (warps 4-15) with the K elites' noise regenerated from
// their Philox counters, one (elite, chunk) pair a thread, in place of read back:
// the same selection of the elites from the B*K block keys (above SM_KMAX elites:
// from the scenario's N costs) and the same refit in elite order, so the same
// bits. The caller runs update_finish's other half (warps 0-3) beside it.
template <int PL>
__device__ __forceinline__ void regen_cem_finish(const RSArgs& a, const SMKnobs& kn,
                                                 const float* sigma, const float* costs, int B,
                                                 unsigned long long* block_keys,
                                                 float* sigma_out, int* elites,
                                                 unsigned char* arena) {
  constexpr int P = 4 * PL;
  constexpr int CH = padded_pl(PL) / 4;
  __shared__ int elite_s[SM_KMAX];
  __shared__ unsigned long long t0_s;
  __shared__ int ncand_s;
  const int ct = threadIdx.x - SM_COL_THREADS;
  const int K = kn.n_elite;
  const int mk = B * K;
  unsigned long long* stage_s =
      reinterpret_cast<unsigned long long*>(arena + sm_tile_bytes(P, B));
  // One elite's noise chunk k (of 4 * CH) into row (P floats), drawn again.
  auto fill = [&](int i, int k, float* row) {
    const int q = k % CH, p = (k / CH) * PL + 4 * q;
    const int valid = min(4, PL - 4 * q);
    const float4 z = fleet_noise4<1>(a, a.seed, a.offset, kn.sigma_mppi, sigma, i, k, p, valid);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < valid) row[p + c] = comp(z, c);
  };
  if (K > SM_KMAX) {
    const int n = a.num_samples;
    compact_elites<Read::ReadOnly>(costs, n, kth_lowest_key<Read::ReadOnly>(costs, n, K, ct),
                                   elites, ct);
    group_sync<1, SM_CEM_THREADS>();
    refit_in_batches<P, 4 * CH>(kn, elites, K, fill, reinterpret_cast<float*>(stage_s), sigma_out,
                                ct);
    return;
  }
  const int staged = mk < FLEET_REGEN_STAGE_KEYS ? mk : FLEET_REGEN_STAGE_KEYS;
  for (int q = ct; q < staged / 2; q += SM_CEM_THREADS)
    cp_async16(&stage_s[2 * q], &block_keys[2 * q]);  // block_keys is 16-byte aligned
  if ((staged & 1) && ct == 0) stage_s[staged - 1] = __ldcg(&block_keys[staged - 1]);
  if (ct == 0) ncand_s = 0;
  cp_async_wait_all();
  group_sync<1, SM_CEM_THREADS>();
  // The elites are the K lowest keys at or below t0, the K-th lowest of the
  // blocks' list heads (update_finish says why).
  unsigned long long* cand_s = stage_s + staged;  // (K*K)
  if (K > B) {
    if (ct == 0) t0_s = ~0ull - 1ull;  // every real key; not the missing samples' ~0ull
  } else {
    int G = 1;
    while (2 * G * B <= SM_CEM_THREADS && G < 32) G *= 2;
    const int staged_heads = min(B, (staged + K - 1) / K);
    for (int g0 = 0; g0 < B * G; g0 += SM_CEM_THREADS) {
      const int g = g0 + ct, b = g / G, part = g % G;
      unsigned long long h = ~0ull;
      int rank = 0;
      if (b < B) {
        h = b * K < staged ? stage_s[b * K] : __ldcg(&block_keys[b * K]);
        int b2 = part;
#pragma unroll 8
        for (; b2 < staged_heads; b2 += G) rank += stage_s[b2 * K] < h ? 1 : 0;
        for (; b2 < B; b2 += G) rank += __ldcg(&block_keys[b2 * K]) < h ? 1 : 0;
      }
      for (int off = 1; off < G; off <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
      if (b < B && part == 0 && rank == K - 1) t0_s = h;
    }
  }
  group_sync<1, SM_CEM_THREADS>();
  const unsigned long long t0 = t0_s;
  for (int c = ct; c < mk; c += SM_CEM_THREADS) {
    const unsigned long long k = c < staged ? stage_s[c] : __ldcg(&block_keys[c]);
    if (k <= t0) cand_s[atomicAdd(&ncand_s, 1)] = k;
  }
  group_sync<1, SM_CEM_THREADS>();
  const int nc = ncand_s;
  for (int i = ct; i < nc; i += SM_CEM_THREADS) {
    const unsigned long long ki = cand_s[i];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < nc; ++j) rank += cand_s[j] < ki ? 1 : 0;
    if (rank < K) elite_s[rank] = (int)(ki & 0xffffffffull);
  }
  group_sync<1, SM_CEM_THREADS>();
  float* x_s = reinterpret_cast<float*>(stage_s);  // (K, P), over the staged keys
  if (K * P * 4 > SM_ELITE_BYTES) {  // above P = 288: the elites' noise in batches
    refit_in_batches<P, 4 * CH>(kn, elite_s, K, fill, x_s, sigma_out, ct);
    if (ct < K) elites[ct] = elite_s[ct];
    return;
  }
  // The elites' noise, one Philox chunk a thread.
  for (int j = ct; j < K * 4 * CH; j += SM_CEM_THREADS) {
    const int e = j % K, k = j / K;
    const int q = k % CH, p = (k / CH) * PL + 4 * q;
    const int valid = min(4, PL - 4 * q);
    const float4 z = fleet_noise4<1>(a, a.seed, a.offset, kn.sigma_mppi, sigma, elite_s[e], k, p,
                                     valid);
    float* xe = &x_s[e * P + p];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < valid) xe[c] = comp(z, c);
  }
  group_sync<1, SM_CEM_THREADS>();
  for (int p = ct; p < P; p += SM_CEM_THREADS) {
    float mean = 0.f;
#pragma unroll 4
    for (int e = 0; e < K; ++e) mean += x_s[e * P + p];
    mean = mean / (float)K;
    float ss = 0.f;
#pragma unroll 4
    for (int e = 0; e < K; ++e) {
      const float d = x_s[e * P + p] - mean;
      ss += d * d;
    }
    const float var = ss / (float)(K - 1) + 1e-8f;
    sigma_out[p] = clip_nan(sqrtf(var), kn.sigma_min, kn.sigma_max);
  }
  if (ct < K) elites[ct] = elite_s[ct];
}

// Blocks of the regenerating update pass an SM must hold: at three blocks (42
// registers a thread, a few spilled) an SM hides more of its latency than at two,
// 130 us in place of 156-167 for MPPI at 64 x 10 000 with one tile a block
// (tools/fleet_variants.py, regen-2-blocks); four spilled more and gained nothing.
#define FLEET_REGEN_MIN_BLOCKS 3

// The update pass with a scenario axis: block (b, s) runs tile b of scenario s
// (REGEN: tiles FLEET_REGEN_TILES * b, ...); the scenario's last block to take its
// ticket finishes it on the scenario's staged arguments over its B tiles' partial
// rows and keys. argmin holds (key, ticket) pairs, one a scenario. REGEN: the
// tiles and the CEM elites draw their noise again (regen_update_tiles,
// regen_cem_finish, at the scenario's seed, offset + iteration and input sigma
// sigma_in) and noise is not read; else they read it back from noise (S, P, N).
template <int H, int PL, bool REGEN>
__global__ void __launch_bounds__(SM_UPDATE_THREADS,
                                  REGEN ? FLEET_REGEN_MIN_BLOCKS : SM_UPDATE_MIN_BLOCKS)
fleet_update_kernel(const __grid_constant__ RSArgs a, const __grid_constant__ FleetArgs f,
                    const SMKnobs kn, const BasisWindow* __restrict__ win,
                    const float* __restrict__ scen, const unsigned long long* __restrict__ seeds,
                    const unsigned long long* __restrict__ offsets,
                    const float* __restrict__ incumbent, const float* __restrict__ sigma_in,
                    const float* __restrict__ noise, const float* __restrict__ costs,
                    unsigned long long* argmin, float* partials, unsigned long long* block_keys,
                    float* __restrict__ out, float* __restrict__ sigma_out,
                    int* __restrict__ elites) {
  constexpr int P = 4 * PL;
  extern __shared__ __align__(16) unsigned char arena[];
  __shared__ __align__(16) RSArgs a_s;
  const int s = blockIdx.y;
  const int N = a.num_samples;
  float inc_r[(P + SM_COL_THREADS - 1) / SM_COL_THREADS];
  finish_incumbent<PL, Read::ReadOnly>(incumbent + (size_t)s * f.inc_stride, inc_r);
  const unsigned long long best_key = argmin[2 * s];
  const float beta = __uint_as_float((unsigned int)(best_key >> 32));
  const float* noise_s = REGEN ? nullptr : noise + (size_t)s * P * N;
  const float* sigma_s = kn.cem ? sigma_in + (size_t)s * P : nullptr;
  float* part_s = partials + (size_t)s * f.part_stride;
  unsigned long long* keys_s = kn.cem ? block_keys + (size_t)s * f.key_stride : nullptr;
  float* out_s = out + (size_t)s * (RS_OUT_WINNER + P);
  float* sigma_out_s = kn.cem ? sigma_out + (size_t)s * P : nullptr;
  int* elites_s = kn.cem ? elites + (size_t)s * kn.n_elite : nullptr;
  const int B = REGEN ? (N + RS_BLOCK - 1) / RS_BLOCK : gridDim.x;  // tiles
  if constexpr (REGEN) {
    regen_update_tiles<PL>(a, kn, __ldg(&seeds[s]),
                           __ldg(&offsets[s]) + (unsigned long long)f.iteration, sigma_s,
                           costs + (size_t)s * N, beta, blockIdx.x * FLEET_REGEN_TILES, B, part_s,
                           keys_s, arena);
  } else {
    update_tile<PL, Read::ReadOnly>(a, kn, noise_s, costs + (size_t)s * N, beta, blockIdx.x,
                                    part_s, keys_s, arena);
  }
  if (!last_ticket(argmin + 2 * s + 1, gridDim.x)) return;
  __threadfence();
  stage_scenario<H>(a, f, scen, seeds, offsets, s, &a_s);
  if constexpr (REGEN) {
    SMKnobs cols = kn;
    cols.cem = 0;  // update_finish's warps 0-3 only: the column sums and the extraction
    update_finish<PL, Read::ReadOnly>(a_s, cols, win, inc_r, nullptr, nullptr, best_key, B,
                                      part_s, nullptr, out_s, nullptr, nullptr, arena);
    if (kn.cem && threadIdx.x >= SM_COL_THREADS)
      regen_cem_finish<PL>(a_s, kn, sigma_s, costs + (size_t)s * N, B, keys_s, sigma_out_s,
                           elites_s, arena);
  } else {
    update_finish<PL, Read::ReadOnly>(a_s, kn, win, inc_r, noise_s, costs + (size_t)s * N,
                                      best_key, gridDim.x, part_s, keys_s, out_s, sigma_out_s,
                                      elites_s, arena);
  }
}

// Bytes of the regenerating update's row buffer.
template <int PL>
__host__ __device__ constexpr int regen_buf_bytes() {
  return FLEET_REGEN_TILES * RS_BLOCK * regen_row_floats<PL>() * 4;
}

// Dynamic shared memory of the update pass over num_blocks tiles: sm_update_smem's;
// for REGEN the FLEET_REGEN_TILES tiles' row buffer, and in the last block the
// finish's partials tile and, for CEM, FLEET_REGEN_STAGE_KEYS staged keys at most
// and the elites' candidates, then their noise.
template <int PL>
static inline int fleet_update_smem(int cem, int n_elite, int num_blocks, bool regen) {
  constexpr int P = 4 * PL;
  if (!regen) return sm_update_smem(P, cem, n_elite, num_blocks);
  int finish = sm_tile_bytes(P, num_blocks);
  if (cem && n_elite > SM_KMAX) {
    finish += sm_elite_batch(P) * P * 4;  // a batch of the elites' noise (refit_in_batches)
  } else if (cem) {
    const int m = num_blocks * n_elite;
    const int keys =
        ((m < FLEET_REGEN_STAGE_KEYS ? m : FLEET_REGEN_STAGE_KEYS) + n_elite * n_elite) * 8;
    const int noise = sm_elite_noise_bytes(P, n_elite);
    finish += keys > noise ? keys : noise;
  }
  const int batch = regen_buf_bytes<PL>();
  return batch > finish ? batch : finish;
}

// Above 48 KB of dynamic shared memory needs an opt-in, given once for the most
// the update pass can ask for (as update_opt_in does for sm_update_kernel).
template <int H, int PL, bool REGEN>
static cudaError_t fleet_update_opt_in() {
  static bool opted_in = false;
  if (opted_in) return cudaSuccess;
  int most = sm_tile_bytes(4 * PL, SM_TILE_ROWS) + (SM_STAGE_KEYS + SM_KMAX * SM_KMAX) * 8;
  const int batch = regen_buf_bytes<PL>();
  most = most > batch ? most : batch;
  cudaError_t err = cudaFuncSetAttribute(fleet_update_kernel<H, PL, REGEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fleet_update_kernel<H, PL, REGEN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  opted_in = err == cudaSuccess;
  return err;
}

template <int H, int PL, bool REGEN>
static cudaError_t launch_fleet_update(const RSArgs& a, const FleetArgs& f, const SMKnobs& kn,
                                       const BasisWindow* win, const float* scen,
                                       const unsigned long long* seeds,
                                       const unsigned long long* offsets, const float* incumbent,
                                       const float* sigma_in, const float* noise,
                                       const float* costs, unsigned long long* argmin,
                                       float* partials, unsigned long long* block_keys, float* out,
                                       float* sigma_out, int* elites, cudaStream_t stream) {
  cudaError_t err = fleet_update_opt_in<H, PL, REGEN>();
  if (err != cudaSuccess) return err;
  const int tiles = (a.num_samples + RS_BLOCK - 1) / RS_BLOCK;
  const int smem = fleet_update_smem<PL>(kn.cem, kn.n_elite, tiles, REGEN);
  const int blocks = REGEN ? (tiles + FLEET_REGEN_TILES - 1) / FLEET_REGEN_TILES : tiles;
  const dim3 grid(blocks, f.num_scenarios);
  fleet_update_kernel<H, PL, REGEN><<<grid, SM_UPDATE_THREADS, smem, stream>>>(
      a, f, kn, win, scen, seeds, offsets, incumbent, sigma_in, noise, costs, argmin, partials,
      block_keys, out, sigma_out, elites);
  return cudaGetLastError();
}

template <int H, int PL>
static int fleet_launch_t(const RSArgs* a, const FleetArgs* f, const SMKnobs* kn, int method,
                          int layout, const BasisWindow* win,
                          const float* scen, const unsigned long long* seeds,
                          const unsigned long long* offsets, const float* incumbent,
                          const float* sigma_in, const float* noise_in, float* noise_out,
                          float* costs, unsigned long long* argmin, float* partials,
                          unsigned long long* block_keys, float* out, float* sigma_out,
                          int* elites, cudaStream_t stream) {
  const int S = f->num_scenarios;
  cudaError_t err =
      cudaMemsetAsync(argmin, 0xFF, 2 * (size_t)S * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  if (layout & FLEET_WIDE) {
    if (method == 0) {
      err = launch_rollout_wide<H, PL, 0>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                          incumbent, sigma_in, noise_in, noise_out, costs,
                                          argmin, stream);
    } else if (method == 1) {
      err = launch_rollout_wide<H, PL, 1>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                          incumbent, sigma_in, noise_in, noise_out, costs,
                                          argmin, stream);
    } else {
      err = launch_rollout_wide<H, PL, 2>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                          incumbent, sigma_in, noise_in, noise_out, costs,
                                          argmin, stream);
    }
  } else if (method == 0) {
    err = launch_rollout_four<H, PL, 0>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                        incumbent, sigma_in, noise_in, noise_out, costs, argmin,
                                        stream);
  } else if (method == 1) {
    err = launch_rollout_four<H, PL, 1>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                        incumbent, sigma_in, noise_in, noise_out, costs, argmin,
                                        stream);
  } else {
    err = launch_rollout_four<H, PL, 2>(*a, *f, kn->sigma_mppi, win, scen, seeds, offsets,
                                        incumbent, sigma_in, noise_in, noise_out, costs, argmin,
                                        stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (method == 0) {
    fleet_extract_kernel<H, PL><<<S, RS_BLOCK, 0, stream>>>(*a, *f, win, scen, seeds, offsets,
                                                            incumbent, noise_in, argmin, out);
    return (int)cudaGetLastError();
  }
  if (layout & FLEET_REGEN)
    return (int)launch_fleet_update<H, PL, true>(*a, *f, *kn, win, scen, seeds, offsets,
                                                 incumbent, sigma_in, nullptr, costs, argmin,
                                                 partials, block_keys, out, sigma_out, elites,
                                                 stream);
  return (int)launch_fleet_update<H, PL, false>(*a, *f, *kn, win, scen, seeds, offsets,
                                                incumbent, sigma_in,
                                                noise_in ? noise_in : noise_out, costs, argmin,
                                                partials, block_keys, out, sigma_out, elites,
                                                stream);
}

extern "C" {

int fleet_args_size(void) { return (int)sizeof(RSArgs); }

int fleet_layout_size(void) { return (int)sizeof(FleetArgs); }

int fleet_knobs_size(void) { return (int)sizeof(SMKnobs); }

int fleet_block(void) { return RS_BLOCK; }

int fleet_rollout_samples(void) { return ROLLOUT_SAMPLES; }

// The most elites whose CEM keeps per-block key lists; above it the radix select.
int fleet_list_elite(void) { return SM_KMAX; }

int fleet_horizon(void) { return SAMPLING_H; }

int fleet_params_per_leg(void) { return SAMPLING_PL; }

// Floats of a scenario's row of the tick buffer before padding.
int fleet_row_floats(void) { return FLEET_ROW(SAMPLING_H); }

// The layout bits, the large-batch rollout's samples a block and a basis row's
// window (ops/sampling_fleet.py checks its constants against them).
int fleet_layout_wide(void) { return FLEET_WIDE; }

int fleet_layout_regen(void) { return FLEET_REGEN; }

int fleet_wide_samples(void) { return fleet_wide_samples(4 * SAMPLING_PL); }

int fleet_window(void) { return RS_WINDOW; }

int fleet_window_bytes(void) { return (int)sizeof(BasisWindow); }

const char* fleet_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One iteration of `method` (0 random sampling, 1 MPPI, 2 CEM-MPPI; kn->cem set for
// 2 only) for S = f->num_scenarios scenarios of a->num_samples samples each, in
// `layout` (0: the four-lane rollout; the bits FLEET_WIDE, the large-batch
// rollout, and FLEET_REGEN, the update pass drawing the noise again).
// win (H*12): the basis windows (16-byte aligned); scen (S, scen_stride): the tick buffer; seeds, offsets (S): each
// scenario's Philox key and offset, to which f->iteration is added; incumbent
// (S, P) at f->inc_stride; sigma_in (S, P) for CEM; noise_in (S, P, N) in place
// of the drawn noise (then FLEET_REGEN is refused: injected noise can only be
// read); noise_out (S, P, N) or nullptr, where the rollout writes the noise it
// drew (MPPI and CEM without FLEET_REGEN read it back, so they need one of the
// two); costs (S, N); out (S, 26 + P) packed as K1a's; sigma_out (S, P) and
// elites (S, K) for CEM (2 <= K <= N; above SM_KMAX in index order and block_keys
// not read). Scratch: argmin (2 S: each scenario's key and ticket,
// reset here), partials (S, part_stride) and, for CEM, block_keys (S,
// key_stride), with part_stride >= B (P + 1) and key_stride >= B K for B =
// ceil(N / fleet_block()). Returns 0, a CUDA error code, or -1 for a shape, knob,
// layout or alignment this build does not take.
int fleet_launch(const RSArgs* a, const FleetArgs* f, const SMKnobs* kn, int method,
                 int params_per_leg, int layout, const BasisWindow* win,
                 const float* scen, const unsigned long long* seeds,
                 const unsigned long long* offsets, const float* incumbent,
                 const float* sigma_in, const float* noise_in, float* noise_out, float* costs,
                 unsigned long long* argmin, float* partials, unsigned long long* block_keys,
                 float* out, float* sigma_out, int* elites, void* stream) {
  constexpr int P = 4 * SAMPLING_PL;
  if (a->horizon != SAMPLING_H || params_per_leg != SAMPLING_PL || a->num_samples < 1) return -1;
  if (f->num_scenarios < 1 || f->num_scenarios > 65535 ||
      f->scen_stride < FLEET_ROW(SAMPLING_H) || f->inc_stride < P)
    return -1;
  if (win == nullptr || ((uintptr_t)win & 15) != 0) return -1;
  if (method < 0 || method > 2 || (kn->cem != 0) != (method == 2)) return -1;
  if (layout < 0 || layout > (FLEET_WIDE | FLEET_REGEN)) return -1;
  if ((layout & FLEET_REGEN) && noise_in != nullptr) return -1;
  if (method > 0) {
    const int blocks = (a->num_samples + RS_BLOCK - 1) / RS_BLOCK;
    if (!(kn->temperature > 0.f)) return -1;
    if (!(layout & FLEET_REGEN) && noise_in == nullptr && noise_out == nullptr) return -1;
    if (((uintptr_t)partials & 15) != 0 || f->part_stride % 4 != 0 ||
        f->part_stride < blocks * (P + 1))
      return -1;
    if (method == 2 && (kn->n_elite < 2 || kn->n_elite > a->num_samples ||
                        ((uintptr_t)block_keys & 15) != 0 || f->key_stride % 2 != 0 ||
                        (kn->n_elite <= SM_KMAX && f->key_stride < blocks * kn->n_elite)))
      return -1;
  }
  return fleet_launch_t<SAMPLING_H, SAMPLING_PL>(a, f, kn, method, layout, win, scen, seeds,
                                                 offsets, incumbent, sigma_in, noise_in,
                                                 noise_out, costs, argmin, partials, block_keys,
                                                 out, sigma_out, elites, (cudaStream_t)stream);
}

}  // extern "C"
