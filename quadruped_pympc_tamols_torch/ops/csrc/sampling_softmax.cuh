// K1b/K1c's knobs, noise and optimizer step (the update pass, sm_update_kernel),
// shared by sampling_softmax.cu (K1b, K1c), sampling_groups.cu (K1e) and
// sampling_chain.cu (K1d), which runs the pass's tiles and finish in its own loop.
#pragma once

#include "sampling_common.cuh"

#define SM_KMAX 32
// The phases of an iteration sm_launch runs: the memset and the rollout pass, then
// the update pass.
#define SM_PHASE_ROLLOUT 1
#define SM_PHASE_UPDATE 2

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
// (i, k, offset) times s. Sample 0 is the incumbent (zero) unless col0
// (RSArgs::draw_col0).
__device__ __forceinline__ float4 sm_noise4(unsigned long long seed, unsigned long long offset,
                                            int i, int k, float4 s, int col0) {
  if (i == 0 && !col0) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 z = normals4(philox_words(seed, offset, i, k));
  return make_float4(__fmul_rn(z.x, s.x), __fmul_rn(z.y, s.y), __fmul_rn(z.z, s.z),
                     __fmul_rn(z.w, s.w));
}

// K1b/K1c's noise for rollout_kernel: Philox chunk k of sample i at the offset
// times the sigma of parameters p..p+valid-1, sigma (P,) for CEM, nullptr for
// MPPI's sigma_mppi. R: how sigma is read.
template <Read R = Read::ReadOnly>
struct ScaledNormals {
  const float* sigma;
  float sigma_mppi;
  __device__ float4 operator()(const RSArgs& a, unsigned long long offset, int i, int k, int p,
                               int valid) const {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[c] = sigma == nullptr ? sigma_mppi : c < valid ? load_in<R>(&sigma[p + c]) : 0.f;
    return sm_noise4(a.seed, offset, i, k, make_float4(s[0], s[1], s[2], s[3]), a.draw_col0);
  }
};

static inline ScaledNormals<> scaled_normals(const SMKnobs& kn, const float* sigma_in) {
  return ScaledNormals<>{kn.cem ? sigma_in : nullptr, kn.sigma_mppi};
}

// -- the update pass (K1b, K1c, K1e-mppi, K1e-cem) ------------------------------------
//
// One launch after rollout_kernel: grid ceil(N / RS_BLOCK), SM_UPDATE_THREADS
// threads, thread t < RS_BLOCK holding sample blockIdx.x * RS_BLOCK + t. It reads
// the noise the rollout pass used from a (P, N) buffer: the caller's noise_in, or
// the noise the rollout pass wrote there. Every block writes one partial row of
// (sum w * noise, sum w) over its samples and, for CEM, its K lowest keys in rank
// order; the block that takes the last ticket then finishes the iteration.
//
// 1. Weights. w = exp(-(c - beta)/T). The block compacts the samples with w != 0,
//    in thread order (a warp ballot and prefix), and loads their noise, one
//    (sample, chunk of four parameters) pair a thread, sm_batch(P) samples at a
//    time, into a shared row buffer of w * noise; each column is then summed over
//    the compacted rows in thread order (above P = 511, two or three columns a
//    thread). A zero row adds +0, a no-op on a sum that
//    starts at +0, so the partial has the bits of the sum over all RS_BLOCK rows
//    in thread order. On the flagship tick at T = 1 most weights are not 0
//    (tools/pass_times.py counts them), so the noise is read back rather than
//    regenerated from its Philox counters: on an H100, regenerating it made this
//    pass 0.9-2.4 us slower (tools/update_variants.py, variant regenerate), while
//    writing it moved the rollout pass by less than its run-to-run spread.
// 2. The ticket. Each block fences its writes and takes a 64-bit atomic ticket
//    that the iteration's memset set to all ones; the block whose atomicAdd
//    returns B - 2 (unsigned) arrives last and finishes. No block waits for
//    another, so no grid barrier and no cooperative launch.
// 3. The finish, in the last block, as two groups that run at once. Warps 0-3
//    copy the (B, P + 1) partials into shared memory with cp.async (from L2, all
//    in flight together), sum each column over the blocks in block order (columns
//    t, t + 128, ... of thread t: two a thread at P = 144), write incumbent + S / Z,
//    and warp 0 extracts the step-0 GRFs and state on four lanes, one per leg
//    (step0_extract_lanes, with the rollout pass's srb_body<true>). For CEM,
//    warps 4-15 copy the B*K candidate keys into shared memory, find t0, the K-th lowest of the B lists' heads (each list is a block's K
//    lowest keys in rank order), gather the keys at or below it (at most K*K;
//    they hold every elite) and rank them: the K lowest are the elites, in order,
//    after three barriers and no round per elite. Then the group loads the K
//    elites' noise and refits sigma per parameter in elite order.
//
// Every sum keeps the order of the two kernels this pass replaced (per block in
// thread order, then over blocks in block order), so the bits are theirs; no
// float atomics, so a rerun repeats them.
//
// CEM with K > SM_KMAX elites (up to K = N) takes another path from step 1 on: the
// blocks write no key lists, and warps 4-15 of the finish select the elites from
// all N keys (cost_key of the costs) by a radix select of the K-th lowest key,
// then compact the keys at or below it in index order and refit sigma over them
// in batches of sm_elite_batch(P) elites (kth_lowest_key, compact_elites,
// refit_in_batches below). K <= SM_KMAX keeps the path above and its bits; above P
// = 288 its refit too runs in such batches.

#define SM_UPDATE_THREADS 512
// 157 blocks at N = 10 000 resident at once on 132 SMs. At P = 144 a CEM block
// takes ~104 KB of dynamic shared memory and two still fit in an SM's 228 KB;
// sm_update_blocks_per_sm reports what the card grants. The last-block ticket has
// no spin-wait, so one block an SM would be slower, not wrong.
#define SM_UPDATE_MIN_BLOCKS 2
#define SM_COL_THREADS 128      // warps 0-3: the partials' column sums and the extraction
#define SM_CEM_THREADS (SM_UPDATE_THREADS - SM_COL_THREADS)  // warps 4-15: elites and refit
#define SM_RANK_LANES (SM_UPDATE_THREADS / RS_BLOCK)  // threads ranking one key of a block
#define SM_BATCH 32          // nonzero-weight samples whose noise a round loads
// ... and at most this many bytes of their rows: 32 rows up to P = 288, 9 at P = 1024.
#define SM_BATCH_BYTES (SM_BATCH * 289 * 4)
// Bytes of the CEM elites' noise the finish stages at once: all K <= SM_KMAX
// elites up to P = 288 (K = 32), else batches of sm_elite_batch(P) elites (9 at P
// = 1024), summed in elite order as the refit of one batch sums them.
#define SM_ELITE_BYTES (SM_KMAX * 288 * 4)
#define SM_TILE_ROWS 160     // partial rows copied into shared memory at once (a multiple of 4)
// ... and at most this many bytes of them: 160 rows up to P = 144, 80 at P = 288,
// 20 at P = 1024, so that the chain kernel keeps its windows, the tile and the
// CEM stage within a block's 227 KB at every pair.
#define SM_TILE_BYTES (SM_TILE_ROWS * 145 * 4)
#define SM_STAGE_KEYS 4096   // CEM candidate keys staged in shared memory (the rest read from L2)

// Named barrier ID of the THREADS threads that reach it.
template <int ID, int THREADS>
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(THREADS) : "memory");
}

// Nonzero-weight rows of P + 1 floats an update tile loads at once.
__host__ __device__ constexpr int sm_batch(int P) {
  return SM_BATCH_BYTES / ((P + 1) * 4) < SM_BATCH ? SM_BATCH_BYTES / ((P + 1) * 4) : SM_BATCH;
}

// CEM elites whose noise (P floats each) a refit batch stages.
__host__ __device__ constexpr int sm_elite_batch(int P) {
  return SM_ELITE_BYTES / (P * 4) < SM_KMAX ? SM_ELITE_BYTES / (P * 4) : SM_KMAX;
}

// Bytes of the staged noise of n_elite CEM elites: all of them, or one batch.
__host__ __device__ inline int sm_elite_noise_bytes(int P, int n_elite) {
  return n_elite * P * 4 <= SM_ELITE_BYTES ? n_elite * P * 4 : sm_elite_batch(P) * P * 4;
}

// Partial rows of P + 1 floats the finish copies at once: SM_TILE_ROWS, or fewer
// (a multiple of 4) where they would pass SM_TILE_BYTES.
__host__ __device__ constexpr int sm_tile_rows(int P) {
  return SM_TILE_BYTES / ((P + 1) * 4) / 4 * 4 < SM_TILE_ROWS
             ? SM_TILE_BYTES / ((P + 1) * 4) / 4 * 4
             : SM_TILE_ROWS;
}

// Bytes of the finish's partials tile, rounded to 16 so that what follows stays
// aligned for cp.async.
__host__ __device__ inline int sm_tile_bytes(int P, int num_blocks) {
  const int rows = num_blocks < sm_tile_rows(P) ? num_blocks : sm_tile_rows(P);
  return (rows * (P + 1) * 4 + 15) / 16 * 16;
}

// Dynamic shared memory of the update pass: the batch's row buffer; in the last
// block the same bytes hold the partials tile and, after it (CEM), the staged
// candidate keys and the elites' candidates, then the elites' noise in their
// place.
static inline int sm_update_smem(int P, int cem, int n_elite, int num_blocks) {
  const int batch = sm_batch(P) * (P + 1) * 4;
  int finish = sm_tile_bytes(P, num_blocks);
  if (cem && n_elite > SM_KMAX) {
    finish += sm_elite_batch(P) * P * 4;  // a batch of the elites' noise (refit_in_batches)
  } else if (cem) {
    const int m = num_blocks * n_elite;
    const int keys = ((m < SM_STAGE_KEYS ? m : SM_STAGE_KEYS) + n_elite * n_elite) * 8;
    const int noise = sm_elite_noise_bytes(P, n_elite);
    finish += keys > noise ? keys : noise;
  }
  return batch > finish ? batch : finish;
}

// The incumbent of the new parameters that thread t < SM_COL_THREADS finishes
// (t, t + 128, ...), loaded off the finish's chain.
template <int PL, Read R>
__device__ __forceinline__ void finish_incumbent(const float* incumbent, float* inc_r) {
  constexpr int P = 4 * PL;
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < (P + SM_COL_THREADS - 1) / SM_COL_THREADS; ++u) {
    const int p = t + u * SM_COL_THREADS;
    inc_r[u] = t < SM_COL_THREADS && p < P ? load_in<R>(&incumbent[p]) : 0.f;
  }
}

// Part 1 of the update pass for tile b, samples [b * RS_BLOCK, (b + 1) * RS_BLOCK),
// by the block's SM_UPDATE_THREADS threads: partial row b of (w * noise, w) and,
// for CEM, row b of the block keys. noise: the (P, N) noise of the iteration;
// beta the lowest cost. partials (B, P + 1), 16-byte aligned, and block_keys
// (B, K) are written here and read by the finish in the same launch, so they
// are neither const nor __restrict__ (no read-only cache path), and the finish
// reads them from L2 (cp.async.cg, __ldcg). R: how the costs and the noise are
// read.
template <int PL, Read R>
__device__ __forceinline__ void update_tile(const RSArgs& a, const SMKnobs& kn,
                                            const float* noise, const float* costs, float beta,
                                            int b, float* partials,
                                            unsigned long long* block_keys,
                                            unsigned char* arena) {
  constexpr int P = 4 * PL;
  constexpr int CH = P / 4;  // chunks of four rows of the (P, N) noise
  constexpr int ROW = P + 1;
  constexpr int BATCH = sm_batch(P);
  constexpr int UCOLS = (ROW + SM_UPDATE_THREADS - 1) / SM_UPDATE_THREADS;  // columns a thread
  static_assert(RS_BLOCK % 32 == 0 && SM_RANK_LANES * RS_BLOCK == SM_UPDATE_THREADS &&
                    (SM_RANK_LANES & (SM_RANK_LANES - 1)) == 0,
                "whole warps of samples; a power-of-two group of threads ranks each key");
  static_assert(BATCH >= 1 && BATCH <= SM_UPDATE_THREADS, "a weight a thread");
  __shared__ int nz_s[RS_BLOCK];
  __shared__ float nzw_s[RS_BLOCK];
  __shared__ unsigned long long key_s[RS_BLOCK];
  __shared__ int count_s[RS_BLOCK / 32];
  const int N = a.num_samples;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. Weights and keys; the nonzero weights compacted in thread order.
  const int i0 = b * RS_BLOCK;
  float w = 0.f;
  unsigned long long key = ~0ull;
  if (t < RS_BLOCK && i0 + t < N) {
    const float c = load_in<R>(&costs[i0 + t]);
    w = expf(-(c - beta) / kn.temperature);
    key = cost_key(c, i0 + t);
  }
  unsigned int nz = 0u;
  if (t < RS_BLOCK) {
    nz = __ballot_sync(0xffffffffu, w != 0.f);
    if (lane == 0) count_s[warp] = __popc(nz);
    key_s[t] = key;
  }
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int u = 0; u < RS_BLOCK / 32; ++u) m += count_s[u];
  if (w != 0.f) {
    int pos = __popc(nz & ((1u << lane) - 1u));
    for (int u = 0; u < warp; ++u) pos += count_s[u];
    nz_s[pos] = t;
    nzw_s[pos] = w;
  }
  __syncthreads();

  // This block's partial row: the nonzero rows' (w * noise, w), BATCH at a time;
  // columns t, t + SM_UPDATE_THREADS, ... of thread t, each summed over the rows in
  // order.
  float* buf_s = reinterpret_cast<float*>(arena);  // (BATCH, ROW); ROW odd: no bank conflicts
  float acc[UCOLS];
#pragma unroll
  for (int u = 0; u < UCOLS; ++u) acc[u] = 0.f;
  for (int base = 0; base < m; base += BATCH) {
    const int nb = m - base < BATCH ? m - base : BATCH;
    for (int j = t; j < nb * CH; j += SM_UPDATE_THREADS) {
      const int r = j % nb, k = j / nb;
      const float wr = nzw_s[base + r];
      const float4 z = load_noise4<R>(noise, N, i0 + nz_s[base + r], k);
      float* row = &buf_s[r * ROW + 4 * k];
      row[0] = __fmul_rn(wr, z.x);
      row[1] = __fmul_rn(wr, z.y);
      row[2] = __fmul_rn(wr, z.z);
      row[3] = __fmul_rn(wr, z.w);
    }
    if (t < nb) buf_s[t * ROW + P] = nzw_s[base + t];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < UCOLS; ++u) {
      const int col = t + u * SM_UPDATE_THREADS;
      if (col < ROW) {
#pragma unroll 8
        for (int r = 0; r < nb; ++r) acc[u] = __fadd_rn(acc[u], buf_s[r * ROW + col]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < UCOLS; ++u)
    if (t + u * SM_UPDATE_THREADS < ROW) partials[(size_t)b * ROW + t + u * SM_UPDATE_THREADS] = acc[u];
  if (kn.cem && kn.n_elite <= SM_KMAX) {
    // Rank of each key in the block, SM_RANK_LANES threads a key; equal keys (only
    // the ~0ull of missing samples) rank by thread. The K lowest land in rank order.
    constexpr int SPAN = RS_BLOCK / SM_RANK_LANES;
    const int kt = t / SM_RANK_LANES, part = t % SM_RANK_LANES;
    const unsigned long long kk = key_s[kt];
    int rank = 0;
#pragma unroll
    for (int u = part * SPAN; u < (part + 1) * SPAN; ++u) {
      const unsigned long long ku = key_s[u];
      rank += (ku < kk || (ku == kk && u < kt)) ? 1 : 0;
    }
#pragma unroll
    for (int off = 1; off < SM_RANK_LANES; off <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (part == 0 && rank < kn.n_elite) block_keys[(size_t)b * kn.n_elite + rank] = kk;
  }
}

// Part 2, the ticket: each tile fences its writes and takes a 64-bit atomic ticket
// that starts at all ones; the tile whose atomicAdd returns tiles - 2 (unsigned)
// arrives last, and its block finishes. No block waits for another.
__device__ __forceinline__ bool last_ticket(unsigned long long* ticket, int tiles) {
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(ticket, 1ull) == (unsigned long long)(long long)(tiles - 2);
  __syncthreads();
  return last_s;
}

// -- CEM with more than SM_KMAX elites: the finish's selection and refit ---------------
//
// By the SM_CEM_THREADS threads of warps 4-15 (ct = threadIdx.x - SM_COL_THREADS),
// which alone pass group barrier 1. Keys are unique, so the K lowest are exactly the
// keys at or below the K-th: jax.lax.top_k's set, with its lowest index first on
// equal costs.

#define SM_RADIX_BINS 256  // 8 bits of the key a round of the radix select

template <Read R>
__device__ __forceinline__ unsigned long long sample_key(const float* costs, int i) {
  return cost_key(load_in<R>(&costs[i]), i);
}

// The K-th lowest (1 <= K <= N) of the keys of samples 0..N-1, by an MSD radix
// select: eight rounds from the top byte down, each a shared histogram of that
// byte over the keys whose higher bytes equal the K-th key's found so far (one
// atomic a warp and bin, __match_any_sync), and one warp's prefix sum to find the
// bin that holds it.
template <Read R>
__device__ unsigned long long kth_lowest_key(const float* costs, int N, int K, int ct) {
  __shared__ unsigned int hist_s[SM_RADIX_BINS];
  __shared__ unsigned long long prefix_s;
  __shared__ int need_s;
  constexpr int PER_LANE = SM_RADIX_BINS / 32;
  const int lane = ct & 31;
  unsigned long long prefix = 0ull, mask = 0ull;
  int need = K;  // the rank sought among the keys under the prefix, from 1
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int q = ct; q < SM_RADIX_BINS; q += SM_CEM_THREADS) hist_s[q] = 0u;
    group_sync<1, SM_CEM_THREADS>();
    for (int base = 0; base < N; base += SM_CEM_THREADS) {  // uniform: whole warps
      const int i = base + ct;
      int bin = SM_RADIX_BINS;  // none
      if (i < N) {
        const unsigned long long k = sample_key<R>(costs, i);
        if ((k & mask) == prefix) bin = (int)((k >> shift) & 0xFFull);
      }
      const unsigned int peers = __match_any_sync(0xffffffffu, bin);
      if (bin < SM_RADIX_BINS && lane == __ffs(peers) - 1)
        atomicAdd(&hist_s[bin], (unsigned int)__popc(peers));
    }
    group_sync<1, SM_CEM_THREADS>();
    if (ct < 32) {
      unsigned int c[PER_LANE], local = 0u;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        c[u] = hist_s[ct * PER_LANE + u];
        local += c[u];
      }
      unsigned int incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const unsigned int excl = incl - local, want = (unsigned int)need;
      if (excl < want && want <= incl) {  // one lane
        unsigned int below = excl;  // keys under the prefix in the bins before d
        int d = PER_LANE - 1;
        for (int u = 0; u < PER_LANE; ++u) {
          if (below + c[u] >= want) {
            d = u;
            break;
          }
          below += c[u];
        }
        prefix_s = prefix | ((unsigned long long)(ct * PER_LANE + d) << shift);
        need_s = need - (int)below;
      }
    }
    group_sync<1, SM_CEM_THREADS>();
    prefix = prefix_s;
    need = need_s;
    mask |= 0xFFull << shift;
  }
  return prefix;
}

// The samples whose keys are at or below tk, in index order, into elites.
template <Read R>
__device__ void compact_elites(const float* costs, int N, unsigned long long tk, int* elites,
                               int ct) {
  constexpr int WARPS = SM_CEM_THREADS / 32;
  __shared__ int count_s[2][WARPS];  // two rounds' counts: one barrier a round
  const int lane = ct & 31, warp = ct >> 5;
  int total = 0;
  for (int base = 0, r = 0; base < N; base += SM_CEM_THREADS, r ^= 1) {
    const int i = base + ct;
    const bool sel = i < N && sample_key<R>(costs, i) <= tk;
    const unsigned int bal = __ballot_sync(0xffffffffu, sel);
    if (lane == 0) count_s[r][warp] = __popc(bal);
    group_sync<1, SM_CEM_THREADS>();
    int pos = total + __popc(bal & ((1u << lane) - 1u)), sum = 0;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      const int c = count_s[r][u];
      pos += u < warp ? c : 0;
      sum += c;
    }
    if (sel) elites[pos] = i;
    total += sum;
  }
}

// Sigma refit over the K elites, elites[0..K) (written before a group barrier), in
// batches of EB = sm_elite_batch(P): fill(i, c, row) writes chunk c < CHUNKS of
// sample i's noise into row (P floats) of x_s (EB, P); thread ct sums parameters
// ct, ct + SM_CEM_THREADS, ... over the elites in their order, the mean and then
// the squared deviations (ddof 1, + 1e-8, sqrt, clipped), as the refit of all the
// elites at once.
template <int P, int CHUNKS, class Fill>
__device__ void refit_in_batches(const SMKnobs& kn, const int* elites, int K, const Fill& fill,
                                 float* x_s, float* sigma_out, int ct) {
  constexpr int PC = (P + SM_CEM_THREADS - 1) / SM_CEM_THREADS;
  constexpr int EB = sm_elite_batch(P);
  float mean[PC], ss[PC];
#pragma unroll
  for (int u = 0; u < PC; ++u) mean[u] = ss[u] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int e0 = 0; e0 < K; e0 += EB) {
      const int ne = K - e0 < EB ? K - e0 : EB;
      for (int j = ct; j < ne * CHUNKS; j += SM_CEM_THREADS) {
        const int e = j % ne;
        fill(elites[e0 + e], j / ne, &x_s[e * P]);
      }
      group_sync<1, SM_CEM_THREADS>();
#pragma unroll
      for (int u = 0; u < PC; ++u) {
        const int p = ct + u * SM_CEM_THREADS;
        if (p < P) {
          for (int e = 0; e < ne; ++e) {
            const float x = x_s[e * P + p];
            if (pass == 0) {
              mean[u] += x;
            } else {
              const float d = x - mean[u];
              ss[u] += d * d;
            }
          }
        }
      }
      group_sync<1, SM_CEM_THREADS>();
    }
    if (pass == 0) {
#pragma unroll
      for (int u = 0; u < PC; ++u) mean[u] = mean[u] / (float)K;
    }
  }
#pragma unroll
  for (int u = 0; u < PC; ++u) {
    const int p = ct + u * SM_CEM_THREADS;
    if (p < P) {
      const float var = ss[u] / (float)(K - 1) + 1e-8f;
      sigma_out[p] = clip_nan(sqrtf(var), kn.sigma_min, kn.sigma_max);
    }
  }
}

// Part 3, the finish, in the block whose tile took the last ticket, after a fence:
// warps 0-3 sum the B partial rows' columns in block order, write out's new
// parameters (inc_r + S / Z, inc_r from finish_incumbent) and, on warp 0, the
// step-0 extraction, beta and its index from best_key; for CEM, warps 4-15 select
// the elites from the B*K block keys (above SM_KMAX elites: from the N costs) and
// refit sigma. sums_out (P + 1), if not nullptr, receives the unnormalized sums
// [S (P), Z] as well, for a caller that merges them with other shards' (a
// sample-sharded solve). R: how the noise and the costs are read.
template <int PL, Read R>
__device__ __forceinline__ void update_finish(const RSArgs& a, const SMKnobs& kn,
                                              const BasisWindow* win, const float* inc_r,
                                              const float* noise, const float* costs,
                                              unsigned long long best_key, int B,
                                              float* partials, unsigned long long* block_keys,
                                              float* out, float* sigma_out, int* elites,
                                              unsigned char* arena, float* sums_out = nullptr) {
  constexpr int P = 4 * PL;
  constexpr int CH = P / 4;
  constexpr int ROW = P + 1;
  constexpr int COLS = (ROW + SM_COL_THREADS - 1) / SM_COL_THREADS;  // finish columns a thread
  constexpr int PCOLS = (P + SM_COL_THREADS - 1) / SM_COL_THREADS;   // new parameters a thread
  constexpr int TILE = sm_tile_rows(P);
  static_assert(TILE % 4 == 0 && TILE > 0, "aligned tiles");
  __shared__ float sum_s[ROW];
  __shared__ float prm_s[P];
  __shared__ BasisWindow w0_s[12];
  __shared__ int elite_s[SM_KMAX];
  __shared__ unsigned long long t0_s;
  __shared__ int ncand_s;
  const int N = a.num_samples;
  const int t = threadIdx.x, warp = t >> 5;
  const float beta = __uint_as_float((unsigned int)(best_key >> 32));
  float* tile_s = reinterpret_cast<float*>(arena);
  if (t < SM_COL_THREADS) {
    float s[COLS];
#pragma unroll
    for (int u = 0; u < COLS; ++u) s[u] = 0.f;
    for (int b0 = 0; b0 < B; b0 += TILE) {
      const int rows = B - b0 < TILE ? B - b0 : TILE;
      const float* src = partials + (size_t)b0 * ROW;  // 16-byte aligned: b0 % 4 == 0
      const int n = rows * ROW;
      for (int q = t; q < n / 4; q += SM_COL_THREADS) cp_async16(&tile_s[4 * q], &src[4 * q]);
      for (int q = (n / 4) * 4 + t; q < n; q += SM_COL_THREADS) tile_s[q] = __ldcg(&src[q]);
      if (b0 == 0) cp_async_step0_windows(w0_s, win, t, SM_COL_THREADS);
      cp_async_wait_all();
      group_sync<3, SM_COL_THREADS>();
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int col = t + u * SM_COL_THREADS;
        if (col < ROW) {
#pragma unroll 8
          for (int r = 0; r < rows; ++r) s[u] = __fadd_rn(s[u], tile_s[r * ROW + col]);
        }
      }
      group_sync<3, SM_COL_THREADS>();
    }
#pragma unroll
    for (int u = 0; u < COLS; ++u)
      if (t + u * SM_COL_THREADS < ROW) sum_s[t + u * SM_COL_THREADS] = s[u];
    if (sums_out != nullptr) {
#pragma unroll
      for (int u = 0; u < COLS; ++u)
        if (t + u * SM_COL_THREADS < ROW) sums_out[t + u * SM_COL_THREADS] = s[u];
    }
    group_sync<3, SM_COL_THREADS>();
#pragma unroll
    for (int u = 0; u < PCOLS; ++u) {
      const int p = t + u * SM_COL_THREADS;
      if (p < P) {
        const float v = inc_r[u] + sum_s[p] / sum_s[P];
        prm_s[p] = v;
        out[RS_OUT_WINNER + p] = v;
      }
    }
    group_sync<3, SM_COL_THREADS>();
    if (warp == 0) {
      step0_extract_lanes(a, w0_s, prm_s, out);
      if (t == 0) {
        out[0] = beta;
        out[25] = (float)(int)(best_key & 0xffffffffull);
      }
    }
    return;
  }
  if (!kn.cem) return;

  // CEM, warps 4-15 meanwhile: the K lowest of the B*K candidates, in order, then
  // the refit.
  const int ct = t - SM_COL_THREADS;
  const int K = kn.n_elite;
  const int mk = B * K;
  unsigned long long* stage_s =
      reinterpret_cast<unsigned long long*>(arena + sm_tile_bytes(P, B));
  if (K > SM_KMAX) {
    const int n = a.num_samples;
    compact_elites<R>(costs, n, kth_lowest_key<R>(costs, n, K, ct), elites, ct);
    group_sync<1, SM_CEM_THREADS>();
    refit_in_batches<P, CH>(
        kn, elites, K,
        [&](int i, int c, float* row) {
          const float4 z = load_noise4<R>(noise, n, i, c);
          row[4 * c + 0] = z.x;
          row[4 * c + 1] = z.y;
          row[4 * c + 2] = z.z;
          row[4 * c + 3] = z.w;
        },
        reinterpret_cast<float*>(stage_s), sigma_out, ct);
    return;
  }
  const int staged = mk < SM_STAGE_KEYS ? mk : SM_STAGE_KEYS;
  for (int q = ct; q < staged / 2; q += SM_CEM_THREADS)
    cp_async16(&stage_s[2 * q], &block_keys[2 * q]);  // block_keys is 16-byte aligned
  if ((staged & 1) && ct == 0) stage_s[staged - 1] = __ldcg(&block_keys[staged - 1]);
  if (ct == 0) ncand_s = 0;
  cp_async_wait_all();
  group_sync<1, SM_CEM_THREADS>();
  // Each block's list holds its K lowest keys in order, so the K lists whose heads
  // are the K lowest heads hold every elite: the elites are the K lowest keys at
  // or below t0, the K-th lowest head (all keys when there are fewer lists than K),
  // and there are at most K*K such candidates. Keys are unique, so each
  // candidate's rank among them is its place.
  unsigned long long* cand_s = stage_s + staged;  // (K*K)
  if (K > B) {
    if (ct == 0) t0_s = ~0ull - 1ull;  // every real key; not the missing samples' ~0ull
  } else {
    // Each head's rank among the heads, counted by G threads (a power of two that
    // keeps G*B within the group), summed by shuffles; the staged heads first, in
    // a loop without branches so that their loads overlap.
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
    refit_in_batches<P, CH>(
        kn, elite_s, K,
        [&](int i, int c, float* row) {
          const float4 z = load_noise4<R>(noise, N, i, c);
          row[4 * c + 0] = z.x;
          row[4 * c + 1] = z.y;
          row[4 * c + 2] = z.z;
          row[4 * c + 3] = z.w;
        },
        x_s, sigma_out, ct);
    if (ct < K) elites[ct] = elite_s[ct];
    return;
  }
  // The elites' noise, one chunk of four parameters a thread.
  for (int j = ct; j < K * CH; j += SM_CEM_THREADS) {
    const int e = j % K, k = j / K;
    const float4 z = load_noise4<R>(noise, N, elite_s[e], k);
    float* xe = &x_s[e * P + 4 * k];
    xe[0] = z.x;
    xe[1] = z.y;
    xe[2] = z.z;
    xe[3] = z.w;
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

// The update pass as one launch (K1b, K1c, K1e-mppi, K1e-cem): block b runs tile
// b; argmin: the iteration's argmin key; ticket: its second scratch word, set to
// all ones by the iteration's memset. beta_in, if not nullptr, is the weights'
// beta in place of the lowest cost of the argmin key (a sample-sharded solve
// passes the lowest over every shard); sums_out as update_finish's.
template <int PL>
__global__ void __launch_bounds__(SM_UPDATE_THREADS, SM_UPDATE_MIN_BLOCKS)
sm_update_kernel(const RSArgs a, const SMKnobs kn, const BasisWindow* __restrict__ win,
                 const float* __restrict__ incumbent, const float* __restrict__ noise,
                 const float* __restrict__ costs, const unsigned long long* __restrict__ argmin,
                 unsigned long long* ticket, float* partials, unsigned long long* block_keys,
                 float* __restrict__ out, float* __restrict__ sigma_out,
                 int* __restrict__ elites, const float* __restrict__ beta_in,
                 float* __restrict__ sums_out) {
  extern __shared__ __align__(16) unsigned char arena[];
  float inc_r[(4 * PL + SM_COL_THREADS - 1) / SM_COL_THREADS];
  finish_incumbent<PL, Read::ReadOnly>(incumbent, inc_r);
  const unsigned long long best_key = *argmin;
  const float beta =
      beta_in != nullptr ? __ldg(beta_in) : __uint_as_float((unsigned int)(best_key >> 32));
  update_tile<PL, Read::ReadOnly>(a, kn, noise, costs, beta, blockIdx.x, partials, block_keys,
                                  arena);
  if (!last_ticket(ticket, gridDim.x)) return;
  __threadfence();
  update_finish<PL, Read::ReadOnly>(a, kn, win, inc_r, noise, costs, best_key, gridDim.x,
                                    partials, block_keys, out, sigma_out, elites, arena,
                                    sums_out);
}

// Above 48 KB dynamic shared memory needs an opt-in, given once for the most the
// update pass can ask for (a full tile, then the CEM stage).
template <int PL>
static cudaError_t update_opt_in() {
  static bool opted_in = false;
  if (opted_in) return cudaSuccess;
  const int most =
      sm_tile_bytes(4 * PL, SM_TILE_ROWS) + (SM_STAGE_KEYS + SM_KMAX * SM_KMAX) * 8;
  cudaError_t err = cudaFuncSetAttribute(sm_update_kernel<PL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sm_update_kernel<PL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  opted_in = err == cudaSuccess;
  return err;
}

// Blocks of the update pass an SM holds at once for this launch's shared memory,
// or minus a CUDA error code.
template <int PL>
static int update_blocks_per_sm(int cem, int n_elite, int num_samples) {
  cudaError_t err = update_opt_in<PL>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sm_update_kernel<PL>, SM_UPDATE_THREADS,
        sm_update_smem(4 * PL, cem, n_elite, (num_samples + RS_BLOCK - 1) / RS_BLOCK));
  return err == cudaSuccess ? blocks : -(int)err;
}

// The update pass's launch, for K1b/K1c and K1e. argmin points at two words, the
// argmin key and the ticket, both reset by the iteration's memset; noise is the
// (P, N) noise the rollout pass read or wrote; beta_in and sums_out as
// sm_update_kernel's (nullptr: the iteration's own beta, no sums).
template <int PL>
static cudaError_t launch_update(const RSArgs& a, const SMKnobs& kn, const BasisWindow* win,
                                 const float* incumbent, const float* noise, const float* costs,
                                 unsigned long long* argmin, float* partials,
                                 unsigned long long* block_keys, float* out, float* sigma_out,
                                 int* elites, cudaStream_t stream,
                                 const float* beta_in = nullptr, float* sums_out = nullptr) {
  cudaError_t err = update_opt_in<PL>();
  if (err != cudaSuccess) return err;
  const int blocks = (a.num_samples + RS_BLOCK - 1) / RS_BLOCK;
  const int smem = sm_update_smem(4 * PL, kn.cem, kn.n_elite, blocks);
  sm_update_kernel<PL><<<blocks, SM_UPDATE_THREADS, smem, stream>>>(
      a, kn, win, incumbent, noise, costs, argmin, argmin + 1, partials, block_keys, out,
      sigma_out, elites, beta_in, sums_out);
  return cudaGetLastError();
}
