// Per-row q-quantile of |x| for dynamic thresholding, one launch per call (sm_90a).
//
// Two functions share this kernel; each reads a (B, N) float32, bfloat16 or
// float16 tensor and writes (B,) float32.  Let hi = max(max|x|, 1e-12) per row
// and target = float32(q * N).
//
//   Mode A, `histogram_quantile` (ops/quantile.py): the Pallas TPU kernel
//   `histogram_quantile_pallas` (clip_diffusion_tpu/ops/quantile.py:79,
//   pl.pallas_call at :115), which this file replaces.  A `bins`-bin
//   histogram of int(|x| / hi * bins) clipped to [0, bins-1], its cumulative
//   sum, the first bin whose count reaches target (bin 0 when none, as argmax
//   of all-false) and (bin + frac) / bins * hi inside it.
//
//   Mode B, `histogram_abs_quantile`: the JAX main path's threshold
//   (clip_diffusion_tpu/ops/quantile.py:29, an XLA computation with no Pallas
//   kernel), two-level edge counting with lvl = ceil(sqrt(bins)) edges:
//   coarse counts of |x| <= hi * (k / lvl), the coarse bin c_idx with its
//   lower edge lo and the count below it, fine counts of
//   |x| <= lo + (hi / lvl) * (k / lvl), and the interpolation in the fine bin.
//
// Every float32 expression is the plain PyTorch version's, in its order, with
// IEEE division and no FMA contraction (__fdiv_rn/__fmul_rn/__fadd_rn, built
// with -fmad=false): mode A equals histogram_quantile_plain and mode B
// histogram_abs_quantile_plain bit for bit.  Counts are integers, so the
// result does not depend on the order in which blocks run.  A count
// enters a float32 comparison exactly below 2^24 elements per row.
//
// Bound on the card: bytes.  The function must read x once and write one
// float per row, 4*B*N + 4*B bytes in float32: 3.1 MB for the main path's
// (1, 786432) row, 0.94 us at 3.35 TB/s.  At that size a launch and a grid
// barrier each cost about a microsecond, so the design spends them sparingly:
//
//   * One cooperative launch of as many blocks as can be resident
//     (occupancy x SMs), so that cooperative_groups grid barriers are legal.
//     The rows of a round are split over the blocks; each block owns a
//     contiguous segment of one row.  More rows than blocks run in rounds.
//   * Each block copies its segment into shared memory once, with a TMA bulk
//     copy (cp.async.bulk ... mbarrier::complete_tx) for the 16-byte-aligned
//     body and plain loads for the ragged head and tail.  Every later pass
//     reads shared memory.  A segment larger than the stage is walked in
//     tiles, and each later pass copies its tiles again (from L2 or device
//     memory): the same code and the same results.
//   * max|x|: a warp-shuffle and shared-memory reduction per block, then an
//     atomicMax on the bit pattern of the non-negative float into the row's
//     workspace slot, then a grid barrier.
//   * Counts in shared memory: mode A in privatized sub-histograms, one per
//     group of warps; mode B in one sub-histogram per warp, with the edges in
//     shared memory.  Mode B places each element at the first edge it does
//     not exceed, starting from a guess from the edges' spacing and walking
//     to the exact edge, so every count equals the broadcast comparison's;
//     in the fine pass the elements below the first edge (most of them) are
//     counted in a register.  Each block adds its non-zero counts with
//     integer atomics to one of kReplicas copies of the row's counts, which
//     spreads the blocks' atomics over more cache lines.  Mode B has a grid
//     barrier between the coarse and the fine pass; after it every block
//     derives c_idx, lo and the count below lo from the global coarse counts.
//   * The block of a row that finishes last (a release fence and an atomic
//     ticket) sums the copies, scans the counts (warp-shuffle block scan),
//     writes out[row] and resets the row's workspace (counts, max, ticket)
//     to zero, so the next call finds it zeroed and the wrapper launches
//     nothing else.
//
// At the main row the work per block is small (about 3,000 elements), so
// the time goes to the fixed steps: the launch, the staging copy, one grid
// barrier per pass and the L2 round trips after each (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 12288;       // mode A totals fit 48 KB of shared memory
constexpr int kMaxLvl = 111;          // ceil(sqrt(kMaxBins))
constexpr int kSmemBudget = 104 * 1024;  // stage + counts: two blocks per SM
constexpr int kSubHistBytes = 32 * 1024;  // mode A sub-histograms when they fit
constexpr int kMinSegment = 2048;     // fewest elements worth a block of its own
constexpr int kSlotHeader = 4;        // [max bits, ticket, unused, unused]
constexpr int kReplicas = 4;          // copies of a row's global counts, to spread atomics
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr int kMaxDevices = 64;
constexpr int kTraceSlots = 11;

#ifdef HISTOGRAM_QUANTILE_TRACE
// Phase timestamps (%globaltimer, ns) for `tools/time_quantile.py --trace`:
// slot 0 is the first block's start, every other slot the last block to pass
// that point.  Built only with -DHISTOGRAM_QUANTILE_TRACE.
__device__ unsigned long long g_trace[kTraceSlots];
__device__ __forceinline__ void trace(int k) {
  if (threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (k == 0) atomicMin(&g_trace[0], t); else atomicMax(&g_trace[k], t);
}
#else
__device__ __forceinline__ void trace(int) {}
#endif

struct Params {
  const void* x;
  float* out;
  int* ws;            // rows_per_round slots of `stride` ints, zero between calls
  long long n;        // row length
  long long seg;      // elements per block segment (a multiple of 16)
  int rows;
  int bins;
  int lvl;            // mode B edges; 0 in mode A
  int nsub;           // sub-histograms in shared memory
  int bpr;            // blocks per row
  int rows_per_round;
  int nc;             // counts per replica: bins (mode A) or 2 * lvl (mode B)
  int replicas;       // count replicas per slot: min(kReplicas, bpr)
  int stride;         // ints per workspace slot: kSlotHeader + replicas * nc
  int stage_bytes;
  float target;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  }
}

// Copy x[ts, te) of one row into `stage`, element ts at stage[head] where
// head = (address of x[ts] mod 16) / sizeof(T); returns head.  Thread 0 issues
// the bulk copy of the aligned body; all threads load the head and tail and
// wait for the barrier.  `phase` flips once per call.
template <typename T>
__device__ int stage_tile(const T* __restrict__ xr, long long ts, long long te, T* stage,
                          uint64_t* bar, uint32_t& phase) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(xr + ts);
  const uintptr_t e = reinterpret_cast<uintptr_t>(xr + te);
  const uintptr_t base = a & ~uintptr_t(15);
  const int head = static_cast<int>((a - base) / sizeof(T));
  uintptr_t b0 = (a + 15) & ~uintptr_t(15);
  uintptr_t b1 = e & ~uintptr_t(15);
  if (b1 <= b0) b0 = b1 = e;  // too short for a bulk copy: plain loads only
  const uint32_t bytes = static_cast<uint32_t>(b1 - b0);
  if (threadIdx.x == 0 && bytes > 0) {
    const uint32_t b = smem_addr(bar);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(reinterpret_cast<unsigned char*>(stage) + (b0 - base))),
           "l"(reinterpret_cast<const void*>(b0)), "r"(bytes), "r"(b)
        : "memory");
  }
  const long long body0 = ts + static_cast<long long>((b0 - a) / sizeof(T));
  const long long body1 = ts + static_cast<long long>((b1 - a) / sizeof(T));
  for (long long i = ts + threadIdx.x; i < body0; i += blockDim.x) stage[head + (i - ts)] = xr[i];
  for (long long i = body1 + threadIdx.x; i < te; i += blockDim.x) stage[head + (i - ts)] = xr[i];
  if (bytes > 0) {
    mbar_wait(smem_addr(bar), phase);
    phase ^= 1u;
  }
  __syncthreads();
  return head;
}

// Runs `fn(|x_i|)` for every element of this block's segment [s, e) of row
// `xr`, from the stage.  When the segment fits the stage and `resident` is
// set, the copy made by an earlier pass is reused.
template <typename T, typename Fn>
__device__ void for_each_abs(const T* __restrict__ xr, long long s, long long e, T* stage,
                             long long tile, uint64_t* bar, uint32_t& phase, bool& resident,
                             int& head, Fn fn) {
  for (long long ts = s; ts < e; ts += tile) {
    const long long te = ts + tile < e ? ts + tile : e;
    if (!resident) {
      __syncthreads();  // the previous tile's readers are done with the stage
      head = stage_tile(xr, ts, te, stage, bar, phase);
    }
    const int len = static_cast<int>(te - ts);
    for (int j = threadIdx.x; j < len; j += blockDim.x) fn(fabsf(to_float(stage[head + j])));
    if (e - s <= tile) resident = true;
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// In place: sh[0..nb) becomes its inclusive cumulative sum.  Each thread owns
// consecutive entries; a warp-shuffle block scan of the per-thread totals.
__device__ void block_cumsum(int* sh, int nb, int* sh_warp) {
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nb ? lo + per : nb;
  int local = 0;
  for (int b = lo; b < hi; ++b) local += sh[b];
  const int incl = warp_inclusive_scan(local);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 31) sh_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sh_warp[lane] : 0;
    const int wincl = warp_inclusive_scan(w);
    if (lane < kWarps) sh_warp[lane] = wincl - w;  // exclusive
  }
  __syncthreads();
  int run = sh_warp[warp] + incl - local;
  for (int b = lo; b < hi; ++b) {
    run += sh[b];
    sh[b] = run;
  }
  __syncthreads();
}

// The first index of the cumulative sum sh[0..nb) whose float32 value reaches
// `target`, 0 when none (argmax of all-false).  Block-wide.
__device__ int first_reaching(const int* sh, int nb, float target, int* sh_first) {
  if (threadIdx.x == 0) *sh_first = nb;
  __syncthreads();
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < nb ? lo + per : nb;
  for (int b = lo; b < hi; ++b) {
    if (static_cast<float>(sh[b]) >= target) {
      atomicMin(sh_first, b);
      break;
    }
  }
  __syncthreads();
  const int f = *sh_first;
  __syncthreads();
  return f < nb ? f : 0;
}

__device__ float block_max(float v, float* sh_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) sh_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh_red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;  // valid in thread 0
}

// Smallest k in [0, lvl) with a <= edges[k], for a <= edges[lvl - 1].  The
// edges do not decrease, so the count of a <= edges[k] is the sum of the
// placements up to k.  `guess` is any start in [0, lvl); the walk from it
// makes the result exact, and a guess from the edges' spacing is off by at
// most one.
__device__ __forceinline__ int place(const float* edges, int lvl, float a, int guess) {
  int k = guess < 0 ? 0 : (guess > lvl - 1 ? lvl - 1 : guess);
  while (a > edges[k]) ++k;
  while (k > 0 && a <= edges[k - 1]) --k;
  return k;
}

// Sums the block's sub-histograms sh[nsub][nb] and adds the non-zero counts
// to `g` with integer atomics.
__device__ void merge_counts(const int* sh, int nsub, int nb, int* g) {
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int c = 0;
    for (int s = 0; s < nsub; ++s) c += sh[s * nb + b];
    if (c) atomicAdd(&g[b], c);
  }
  __syncthreads();
}

// Entry k of a row's global counts, summed over the replicas (the loads are
// issued together: one L2 round trip, not one per replica).
__device__ __forceinline__ int total(const int* counts, int k, const Params& p) {
  int v[kReplicas];
#pragma unroll
  for (int r = 0; r < kReplicas; ++r) v[r] = r < p.replicas ? __ldcg(&counts[r * p.nc + k]) : 0;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kReplicas; ++r) c += v[r];
  return c;
}

// The last block of a row to arrive returns true (block-uniform).  The
// barrier orders the block's count atomics before thread 0's release fence;
// the acquire fence after the ticket makes every block's counts visible.
__device__ bool last_of_row(int* ticket, int bpr, int* sh_flag) {
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    const int t = atomicAdd(ticket, 1);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    *sh_flag = (t == bpr - 1);
  }
  __syncthreads();
  return *sh_flag != 0;
}

template <typename T, bool kTwoLevel>
__device__ void quantile_body(const Params& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int sh_warp[kWarps];
  __shared__ float sh_red[kWarps];
  __shared__ int sh_misc[2];
  __shared__ float edges[kMaxLvl];
  __shared__ int cum1[kMaxLvl];

  cg::grid_group grid = cg::this_grid();
  T* stage = reinterpret_cast<T*>(smem);
  int* hist = reinterpret_cast<int*>(smem + p.stage_bytes);
  const int nb = kTwoLevel ? p.lvl : p.bins;
  const int warp = threadIdx.x >> 5;
  int* my_hist = hist + (warp % p.nsub) * nb;
  // the stage holds the tile plus up to 15 bytes of alignment head
  const long long tile = (p.stage_bytes - 16) / static_cast<int>(sizeof(T));

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phase = 0;
  trace(0);

  const int slot = blockIdx.x / p.bpr;
  const int part = blockIdx.x % p.bpr;
  const int rounds = (p.rows + p.rows_per_round - 1) / p.rows_per_round;
  for (int r = 0; r < rounds; ++r) {
    const int row = r * p.rows_per_round + slot;
    const bool active = slot < p.rows_per_round && row < p.rows;
    int* ws = p.ws + static_cast<long long>(slot) * p.stride;
    int* ws_counts = ws + kSlotHeader;
    int* my_counts = ws_counts + (part % p.replicas) * p.nc;
    const T* xr = static_cast<const T*>(p.x) + static_cast<long long>(row) * p.n;
    long long s = static_cast<long long>(part) * p.seg;
    long long e = s + p.seg;
    if (!active || s > p.n) s = p.n;
    if (e > p.n) e = p.n;
    bool resident = false;
    int head = 0;

    // pass 1: max|x| of the row
    float m = 0.0f;
    if (active) {
      for_each_abs(xr, s, e, stage, tile, &bar, phase, resident, head,
                   [&](float a) { m = fmaxf(m, a); });
    }
    m = block_max(m, sh_red);
    if (active && threadIdx.x == 0) atomicMax(&ws[0], __float_as_int(m));
    for (int i = threadIdx.x; i < p.nsub * nb; i += blockDim.x) hist[i] = 0;
    trace(1);
    grid.sync();
    trace(2);

    if (active) {
      const float scale = fmaxf(__int_as_float(__ldcg(&ws[0])), 1e-12f);
      const float flvl = static_cast<float>(p.lvl);
      if (!kTwoLevel) {
        const float fbins = static_cast<float>(p.bins);
        for_each_abs(xr, s, e, stage, tile, &bar, phase, resident, head, [&](float a) {
          int idx = static_cast<int>(__fmul_rn(__fdiv_rn(a, scale), fbins));
          idx = idx < 0 ? 0 : (idx > p.bins - 1 ? p.bins - 1 : idx);
          atomicAdd(&my_hist[idx], 1);
        });
        trace(3);
        merge_counts(hist, p.nsub, nb, my_counts);
        trace(4);
      } else {
        // coarse edges scale * (k / lvl)
        for (int k = threadIdx.x; k < p.lvl; k += blockDim.x) {
          edges[k] = __fmul_rn(scale, __fdiv_rn(static_cast<float>(k + 1), flvl));
        }
        __syncthreads();
        const float e_last = edges[p.lvl - 1];
        const float per_edge = __fdividef(flvl, scale);
        for_each_abs(xr, s, e, stage, tile, &bar, phase, resident, head, [&](float a) {
          if (a <= e_last) {
            atomicAdd(&my_hist[place(edges, p.lvl, a, static_cast<int>(a * per_edge))], 1);
          }
        });
        trace(3);
        merge_counts(hist, p.nsub, nb, my_counts);
        trace(4);
        for (int i = threadIdx.x; i < p.nsub * nb; i += blockDim.x) hist[i] = 0;
      }
    }
    if (kTwoLevel) {
      grid.sync();
      trace(5);
      if (active) {
        const float scale = fmaxf(__int_as_float(__ldcg(&ws[0])), 1e-12f);
        const float flvl = static_cast<float>(p.lvl);
        for (int k = threadIdx.x; k < p.lvl; k += blockDim.x) cum1[k] = total(ws_counts, k, p);
        __syncthreads();
        block_cumsum(cum1, p.lvl, sh_warp);
        const int c_idx = first_reaching(cum1, p.lvl, p.target, &sh_misc[0]);
        trace(6);
        const float lo = __fmul_rn(__fdiv_rn(static_cast<float>(c_idx), flvl), scale);
        const float width = __fdiv_rn(scale, flvl);
        // fine edges lo + width * (k / lvl)
        for (int k = threadIdx.x; k < p.lvl; k += blockDim.x) {
          edges[k] = __fadd_rn(lo, __fmul_rn(width, __fdiv_rn(static_cast<float>(k + 1), flvl)));
        }
        __syncthreads();
        // most elements lie below the first fine edge: count those in a register
        int below = 0;
        const float e_first = edges[0], e_last = edges[p.lvl - 1];
        const float per_edge = __fdividef(flvl, width);
        for_each_abs(xr, s, e, stage, tile, &bar, phase, resident, head, [&](float a) {
          if (a <= e_first) {
            ++below;
          } else if (a <= e_last) {
            const int guess = static_cast<int>((a - lo) * per_edge);
            atomicAdd(&my_hist[place(edges, p.lvl, a, guess)], 1);
          }
        });
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) below += __shfl_xor_sync(0xffffffffu, below, off);
        if ((threadIdx.x & 31) == 0 && below) atomicAdd(&my_hist[0], below);
        trace(7);
        merge_counts(hist, p.nsub, nb, my_counts + p.lvl);
        trace(8);

        if (last_of_row(&ws[1], p.bpr, &sh_misc[1])) {
          trace(9);
          int* cum2 = hist;  // the block's counts are merged: reuse their space
          for (int k = threadIdx.x; k < p.lvl; k += blockDim.x) {
            cum2[k] = total(ws_counts, p.lvl + k, p);
          }
          __syncthreads();
          block_cumsum(cum2, p.lvl, sh_warp);
          const int f_idx = first_reaching(cum2, p.lvl, p.target, &sh_misc[0]);
          if (threadIdx.x == 0) {
            const int below_lo = c_idx > 0 ? cum1[c_idx - 1] : 0;
            const float cdf_prev = static_cast<float>(f_idx > 0 ? cum2[f_idx - 1] : below_lo);
            const float count = __fsub_rn(static_cast<float>(cum2[f_idx]), cdf_prev);
            float frac = __fdiv_rn(__fsub_rn(p.target, cdf_prev), fmaxf(count, 1.0f));
            frac = fminf(fmaxf(frac, 0.0f), 1.0f);
            p.out[row] = __fadd_rn(
                lo, __fmul_rn(__fadd_rn(static_cast<float>(f_idx), frac), __fdiv_rn(width, flvl)));
          }
          for (int i = threadIdx.x; i < p.stride; i += blockDim.x) ws[i] = 0;
      trace(10);
        }
      }
    } else if (active && last_of_row(&ws[1], p.bpr, &sh_misc[1])) {
      trace(9);
      const float hv = fmaxf(__int_as_float(__ldcg(&ws[0])), 1e-12f);
      int* cdf = hist;  // the block's counts are merged: reuse their space
#pragma unroll 4
      for (int b = threadIdx.x; b < p.bins; b += blockDim.x) cdf[b] = total(ws_counts, b, p);
      __syncthreads();
      block_cumsum(cdf, p.bins, sh_warp);
      const int bin = first_reaching(cdf, p.bins, p.target, &sh_misc[0]);
      if (threadIdx.x == 0) {
        const float cdf_prev = bin > 0 ? static_cast<float>(cdf[bin - 1]) : 0.0f;
        const float count = fmaxf(static_cast<float>(cdf[bin] - (bin > 0 ? cdf[bin - 1] : 0)), 1.0f);
        float frac = __fdiv_rn(__fsub_rn(p.target, cdf_prev), count);
        frac = fminf(fmaxf(frac, 0.0f), 1.0f);
        p.out[row] = __fmul_rn(
            __fdiv_rn(__fadd_rn(static_cast<float>(bin), frac), static_cast<float>(p.bins)), hv);
      }
      for (int i = threadIdx.x; i < p.stride; i += blockDim.x) ws[i] = 0;
      trace(10);
    }
    // the next round's blocks use the slots this round's last blocks reset
    if (r + 1 < rounds) grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) histogram_quantile_kernel(Params p) {
  quantile_body<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) histogram_abs_quantile_kernel(Params p) {
  quantile_body<T, true>(p);
}

struct LaunchShape {
  int blocks_per_sm = 0;
  int sms = 0;
};

// Occupancy per (device, kernel instance, shared-memory size), set up once.
template <typename T, bool kTwoLevel>
int launch(Params p, int smem_bytes, long long ws_ints, cudaStream_t stream, int* grid_out) {
  static LaunchShape shapes[kMaxDevices];
  static int shape_smem[kMaxDevices];
  void* fn = kTwoLevel ? reinterpret_cast<void*>(histogram_abs_quantile_kernel<T>)
                       : reinterpret_cast<void*>(histogram_quantile_kernel<T>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  LaunchShape& shape = shapes[dev];
  if (shape.blocks_per_sm == 0 || shape_smem[dev] != smem_bytes) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&shape.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape.blocks_per_sm, fn, kThreads,
                                                        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (shape.blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    shape_smem[dev] = smem_bytes;
  }
  const int resident = shape.blocks_per_sm * shape.sms;
  p.rows_per_round = p.rows < resident ? p.rows : resident;
  long long bpr = resident / p.rows_per_round;
  const long long useful = (p.n + kMinSegment - 1) / kMinSegment;
  if (bpr > useful) bpr = useful;
  if (bpr < 1) bpr = 1;
  p.bpr = static_cast<int>(bpr);
  p.replicas = p.bpr < kReplicas ? p.bpr : kReplicas;
  p.stride = kSlotHeader + p.replicas * p.nc;
  if (static_cast<long long>(p.rows_per_round) * p.stride > ws_ints) {
    return static_cast<int>(cudaErrorInvalidValue);  // workspace too small
  }
  p.seg = ((p.n + bpr - 1) / bpr + 15) / 16 * 16;
  const int grid = p.rows_per_round * p.bpr;
  if (grid_out) *grid_out = grid;
  void* args[] = {&p};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem_bytes, stream));
}

template <typename T>
int dispatch(int two_level, Params p, int smem_bytes, long long ws_ints, cudaStream_t s,
             int* grid) {
  return two_level ? launch<T, true>(p, smem_bytes, ws_ints, s, grid)
                   : launch<T, false>(p, smem_bytes, ws_ints, s, grid);
}

}  // namespace

namespace {

int levels(int bins) {
  int lvl = 2;
  while (lvl * lvl < bins) ++lvl;
  return lvl;
}

}  // namespace

#ifdef HISTOGRAM_QUANTILE_TRACE
extern "C" int histogram_quantile_trace_reset() {
  unsigned long long init[kTraceSlots] = {~0ULL};
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, init, sizeof(init)));
}
extern "C" int histogram_quantile_trace_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}
#endif

// Ints of workspace a call on `rows` rows needs on a card with `sms` SMs:
// a slot per row of a round, each a header and up to kReplicas copies of
// the counts, with rows per round times copies at most the resident grid.
// The workspace must be zero before the first call; every call leaves it so.
extern "C" long long histogram_quantile_workspace_ints(int two_level, int bins, int rows,
                                                       int sms) {
  if (bins < 1 || bins > kMaxBins || rows < 1 || sms < 1) return -1;
  const long long resident = static_cast<long long>(kMaxBlocksPerSm) * sms;
  const long long nc = two_level ? 2 * levels(bins) : bins;
  const long long slots = rows < resident ? rows : resident;
  const long long copies = static_cast<long long>(rows) * kReplicas < resident
                               ? static_cast<long long>(rows) * kReplicas : resident;
  return slots * kSlotHeader + copies * nc;
}

// One launch.  dtype: 0 = float32, 1 = bfloat16, 2 = float16; two_level: 0
// for mode A, 1 for mode B; x is (rows, n) contiguous; out is (rows,) float32;
// ws holds ws_ints zeroed ints, left zeroed.  `grid` receives the number of
// blocks launched.  Returns the cudaError_t of the launch.
extern "C" int histogram_quantile_launch(const void* x, int dtype, int two_level, float* out,
                                         int* ws, long long ws_ints, int rows, long long n,
                                         int bins, float target, void* stream, int* grid) {
  if (bins < 1 || bins > kMaxBins || rows < 1 || n < 1 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x = x;
  p.out = out;
  p.ws = ws;
  p.n = n;
  p.rows = rows;
  p.bins = bins;
  p.lvl = two_level ? levels(bins) : 0;
  p.nc = two_level ? 2 * p.lvl : bins;
  p.target = target;
  const int nb = two_level ? p.lvl : bins;
  const int one = nb * static_cast<int>(sizeof(int));
  if (two_level) {
    p.nsub = kWarps;
  } else {
    p.nsub = kSubHistBytes / one;
    p.nsub = p.nsub < 1 ? 1 : (p.nsub > kWarps ? kWarps : p.nsub);
  }
  const int hist_bytes = p.nsub * one;
  p.stage_bytes = (kSmemBudget - hist_bytes) / 16 * 16;
  const int smem_bytes = p.stage_bytes + hist_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(two_level, p, smem_bytes, ws_ints, s, grid);
    case 1: return dispatch<__nv_bfloat16>(two_level, p, smem_bytes, ws_ints, s, grid);
    case 2: return dispatch<__half>(two_level, p, smem_bytes, ws_ints, s, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
