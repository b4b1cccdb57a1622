// Per-row histogram quantile of |x| for dynamic thresholding (sm_90a).
//
// Replaces the Pallas TPU kernel `histogram_quantile_pallas`
// (clip_diffusion_tpu/ops/quantile.py:79, pl.pallas_call at :115) and
// computes the same function: for each row of a (B, N) tensor, with
// hi = max(max|x|, 1e-12) computed by the caller, a `bins`-bin histogram of
// int(|x| / hi * bins) clipped to [0, bins-1], its cumulative sum, the first
// bin whose count reaches target = float32(q * N), and linear interpolation
// (bin + frac) / bins * hi inside that bin.  Error <= max|x| / bins.
//
// The TPU kernel walks the row in order on one core and keeps the
// histogram in VMEM scratch.  Here blocks run in parallel and in no order,
// so the work is split in two kernels:
//   1. histogram_kernel: grid (row splits, B), 256 threads.  Each block
//      builds a private histogram of its share of one row in shared memory
//      with integer atomics, then adds its non-zero bins into the row's
//      int32 histogram in global memory (zeroed by the caller).
//   2. finalize_kernel: one block per row; a block prefix sum over the
//      bins, the first bin with cdf >= target (bin 0 when none, as argmax
//      of all-false), and the interpolation.
// Integer atomics make the result the same from run to run, and with IEEE
// division and no FMA contraction (built without --use_fast_math and with
// -fmad=false) the bin of every element equals the plain PyTorch version's
// (clip_diffusion_tpu_torch/ops/quantile.py:histogram_quantile_plain).
// Counts are exact in float32 below 2^24 elements per row.
//
// Bound on the card: memory.  The kernel must read 4*B*N bytes once (f32):
// 3.1 MB for the main path's (1, 786432) row, about 0.94 us at 3.35 TB/s,
// so at this size launch overhead dominates.  The design keeps the
// histogram in shared memory (one global atomic per non-zero bin per
// block) and reads x in coalesced strides; making it fast is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 12288;  // 48 KB of int32 counts

__device__ __forceinline__ float load_as_float(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_as_float(const __half* p, long long i) {
  return __half2float(p[i]);
}

template <typename T>
__global__ void histogram_kernel(const T* __restrict__ x, const float* __restrict__ hi,
                                 int* __restrict__ hist, long long n, int bins,
                                 long long chunk) {
  extern __shared__ int sh_hist[];
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) sh_hist[i] = 0;
  __syncthreads();

  const float h = fmaxf(hi[row], 1e-12f);
  const float fbins = (float)bins;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = start + chunk < n ? start + chunk : n;
  const T* xr = x + (long long)row * n;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float a = fabsf(load_as_float(xr, i));
    // same order as the TPU kernel: |x| / hi * bins, truncate, clip
    const float s = __fmul_rn(__fdiv_rn(a, h), fbins);
    int idx = (int)s;
    idx = idx < 0 ? 0 : (idx > bins - 1 ? bins - 1 : idx);
    atomicAdd(&sh_hist[idx], 1);
  }
  __syncthreads();

  int* grow = hist + (long long)row * bins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int c = sh_hist[i];
    if (c) atomicAdd(&grow[i], c);
  }
}

__global__ void finalize_kernel(const int* __restrict__ hist, const float* __restrict__ hi,
                                float* __restrict__ out, int bins, float target) {
  // each thread owns `per` consecutive bins
  __shared__ int sh_tot[kThreads];
  __shared__ int sh_first;
  const int row = blockIdx.x;
  const int* h = hist + (long long)row * bins;
  const int per = (bins + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi_bin = lo + per < bins ? lo + per : bins;

  int local = 0;
  for (int b = lo; b < hi_bin; ++b) local += h[b];
  sh_tot[threadIdx.x] = local;
  if (threadIdx.x == 0) sh_first = bins;
  __syncthreads();

  // inclusive Hillis-Steele scan over the per-thread totals
  for (int off = 1; off < kThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? sh_tot[threadIdx.x - off] : 0;
    __syncthreads();
    sh_tot[threadIdx.x] += v;
    __syncthreads();
  }

  const int before = threadIdx.x > 0 ? sh_tot[threadIdx.x - 1] : 0;
  int cdf = before;
  for (int b = lo; b < hi_bin; ++b) {
    cdf += h[b];
    if ((float)cdf >= target) {
      atomicMin(&sh_first, b);
      break;
    }
  }
  __syncthreads();

  const int bin = sh_first < bins ? sh_first : 0;  // argmax of all-false -> 0
  if (bin >= lo && bin < hi_bin) {  // the one thread that owns the bin
    int cdf_prev = before;
    for (int b = lo; b < bin; ++b) cdf_prev += h[b];
    const float count = fmaxf((float)h[bin], 1.0f);
    float frac = __fdiv_rn(__fsub_rn(target, (float)cdf_prev), count);
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    const float hv = fmaxf(hi[row], 1e-12f);
    out[row] = __fmul_rn(__fdiv_rn(__fadd_rn((float)bin, frac), (float)bins), hv);
  }
}

template <typename T>
int launch(const void* x, const float* hi, float* out, int* hist, int rows, long long n,
           int bins, int splits, float target, cudaStream_t stream) {
  const long long chunk = (n + splits - 1) / splits;
  dim3 grid(splits, rows);
  histogram_kernel<T><<<grid, kThreads, bins * sizeof(int), stream>>>(
      static_cast<const T*>(x), hi, hist, n, bins, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<rows, kThreads, 0, stream>>>(hist, hi, out, bins, target);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  `hist` is a zeroed
// int32 (rows, bins) buffer.  Returns the cudaError_t of the launches.
extern "C" int histogram_quantile_launch(const void* x, int dtype, const float* hi, float* out,
                                         int* hist, int rows, long long n, int bins, int splits,
                                         float target, void* stream) {
  // the block histogram lives in the default 48 KB of dynamic shared memory
  if (bins < 1 || bins > kMaxBins || rows < 1 || n < 1 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, hi, out, hist, rows, n, bins, splits, target, s);
    case 1: return launch<__nv_bfloat16>(x, hi, out, hist, rows, n, bins, splits, target, s);
    case 2: return launch<__half>(x, hi, out, hist, rows, n, bins, splits, target, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
