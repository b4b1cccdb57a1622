// Fused softmax attention of the LDM UNet, forward only (sm_90a).
//
// out = softmax(q k^T / scale) v over (b, h, t, d) heads, for every attention
// of `models/ldm/unet.attention` on bfloat16 CUDA tensors: txt2img-f8-large's
// heads of 40, 80 and 160 over 1,024, 256, 64 and 16 tokens and SDXL's heads of
// 64 over 4,096 and 1,024 tokens, each as self-attention and as cross-attention
// over a 77-token context.  It replaces no TPU kernel: the JAX package leaves
// this attention to XLA.  It was added because the plain body (bf16 logits,
// the bf16 division, a float32 copy, the softmax, the cast back, the second
// product) writes and reads the logits five times: at SDXL's 4,096 tokens,
// 10 heads and batch 6 one call's float32 logits are 4 GB, and those passes
// took about 205 of the UNet step's 349 device ms.
//
// Numerics.  The logits q.k stay in the MMA's float32 accumulator (the plain
// body rounds them to bf16 and divides in bf16); `scale` is sqrt(d) rounded to
// bf16 as the plain body has it, folded with log2(e) into one float32
// multiplier c = log2(e) / scale.  The softmax is online and in float32:
// per row the running maximum m, p = 2^(s c - m c) through ex2.approx, the
// running sum of the float32 p; P is rounded to bf16 (the plain body rounds
// its normalised probabilities to bf16 there too) and multiplied by V with
// float32 accumulation; the output is divided by the row sum at the end and
// stored as bf16.  The build's -fmad=false holds, so every fused multiply-add
// here is written as __fmaf_rn.  No atomics and no data-dependent order: a
// call gives the same bits every time, so a CUDA graph's replay equals the
// eager forward.
//
// Bound on the card: tensor-core operations.  4 t_q t_k d FLOPs a call (the
// two products) and t_q t_k exponentials; SDXL's 140 calls a UNet step are
// 4.51 TFLOP, 4.6 ms at 989 TFLOP/s, and 1.76e10 exponentials, about 4.2 ms
// of the SMs' MUFU units.  Bytes are q, k, v and out once: 0.3 GB a step.
//
// Design (FlashAttention-2's forward, mma.sync m16n8k16 and cp.async):
//   * One block of 8 warps per (batch x head, 128-query tile); each warp owns
//     16 query rows.  The 128 x d query tile is copied to shared memory once
//     and each warp keeps its A fragments of it in registers.
//   * Keys and values stream through a three-stage ring of 64-row tiles in
//     shared memory, filled with cp.async (16 bytes a thread, rows past the
//     key length zero-filled), the next tile in flight while the current one
//     is used; with three stages the tile being filled was last read two
//     tiles ago, so one barrier a tile suffices.  Rows are padded by 16 bytes
//     so that ldmatrix is conflict-free; d = 40 is zero-padded to 48 in
//     shared memory, the depth of three k16 steps.
//   * Two blocks share an SM up to d = 64, so that one block's softmax
//     overlaps the other's products and copies.
//   * S = Q K^T by mma.sync into float32 registers; keys past the length are
//     set to -inf (77 is no multiple of 64).  The row maximum and sums are
//     reduced over the four threads of a quad with shuffles.
//   * P is converted to bf16 in registers: the accumulators of two adjacent
//     8-key tiles are exactly the A fragment of one k16 step of P V, so P
//     never leaves the registers.  V's B fragments come from ldmatrix.trans.
//   * O (16 x d a warp, float32) is rescaled in registers by each tile's
//     change of the maximum, divided by the row sum at the end and written as
//     bf16 pairs straight into the (b, t, h, d) layout of the caller's to_out
//     input.
//   * q, k and v are read through their strides (the (b, t, h, d) buffers of
//     the projections seen as (b, h, t, d)), so no copy precedes the call.
// The kernel launches on the caller's stream, allocates nothing and needs no
// host synchronisation, so it is captured into the UNet's CUDA graph.
//
// Reached on one H100 80GB HBM3 at 700 W: about 1.0 ms a call at SDXL's
// 6 x 10 heads x 4,096 x 4,096 x 64 (about 255 TFLOP/s, 26% of the bf16 peak)
// and 21.7 ms for a UNet step's 140 calls.  Copying K and V through shared
// memory alone, with no products and no softmax, takes 0.4 ms of that call
// (every 128-query block reads its head's keys and values from L2); leaving
// out the exponentials, either product, the softmax, the next tile's copies
// or the barrier saved at most 18% each, and larger query tiles (192, 256
// rows) or two row tiles a warp were slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBr = 128;               // query rows a block
constexpr int kBc = 64;                // keys a tile
constexpr int kWarps = kBr / 16;       // one warp per 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;             // key/value tiles in the ring

typedef __nv_bfloat16 bf16;

template <int D>
struct Shape {
  static constexpr int kDp = (D + 15) / 16 * 16;  // depth padded to k16 steps
  static constexpr int kLd = kDp + 8;             // shared row stride (elements): +16 bytes
  static constexpr int kRows = kBr + 2 * kStages * kBc;  // Q, then K and V stages
  static constexpr int kSmemBytes = kRows * kLd * static_cast<int>(sizeof(bf16));
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of batch, head, token
  int heads, t_q, t_k;
  float c;  // log2(e) / scale
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a b for one 16 x 8 x 16 tile: bf16 operands, float32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16; lo in the low half, the lower column of an MMA operand
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + n_rows) of a (rows, D) strided matrix into a shared
// tile of stride kLd; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride, int row0,
                                          int valid, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < n_rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = row0 + r < valid;
    const bf16* g = src + (ok ? static_cast<long long>(row0 + r) * stride + col : 0);
    cp_async16(smem_addr(dst + r * Shape<D>::kLd + col), g, ok ? 16 : 0);
  }
}

// Two blocks an SM up to d = 64 (at most 128 registers a thread; d = 80 and
// 160 would spill).
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
ldm_softmax_attention_fwd(const Params p) {
  constexpr int kDp = Shape<D>::kDp, kLd = Shape<D>::kLd;
  constexpr int kSt = kBc / 8;   // 8-key tiles of S
  constexpr int kOt = kDp / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kBr * kLd;
  bf16* sv = sk + kStages * kBc * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kBr;
  const bf16* qg = p.q + b * p.qs[0] + h * p.qs[1];
  const bf16* kg = p.k + b * p.ks[0] + h * p.ks[1];
  const bf16* vg = p.v + b * p.vs[0] + h * p.vs[1];

  // the depth padding (d = 40 only) is zero in every tile; the copies never write it
  if constexpr (kDp > D) {
    constexpr int kPad = (kDp - D) / 8;  // 16-byte chunks of padding a row
    for (int c = threadIdx.x; c < Shape<D>::kRows * kPad; c += kThreads) {
      const int r = c / kPad, col = D + (c % kPad) * 8;
      *reinterpret_cast<uint4*>(sq + r * kLd + col) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  load_tile<D>(sq, qg, p.qs[2], q0, p.t_q, kBr);
  load_tile<D>(sk, kg, p.ks[2], 0, p.t_k, kBc);
  load_tile<D>(sv, vg, p.vs[2], 0, p.t_k, kBc);
  cp_async_commit();

  // this warp's 16 rows: rows lane/4 and lane/4 + 8 of them a thread
  const float neg_inf = __int_as_float(0xff800000);
  uint32_t qf[kDp / 16][4];
  float o[kOt][4];
#pragma unroll
  for (int i = 0; i < kOt; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {neg_inf, neg_inf};  // running maxima
  float l[2] = {0.f, 0.f};          // this thread's part of the running sums

  const int n_tiles = (p.t_k + kBc - 1) / kBc;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (j + 1 < n_tiles) {
      const int next = (j + 1) % kStages;
      load_tile<D>(sk + next * kBc * kLd, kg, p.ks[2], (j + 1) * kBc, p.t_k, kBc);
      load_tile<D>(sv + next * kBc * kLd, vg, p.vs[2], (j + 1) * kBc, p.t_k, kBc);
    }
    cp_async_commit();  // possibly empty: tile j's group is then never the newest
    cp_async_wait_one();
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        ldsm_x4(smem_addr(sq + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8), qf[kk]);
      }
    }
    const bf16* ks = sk + stage * kBc * kLd;
    const bf16* vs = sv + stage * kBc * kLd;

    // S = Q K^T, 16 x 64 a warp
    float s[kSt][4];
#pragma unroll
    for (int i = 0; i < kSt; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kSt; nt += 2) {
        uint32_t bk[4];
        ldsm_x4(smem_addr(ks + (nt * 8 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                          ((lane / 8) % 2) * 8), bk);
        mma16816(s[nt], qf[kk], bk[0], bk[1]);
        mma16816(s[nt + 1], qf[kk], bk[2], bk[3]);
      }
    }
    if ((j + 1) * kBc > p.t_k) {  // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < kSt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * kBc + nt * 8 + (lane % 4) * 2 + (e % 2) >= p.t_k) s[nt][e] = neg_inf;
        }
      }
    }

    // online softmax; every tile holds a valid key, so the maximum is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kSt; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], neg_mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * p.c);  // 0 on the first tile (m = -inf)
      neg_mc[i] = -(mx[i] * p.c);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < kSt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(__fmaf_rn(s[nt][e], p.c, neg_mc[e / 2]));
        sum[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __fmaf_rn(l[i], alpha[i], sum[i]);
#pragma unroll
    for (int dt = 0; dt < kOt; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: two 8-key accumulator tiles of S are the A fragment of a k16 step
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kOt; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_addr(vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + dt * 8 +
                                (lane / 16) * 8), bv);
        mma16816(o[dt], a, bv[0], bv[1]);
        mma16816(o[dt + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / l[i];
  }
  const int row = q0 + warp * 16 + lane / 4;
  bf16* og = p.o + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int dt = 0; dt < kOt; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    if (col < D) {
      if (row < p.t_q) {
        *reinterpret_cast<uint32_t*>(og + row * p.os[2] + col) =
            pack_bf16(o[dt][0] * l[0], o[dt][1] * l[0]);
      }
      if (row + 8 < p.t_q) {
        *reinterpret_cast<uint32_t*>(og + (row + 8) * p.os[2] + col) =
            pack_bf16(o[dt][2] * l[1], o[dt][3] * l[1]);
      }
    }
  }
}

template <int D>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(ldm_softmax_attention_fwd<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<D>::kSmemBytes);
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.t_q + kBr - 1) / kBr, batch * p.heads);
  ldm_softmax_attention_fwd<D><<<grid, kThreads, Shape<D>::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Raise the dynamic shared memory limit of every instance on the current
// device (each needs more than the default 48 KB).  Call once per device,
// outside a stream capture.  Returns the first cudaError_t that is not 0.
extern "C" int ldm_attention_init() {
  cudaError_t err;
  if ((err = set_smem<40>()) != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem<64>()) != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem<80>()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(set_smem<160>());
}

// One launch.  q, k, v: bfloat16 (batch, heads, t, d) through the element
// strides in `strides` (batch, head, token for q, k, v, then out; the last
// dimension dense, every stride a multiple of 8 and every pointer 16-byte
// aligned); k and v share t_k.  out receives (batch, heads, t_q, d) in bf16
// through its strides.  c = log2(e) / scale.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a head dim without an instance).
extern "C" int ldm_attention_launch(int d, const void* q, const void* k, const void* v, void* out,
                                    int batch, int heads, int t_q, int t_k,
                                    const long long* strides, float c, void* stream) {
  if (batch < 1 || heads < 1 || t_q < 1 || t_k < 1 || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(out);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.heads = heads;
  p.t_q = t_q;
  p.t_k = t_k;
  p.c = c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return static_cast<int>(launch<40>(p, batch, s));
    case 64: return static_cast<int>(launch<64>(p, batch, s));
    case 80: return static_cast<int>(launch<80>(p, batch, s));
    case 160: return static_cast<int>(launch<160>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
