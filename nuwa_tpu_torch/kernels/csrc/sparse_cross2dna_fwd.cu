// SparseCross2DNA forward (with or without attention dropout) for Hopper,
// sm_90a.
//
// Replaces the fused cross kernels of nuwa_tpu/kernels/nda_pallas.py:
// `_xfused_kernel` (two or more context frames) and `_xfused1_kernel` (one
// context frame), both launched by `_xfused_fwd_call`, and with them the
// per-frame fallback `_cross_core_op`, which the JAX package takes when the
// fused kernels' score cache would not fit VMEM. It computes the same
// function: every video query at spatial position (y, x) of any query frame
// attends the null key/value and, in every context frame, the centered
// k x k window of step `dil` around (y, x), where the window lies inside the
// frame and the runtime context mask allows the key; the softmax is fp32;
// the normalised probabilities are mixed across heads by the talking-heads
// matrix (null column included) before they weight the values. With
// dropout on, each mixed probability, the null column's included, is
// multiplied by its keep factor (sparse3dna_dropout.cuh: the fp32 scale
// 1 / keep or 0, hashed from the seed, the batch row, the head, the query
// and the context token, the null column's key -2) before PV, as the Pallas
// kernels drop after the mix (nda_pallas.py:2759, :2844). Every value row
// is still read: skipping those of pairs a head drops, as the Sparse3DNA
// forward does, puts a shared-memory test before each value row's load,
// which measured slower here on an H100 (dropout cost +14-20% of the time
// without it, against +4-7% reading every row). It writes `out` (in the
// inputs' type) and the per-row logsumexp `lse` (fp32, the undropped
// softmax's), the residual a flash-style backward consumes.
//
// What bounds it on the card: memory. Per query and head it does about
// 4*(Fc*k*k+1)*d operations (19 keys at Fc = 2, k = 3), while the bytes that
// must move are one row each of q and out per query and the context's k and
// v rows once: about 9 operations per byte in bf16, far under the ~300 of
// the H100's bf16 tensor cores. Every context row is read by the k*k
// spatial neighbours of every query frame.
//
// What the design does about it. The TPU kernels scored every query frame
// against whole context frames (dense HW x HW tiles masked to the window by
// an additive -inf table, the head dim padded to 128 lanes, a bf16 score
// cache in VMEM) because the matrix unit wants large dense tiles. None of
// that helps a gather of 19 rows on Hopper, so this kernel reads only the
// window: one block per (query token, batch element) holds all h heads, one
// warp per head, and the window comes from the query's coordinates, so no
// mask table is read. Lanes stride the head dim, so each key or value row
// is one coalesced read; the rows shared by the queries of one spatial
// position (all query frames) and its neighbours are served from L1/L2, so
// device memory sees each context row about once. The context mask comes
// in as bytes and a masked key is left out (probability exactly 0); the
// null column is always present, so a row with every context key masked
// (the unconditional half of a classifier-free-guidance batch) gets the
// mixed null value and a finite lse. Scores and softmax stay in registers
// and shared memory in fp32; the heads meet in shared memory for the
// talking-heads mix, which couples them after normalisation, so the softmax
// of all heads completes before any head's PV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"

namespace {

constexpr int kMaxR = 8;  // head dim up to 32 * kMaxR = 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Geometry {
  int t;     // video queries (rows of q)
  int lc;    // context tokens: whole frames of fmap * fmap
  int fmap;  // side of a context frame (and of a query frame)
  int k;     // window side, odd
  int dil;   // window step
};

// grid (t, b), block 32 * heads: warp w handles head w of one query token.
// kDrop: with attention dropout (false compiles none of the dropout code).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(1024) sparse_cross2dna_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ null_k, const T* __restrict__ null_v,
    const float* __restrict__ th, const unsigned char* __restrict__ cmask,
    T* __restrict__ out, float* __restrict__ lse, int heads, int d, Geometry g,
    Dropout drop) {
  extern __shared__ float smem[];
  const int hw = g.fmap * g.fmap;
  const int kk = g.k * g.k;
  const int kn = (g.lc / hw) * kk;  // window keys over all context frames
  const int slots = kn + 1;         // slot 0 is the null key
  float* s_th = smem;                    // (heads, heads)
  float* s_p = s_th + heads * heads;     // (heads, slots) probabilities
  float* s_mix = s_p + heads * slots;    // (heads, slots) mixed
  int* s_nb = reinterpret_cast<int*>(s_mix + heads * slots);  // (kn) token or -1

  const int i = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int x = threadIdx.x; x < heads * heads; x += blockDim.x) s_th[x] = th[x];
  const int s = i % hw, y = s / g.fmap, xx = s % g.fmap;
  const int half = (g.k - 1) / 2;
  for (int j = threadIdx.x; j < kn; j += blockDim.x) {
    // slot j: context frame j / kk, window position j % kk row-major, as
    // the plain version's table enumerates them
    const int c = j / kk, r = j % kk;
    const int ny = y + (r / g.k - half) * g.dil;
    const int nx = xx + (r % g.k - half) * g.dil;
    int tok = -1;
    if (ny >= 0 && ny < g.fmap && nx >= 0 && nx < g.fmap) {
      tok = c * hw + ny * g.fmap + nx;
      if (cmask != nullptr && !cmask[static_cast<size_t>(bi) * g.lc + tok]) tok = -1;
    }
    s_nb[j] = tok;
  }
  __syncthreads();

  const int h = warp;
  const size_t row = static_cast<size_t>(bi) * heads + h;  // (b, h) plane
  const T* kplane = k + row * g.lc * d;
  const T* vplane = v + row * g.lc * d;
  const T* qrow = q + (row * g.t + i) * d;

  float qr[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    qr[r] = e < d ? to_f(qrow[e]) : 0.f;
  }

  // ---- scores: one warp-wide dot product per slot ----------------------
  float* p = s_p + h * slots;
  {
    const T* kr = null_k + row * d;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      if (e < d) acc = fmaf(qr[r], to_f(kr[e]), acc);
    }
    acc = warp_sum(acc);
    // the null column is never masked: a row whose context is all masked
    // has it alone, P = 1 exactly and lse the score itself, as the
    // backward kernel takes it
    if (lane == 0) p[0] = acc;
  }
  for (int j = 0; j < kn; ++j) {
    const int tok = s_nb[j];  // uniform across the warp
    float sc = -CUDART_INF_F;
    if (tok >= 0) {
      const T* kr = kplane + static_cast<size_t>(tok) * d;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        if (e < d) acc = fmaf(qr[r], to_f(kr[e]), acc);
      }
      sc = warp_sum(acc);
    }
    if (lane == 0) p[1 + j] = sc;
  }
  __syncwarp();

  // ---- fp32 softmax over the slots of this head ------------------------
  float m = -CUDART_INF_F;
  for (int j = lane; j < slots; j += 32) m = fmaxf(m, p[j]);
  m = warp_max(m);  // finite: the null slot is always present
  float den = 0.f;
  for (int j = lane; j < slots; j += 32) den += expf(p[j] - m);
  den = warp_sum(den);
  const float inv = 1.f / den;
  __syncwarp();
  for (int j = lane; j < slots; j += 32) p[j] = expf(p[j] - m) * inv;
  if (lane == 0) lse[row * g.t + i] = m + logf(den);
  __syncthreads();

  // ---- talking heads: mixed[h, j] = sum_h2 th[h, h2] * p[h2, j], dropped
  float* mix = s_mix + h * slots;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  for (int j = lane; j < slots; j += 32) {
    float acc = 0.f;
    for (int h2 = 0; h2 < heads; ++h2) acc += s_th[h * heads + h2] * s_p[h2 * slots + j];
    if (kDrop) acc *= keep_factor(drop, row_stream, h, i, slot_key(s_nb, j));
    mix[j] = acc;
  }
  __syncwarp();

  // ---- PV ----------------------------------------------------------------
  float o[kMaxR];
  {
    const T* vr = null_v + row * d;
    const float w = mix[0];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      o[r] = e < d ? w * to_f(vr[e]) : 0.f;
    }
  }
  for (int j = 0; j < kn; ++j) {
    const int tok = s_nb[j];
    if (tok < 0) continue;  // its probability is 0 in every head
    const float w = mix[1 + j];
    const T* vr = vplane + static_cast<size_t>(tok) * d;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      if (e < d) o[r] += w * to_f(vr[e]);
    }
  }
  T* orow = out + (row * g.t + i) * d;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) orow[e] = from_f<T>(o[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* null_k,
           const void* null_v, const float* th, const unsigned char* cmask, void* out,
           float* lse, int b, int heads, int d, Geometry g, Dropout drop,
           cudaStream_t stream) {
  const int kn = (g.lc / (g.fmap * g.fmap)) * g.k * g.k;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(heads) * heads + 2 * heads * (kn + 1)) +
      sizeof(int) * kn;
  const auto kernel = drop.on ? sparse_cross2dna_fwd_kernel<T, true>
                              : sparse_cross2dna_fwd_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.t, b);
  const dim3 block(32 * heads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(null_k), static_cast<const T*>(null_v), th, cmask,
      static_cast<T*>(out), lse, heads, d, g, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, out
// (b, heads, t, d); k, v (b, heads, lc, d); null_k, null_v (b, heads, 1, d);
// th (heads, heads) fp32; cmask (b, lc) bytes, nonzero where a context token
// may be attended, or null for all; lse (b, heads, t) fp32; drop 1 for
// attention dropout with the hash's seed, its threshold and the fp32 scale
// 1 / keep (sparse3dna_dropout.cuh), 0 for none.
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* null_k, const void* null_v, const float* th,
                              const unsigned char* cmask, void* out, float* lse, int b,
                              int heads, int t, int d, int lc, int fmap, int ksize,
                              int dil, int drop, unsigned int seed, unsigned int thresh,
                              float scale, void* stream) {
  const Geometry g{t, lc, fmap, ksize, dil};
  const Dropout dp{drop, seed, thresh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, null_k, null_v, th, cmask, out, lse, b, heads, d, g, dp,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, null_k, null_v, th, cmask, out, lse, b, heads,
                                 d, g, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
