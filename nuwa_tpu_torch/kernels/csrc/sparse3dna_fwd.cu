// Sparse3DNA forward (causal, centered or audio, with or without attention
// dropout) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` in nuwa_tpu/kernels/nda_pallas.py
// (reached through `_fwd_call`, its pl.pallas_call, and the lane-packed
// `_packed_core_op` at fmap 8), and in the audio geometry the same kernel
// and the row-blocked `_rb_kernel` as `_audio_core_op` and
// `_audio_rb_core_op` run them for SparseCausal2DNA. It computes the same
// function: every query attends its Kf*Kh*Kw dilated neighbours plus the
// bos key/value (causal windows for the video decoder, centered ones for
// the sketch encoder; a neighbour counts when it lies in the grid and
// before the sequence end t, so the phantom tokens of a ragged last frame,
// which centered windows reach, are masked), with an optional per-head
// relative-position bias; the softmax is fp32; the normalised probabilities
// are mixed across heads by the talking-heads matrix (bos column included)
// before they weight the values. With dropout on, each mixed probability is
// multiplied by its keep factor (sparse3dna_dropout.cuh: the fp32 scale
// 1 / keep or 0, hashed from the seed, the batch row, the head, the query
// and the key token) before PV, as the Pallas kernels drop after the mix
// (nda_pallas.py:279, :447); `lse` stays the undropped softmax's. The
// warp of a head reads no value row of a pair that head drops.
//
// The audio geometry is SparseCausal2DNA's grid of (timesteps, 1, H): the
// time axis is causal with kernel Kf and dilation df, and on the width
// axis the window is the whole timestep, the absolute columns 0..H-1, not
// offsets around the query (kw = H). So a query sees every token of its
// own timestep, the later ones included, as the JAX module's forward does;
// the padded columns of a ragged last timestep lie at or past t and are
// masked. The TPU kernels reach this function through pseudo-frames of G
// timesteps with per-tap masks (`_audio_geometry`, `_audio_masks_np`); here
// the neighbour comes from the coordinates, as in the video geometry.
// It writes `out` (in the inputs' type) and the per-row logsumexp `lse`
// (fp32), the residual a flash-style backward consumes.
//
// What bounds it on the card: memory. Per query and head it does about
// 4*(Kn+1)*d operations (scores and PV over Kn = 27 neighbours plus bos),
// while the bytes that must move are one row each of q, k, v and out: about
// 14 operations per byte in bf16 and 7 in fp32, under the ~20 at which the
// H100's fp32 cores stop being bandwidth bound and far under the ~300 of its
// bf16 tensor cores. Every key and value row is reused by up to Kn queries.
//
// What the design does about it. The TPU kernel scored whole frames against
// whole frames (dense HW x HW tiles masked down to the neighbourhood, d
// padded to 128 lanes, a bf16 probability cache in VMEM) because its matrix
// unit wants large dense tiles. None of that helps a bandwidth-bound gather
// on Hopper, so this kernel reads only the neighbours: one block per
// (query token, batch element) holds all h heads, one warp per head. The
// neighbour list comes from the query's coordinates, so no table is read.
// Lanes stride the head dim, so each key or value row is one coalesced
// read, and the rows shared by neighbouring queries are served from L1/L2:
// device memory sees each row about once. Scores and softmax stay in
// registers and shared memory in fp32; the heads meet in shared memory for
// the talking-heads mix, which couples them after normalisation, so the
// softmax of all heads completes before any head's PV. Nothing but `out`
// and `lse` is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"

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

// grid (t, b), block 32 * heads: warp w handles head w of one query token.
// kDrop: with attention dropout (false compiles none of the dropout code).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(1024) sparse3dna_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ lse, int heads, int d, Geometry g,
    Dropout drop) {
  extern __shared__ float smem[];
  const int kn = g.kf * g.kh * g.kw;
  const int slots = kn + 1;  // slot 0 is bos
  float* s_th = smem;                    // (heads, heads)
  float* s_p = s_th + heads * heads;     // (heads, slots) probabilities
  float* s_mix = s_p + heads * slots;    // (heads, slots) mixed
  int* s_nb = reinterpret_cast<int*>(s_mix + heads * slots);  // (kn) token or -1

  const int i = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int x = threadIdx.x; x < heads * heads; x += blockDim.x) s_th[x] = th[x];
  const int hw = g.fh * g.fw;
  const int f = i / hw, y = (i % hw) / g.fw, xx = i % g.fw;
  for (int j = threadIdx.x; j < kn; j += blockDim.x) s_nb[j] = neighbour(g, f, y, xx, j);
  __syncthreads();

  const int h = warp;
  const size_t row = static_cast<size_t>(bi) * heads + h;  // (b, h) plane
  const T* kplane = k + row * g.t * d;
  const T* vplane = v + row * g.t * d;
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
    const T* kr = kbos + row * d;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      if (e < d) acc += qr[r] * to_f(kr[e]);
    }
    acc = warp_sum(acc);
    if (lane == 0) p[0] = acc;  // the bos column has no bias and no mask
  }
  for (int j = 0; j < kn; ++j) {
    const int tok = s_nb[j];  // uniform across the warp
    float s = -CUDART_INF_F;
    if (tok >= 0) {
      const T* kr = kplane + static_cast<size_t>(tok) * d;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        if (e < d) acc += qr[r] * to_f(kr[e]);
      }
      s = warp_sum(acc) + (bias != nullptr ? bias[h * kn + j] : 0.f);
    }
    if (lane == 0) p[1 + j] = s;
  }
  __syncwarp();

  // ---- fp32 softmax over the slots of this head ------------------------
  float m = -CUDART_INF_F;
  for (int j = lane; j < slots; j += 32) m = fmaxf(m, p[j]);
  m = warp_max(m);  // finite: the bos slot is always present
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
    const T* vr = vbos + row * d;
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
    if (kDrop && w == 0.f) continue;  // dropped in this head: its value row is not read
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
int launch(const void* q, const void* k, const void* v, const void* kbos,
           const void* vbos, const float* th, const float* bias, void* out,
           float* lse, int b, int heads, int d, Geometry g, Dropout drop, cudaStream_t stream) {
  const int kn = g.kf * g.kh * g.kw;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(heads) * heads + 2 * heads * (kn + 1)) +
      sizeof(int) * kn;
  const auto kernel =
      drop.on ? sparse3dna_fwd_kernel<T, true> : sparse3dna_fwd_kernel<T, false>;
  // Past the 48 KB default the block's limit is raised to what it asks; past
  // the card's opt-in maximum that call fails, and its error is returned
  // (the wrapper raises it).
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.t, b);
  const dim3 block(32 * heads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<T*>(out), lse, heads, d, g, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, k, v, out
// (b, heads, t, d); kbos, vbos (b, heads, 1, d); th (heads, heads) fp32;
// bias (heads, kf*kh*kw) fp32 or null; lse (b, heads, t) fp32; mode 1 for
// causal windows, 0 for centered, 2 for the audio geometry (fh = kh = 1,
// kw = fw = H); drop 1 for attention dropout with the hash's seed, its
// threshold and the fp32 scale 1 / keep (sparse3dna_dropout.cuh), 0 for none.
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse3dna_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* kbos, const void* vbos, const float* th,
                        const float* bias, void* out, float* lse, int b,
                        int heads, int t, int d, int fh, int fw, int kf, int kh,
                        int kw, int df, int dh, int dw, int mode, int drop,
                        unsigned int seed, unsigned int thresh, float scale, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Dropout dp{drop, seed, thresh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, dp,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
