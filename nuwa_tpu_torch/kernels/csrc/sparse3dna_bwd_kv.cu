// Sparse3DNA backward, key side (causal, centered or audio, with or without
// attention dropout) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_kv_kernel` in nuwa_tpu/kernels/nda_pallas.py
// (reached through `_bwd_kv_call`, its pl.pallas_call), and in the audio
// geometry the same kernel and the row-blocked `_rb_bwd_kv_kernel` as
// `_audio_core_op` and `_audio_rb_core_op` run them for SparseCausal2DNA.
// For every key token it sums, over the (query, slot) pairs that read that
// key,
//
//   dK = sum dS[query, slot] * q[query]
//   dV = sum mix[query, slot] * g[query]
//
// per head, from the fp32 (b, h, t, Kn + 1) tensors dS and mix that the
// query-side kernel (sparse3dna_bwd_q.cu) wrote. With attention dropout
// that kernel writes the dropped mix, the probabilities that weighted the
// values, and a dS that already carries the mask, so this kernel is the same
// function with or without dropout and takes no dropout argument (the Pallas
// key-side kernels regenerate the mask instead: nda_pallas.py:787, :1065,
// :1121). The TPU kernel recomputed
// S and P for each key frame instead, because on the TPU the probabilities
// are a dense (T x Kf*HW) tensor; here they are the sparse (T x Kn) one, 15 MB
// at the training shape (b = 2, h = 8, t = 2559, Kn = 45), which is cheaper
// to read back than to recompute.
//
// The inverse neighbourhood (`reader` in sparse3dna_geometry.cuh). With
// causal or centered windows, slot (a, b, c), row-major over (kf, kh, kw), has
// the offset ((a-cf)*df, (b-ch)*dh, (c-cw)*dw), with c_ = k_-1 on each axis
// when causal and (k_-1)/2 when centered, so key (f, y, x) is read through
// that slot by the one query (f - (a-cf)*df, y - (b-ch)*dh, x - (c-cw)*dw):
// the window reflected, Kn pairs, one a slot. In the audio geometry a slot's
// column is absolute, so the key (s, c) of a (timesteps, 1, H) grid is read
// through the one slot a*H + c of each time tap a, by every query of
// timestep s + (cf - a)*df, its H columns alike: K*H pairs (query, slot),
// again Kn of them, but H to a slot. A pair exists when its query lies inside
// the grid on each axis (checked per axis: a flat index would wrap across
// rows) and before the sequence end t (which the queries of a ragged last
// timestep pass or fail one by one); the key, below t, is then a valid
// neighbour of it. Each block lists its key's pairs' queries in shared
// memory and sums the pairs in that one fixed order; a pair's slot is
// arithmetic (`reader_slot`), not a second table, which would put a shared
// load behind each pair's validity branch.
//
// What bounds it on the card: memory. Per key and head it does 4 * Kn * d
// operations, while the bytes the function must move are one row each of q,
// g, dk and dv and the Kn + 1 fp32 values of dS and mix of one query: at the
// training shape (bf16, d = 64) about 880 bytes and 11,500 operations, 13
// operations per byte. Each key gathers up to Kn rows of q and g; one block per
// (key token, batch element) holds all h heads, one warp per head, lanes
// striding the head dim; the query rows shared by neighbouring keys come from
// L1/L2. Each key's sums are its own, so no atomics are needed, dk and dv
// are written once, and every output is the same bit for bit on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// grid (t, b), block 32 * heads: warp w handles head w of one key token.
template <typename T>
__global__ void __launch_bounds__(1024) sparse3dna_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ gout, const float* __restrict__ ds,
    const float* __restrict__ mix, T* __restrict__ dk, T* __restrict__ dv, int heads, int d,
    Geometry g) {
  extern __shared__ int s_q[];  // (kn) the query of this key's pair p, or -1
  const int kn = g.kf * g.kh * g.kw;
  const int slots = kn + 1;
  const int key = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int hw = g.fh * g.fw;
  const int f = key / hw, y = (key % hw) / g.fw, xx = key % g.fw;
  for (int p = threadIdx.x; p < kn; p += blockDim.x) s_q[p] = reader(g, f, y, xx, p);
  __syncthreads();

  const int h = warp;
  const size_t row = static_cast<size_t>(bi) * heads + h;  // (b, h) plane
  const T* qplane = q + row * g.t * d;
  const T* gplane = gout + row * g.t * d;
  const float* dsplane = ds + row * g.t * slots;
  const float* mixplane = mix + row * g.t * slots;

  float ak[kMaxR], av[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) ak[r] = av[r] = 0.f;
  for (int tap = 0; tap < kn; tap += g.kw) {  // pair p = tap + c
    for (int c = 0; c < g.kw; ++c) {
      const int tok = s_q[tap + c];  // uniform across the warp
      if (tok < 0) continue;
      const size_t s = static_cast<size_t>(tok) * slots + 1 + reader_slot(g, xx, tap, c);
      const float wk = dsplane[s], wv = mixplane[s];
      const T* qr = qplane + static_cast<size_t>(tok) * d;
      const T* gr = gplane + static_cast<size_t>(tok) * d;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        if (e < d) {
          ak[r] += wk * to_f(qr[e]);
          av[r] += wv * to_f(gr[e]);
        }
      }
    }
  }
  const size_t off = (row * g.t + key) * d;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) {
      dk[off + e] = from_f<T>(ak[r]);
      dv[off + e] = from_f<T>(av[r]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* gout, const float* ds, const float* mix, void* dk,
           void* dv, int b, int heads, int d, Geometry g, cudaStream_t stream) {
  const int kn = g.kf * g.kh * g.kw;
  const size_t smem = sizeof(int) * kn;
  const dim3 grid(g.t, b);
  const dim3 block(32 * heads);
  sparse3dna_bwd_kv_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(gout), ds, mix, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, gout, dk, dv
// (b, heads, t, d); ds, mix (b, heads, t, kn + 1) fp32, slot 0 being bos;
// mode 1 for causal windows, 0 for centered, 2 for the audio geometry
// (fh = kh = 1, kw = fw = H).
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse3dna_bwd_kv(int dtype, const void* q, const void* gout, const float* ds,
                           const float* mix, void* dk, void* dv, int b, int heads, int t, int d,
                           int fh, int fw, int kf, int kh, int kw, int df, int dh, int dw,
                           int mode, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, gout, ds, mix, dk, dv, b, heads, d, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, gout, ds, mix, dk, dv, b, heads, d, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
