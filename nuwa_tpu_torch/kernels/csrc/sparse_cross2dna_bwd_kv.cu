// SparseCross2DNA backward, key side (with or without attention dropout)
// for Hopper, sm_90a.
//
// With sparse_cross2dna_bwd_q.cu, replaces the fused cross backward
// `_xfused_bwd_kernel` of nuwa_tpu/kernels/nda_pallas.py (launched by
// `_xfused_bwd_call`). For every context key it sums, over the (query, slot)
// pairs that read that key,
//
//   dK = sum dS[query, slot] * q[query]
//   dV = sum A[query, slot] * g[query]
//
// per head, from the fp32 (b, h, t, Fc*k*k + 1) tensors dS and A (the mixed
// probabilities) that the query-side kernel wrote. With attention dropout
// that kernel writes the dropped A, the probabilities that weighted the
// values, and a dS that already carries the mask, so this kernel is the same
// function with or without dropout and takes no dropout argument (the fused
// Pallas backward masks its recomputed mix for dv instead:
// nda_pallas.py:3012). The TPU kernel summed dk
// and dv in VMEM scratch over its sequential chunks of query frames, one
// grid step per batch row; Hopper's blocks run in no order, so each key
// gathers its own sums instead, and no atomics are needed.
//
// The inverse window: the query at spatial position (y', x') of any query
// frame reads, through slot c*k*k + a*k + e, the key at (y' + (a-half)*dil,
// x' + (e-half)*dil) of context frame c, half = (k-1)/2. So the key at
// (y, x) of context frame c is read by the queries at (y - (a-half)*dil,
// x - (e-half)*dil) (the window reflected) of every query frame f, where
// that position lies in the frame and its token f*HW + y'*fmap + x' is
// below t: F*k*k pairs at most, F = ceil(t / HW). A masked key has dS = 0
// and A = 0 in every pair (its probability is 0 in every head), so its dk
// and dv come out 0 without the mask being read here.
//
// What bounds it on the card: memory. Per key and head it does 4*F*k*k*d
// operations against one row each of dk and dv written and, per pair, a row
// each of q and g and two fp32 values read; every query row is read by k*k
// keys of each context frame, from L1/L2. One block per (context key, batch
// row) holds all h heads, one warp per head, lanes striding the head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 8;  // head dim up to 32 * kMaxR = 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Geometry {
  int t;     // video queries (rows of q)
  int lc;    // context tokens: whole frames of fmap * fmap
  int fmap;  // side of a context frame (and of a query frame)
  int k;     // window side, odd
  int dil;   // window step
};

// grid (lc, b), block 32 * heads: warp w handles head w of one context key.
template <typename T>
__global__ void __launch_bounds__(1024) sparse_cross2dna_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ gout, const float* __restrict__ ds,
    const float* __restrict__ mix, T* __restrict__ dk, T* __restrict__ dv, int heads, int d,
    Geometry g) {
  extern __shared__ int s_pos[];  // (k*k) the reading queries' spatial position, or -1
  const int hw = g.fmap * g.fmap;
  const int kk = g.k * g.k;
  const int slots = (g.lc / hw) * kk + 1;
  const int frames = (g.t + hw - 1) / hw;  // query frames
  const int key = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int c = key / hw, y = (key % hw) / g.fmap, xx = key % g.fmap;
  const int half = (g.k - 1) / 2;
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    const int qy = y - (j / g.k - half) * g.dil;
    const int qx = xx - (j % g.k - half) * g.dil;
    s_pos[j] = (qy >= 0 && qy < g.fmap && qx >= 0 && qx < g.fmap) ? qy * g.fmap + qx : -1;
  }
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
  for (int j = 0; j < kk; ++j) {
    const int pos = s_pos[j];  // uniform across the warp
    if (pos < 0) continue;
    const int slot = 1 + c * kk + j;
    for (int f = 0; f < frames; ++f) {
      const int tok = f * hw + pos;
      if (tok >= g.t) break;  // later frames lie further past t
      const size_t s = static_cast<size_t>(tok) * slots + slot;
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
  const size_t off = (row * g.lc + key) * d;
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
  const size_t smem = sizeof(int) * g.k * g.k;
  const dim3 grid(g.lc, b);
  const dim3 block(32 * heads);
  sparse_cross2dna_bwd_kv_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(gout), ds, mix, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, gout
// (b, heads, t, d); ds, mix (b, heads, t, lc / (fmap * fmap) * ksize * ksize
// + 1) fp32, slot 0 being the null key; dk, dv (b, heads, lc, d).
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_bwd_kv(int dtype, const void* q, const void* gout, const float* ds,
                                 const float* mix, void* dk, void* dv, int b, int heads,
                                 int t, int d, int lc, int fmap, int ksize, int dil,
                                 void* stream) {
  const Geometry g{t, lc, fmap, ksize, dil};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, gout, ds, mix, dk, dv, b, heads, d, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, gout, ds, mix, dk, dv, b, heads, d, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
