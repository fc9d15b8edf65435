// SparseCross2DNA backward, query side (with or without attention dropout)
// for Hopper, sm_90a.
//
// With sparse_cross2dna_bwd_kv.cu, replaces the fused cross backward
// `_xfused_bwd_kernel` of nuwa_tpu/kernels/nda_pallas.py (launched by
// `_xfused_bwd_call`), and with it the backward of the per-frame fallback
// `_cross_core_op` (kernels `_bwd_q_kernel` and `_bwd_kv_kernel` in
// fixed-taps mode). Given the forward's inputs (sparse_cross2dna_fwd.cu), its
// per-row logsumexp `lse` and the output cotangent `g`, it recomputes for
// every video query the probabilities P over the null key and its Fc*k*k
// window slots (the centered k x k window around the query's spatial
// position in every context frame, where the frame and the context mask
// allow it), and forms, per head a and slot j:
//
//   dA[a, j] = g[a] . v_j[a]                 (cotangent of the mixed probs)
//   dP[b, j] = sum_a th[a, b] * dA[a, j]     (through the talking-heads mix)
//   rho[b]   = sum_j P[b, j] * dP[b, j]
//   dS[b, j] = P[b, j] * (dP[b, j] - rho[b]) (through the softmax)
//   A[a, j]  = sum_b th[a, b] * P[b, j]      (the forward's mixed probs)
//
// With attention dropout the forward weighted the values by the dropped
// mixed probabilities D[a, j] = A[a, j] * z[a, j], z the keep factor of
// sparse3dna_dropout.cuh (the fp32 scale 1 / keep or 0, keyed by the seed,
// the batch row, the head, the absolute query and the context token, the
// null column's key -2), so the cotangent of the mix is dA[a, j] * z[a, j]:
// the kernel multiplies dA by z as it forms it, and every term above that
// reads dA (dP, hence rho and dS; dth) follows, dq and the null-key
// cotangent through dS. The A it writes, and dnull_v and the key side's dv
// read, is D: the probabilities that weighted the values. (The Pallas
// kernel masks dA and the recomputed mix the same way, nda_pallas.py:2983,
// :2994, :3012, :3026, with the query ids of each chunk offset by its first
// row.)
//
// It writes dq = sum_j dS[., j] k_j (null included), and dS and A as fp32
// (b, h, t, Fc*k*k + 1) tensors for the key-side kernel, which gathers them
// per context key. A masked or out-of-frame slot has P = 0 in every head,
// so its dS and A are exactly 0: a row whose context is all masked (the
// unconditional half of a CFG batch, condition dropout) sends gradient only
// to q, the null key and value and the talking heads. It sums per batch row
// dnull_k = sum_i dS[i, 0] q_i and dnull_v = sum_i A[i, 0] g_i (the null
// rows are expanded per batch row before the op, so their reduction to the
// parameter is autograd's), and over everything dth[a, b] = sum dA[a, j] P[b, j].
//
// The TPU kernel ran one grid step per batch row, scored each chunk of
// query frames against whole context frames with dense HW x HW tiles, kept
// every tap's P, dA and dP live in VMEM to share one pass, and summed dk and
// dv in VMEM scratch across its sequential chunks. Blocks on Hopper run in
// no order, so the work splits as the Sparse3DNA backward's does
// (sparse3dna_bwd_q.cu, sparse3dna_bwd_kv.cu): this kernel is the query
// side, one block per (kQueriesPerBlock queries, batch row), one warp per
// head (the talking-heads mix couples the heads, so every head's P and dA
// meet in shared memory before any dS); the key side gathers dS and A per
// key with no atomics.
//
// What bounds it on the card: memory. Per query and head it does about
// 6 * (Fc*k*k + 1) * d operations (scores, dA and dq) against one row each
// of q, g and dq and 2 * (Fc*k*k + 1) fp32 values of dS and A written; the
// context's k and v rows are read by every query frame through L1/L2. The
// sums over queries (dnull_k, dnull_v per batch row, dth) are summed per
// block in registers and shared memory, in a fixed order, and written to
// the block's own slot of the fp32 buffer `partial` (b, blocks along t,
// h*h + 2*h*d); the wrapper sums the slots over the block axis in one
// fixed-order reduction, so every output is the same, bit for bit, on every
// run: no atomics. At the sketch training shape (b = 2, t = 2,559, h = 8,
// d = 64) the buffer holds 2 x 640 slots of 1,088 floats, 5.6 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse3dna_dropout.cuh"

namespace {

constexpr int kMaxR = 8;             // head dim up to 32 * kMaxR = 256
constexpr int kQueriesPerBlock = 4;  // queries whose sums share one slot of `partial`

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

struct Geometry {
  int t;     // video queries (rows of q)
  int lc;    // context tokens: whole frames of fmap * fmap
  int fmap;  // side of a context frame (and of a query frame)
  int k;     // window side, odd
  int dil;   // window step
};

template <typename T>
__device__ __forceinline__ float row_dot(const float (&x)[kMaxR], const T* row, int lane,
                                         int d) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) acc = fmaf(x[r], to_f(row[e]), acc);  // as the forward kernel's scores
  }
  return warp_sum(acc);
}

// grid (ceil(t / kQueriesPerBlock), b), block 32 * heads: warp w handles
// head w of each of the block's queries in turn. kDrop: with attention
// dropout (false compiles none of the dropout code).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(1024) sparse_cross2dna_bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ null_k, const T* __restrict__ null_v,
    const float* __restrict__ th, const unsigned char* __restrict__ cmask,
    const T* __restrict__ gout, const float* __restrict__ lse, T* __restrict__ dq,
    float* __restrict__ ds_out, float* __restrict__ mix_out, float* __restrict__ partial,
    int heads, int d, Geometry g, Dropout drop) {
  extern __shared__ float smem[];
  const int hw = g.fmap * g.fmap;
  const int kk = g.k * g.k;
  const int kn = (g.lc / hw) * kk;  // window keys over all context frames
  const int slots = kn + 1;         // slot 0 is the null key
  float* s_th = smem;                        // (heads, heads)
  float* s_dth = s_th + heads * heads;       // (heads, heads) this block's sum
  float* s_p = s_dth + heads * heads;        // (heads, slots) probabilities
  float* s_da = s_p + heads * slots;         // (heads, slots) dA
  float* s_ds = s_da + heads * slots;        // (heads, slots) dP, then dS
  float* s_mix = s_ds + heads * slots;       // (heads, slots) mixed probs
  float* s_keep = s_mix + heads * slots;     // (heads, slots) keep factors, with dropout
  int* s_nb = reinterpret_cast<int*>(s_keep + (kDrop ? heads * slots : 0));  // (kn)

  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp;
  const size_t row = static_cast<size_t>(bi) * heads + h;  // (b, h) plane
  const T* kplane = k + row * g.lc * d;
  const T* vplane = v + row * g.lc * d;
  const T* nk = null_k + row * d;
  const T* nv = null_v + row * d;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  float* keep = s_keep + h * slots;  // this head's keep factors, with dropout

  for (int x = threadIdx.x; x < heads * heads; x += blockDim.x) {
    s_th[x] = th[x];
    s_dth[x] = 0.f;
  }

  float dnk[kMaxR], dnv[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) dnk[r] = dnv[r] = 0.f;

  const int half = (g.k - 1) / 2;
  for (int qi = 0; qi < kQueriesPerBlock; ++qi) {
    const int i = blockIdx.x * kQueriesPerBlock + qi;
    if (i >= g.t) break;  // uniform across the block
    __syncthreads();      // the previous query is done with s_nb, s_p, s_da
    const int s = i % hw, y = s / g.fmap, xx = s % g.fmap;
    for (int j = threadIdx.x; j < kn; j += blockDim.x) {
      // as the forward kernel: slot j is context frame j / kk, window
      // position j % kk row-major
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

    const size_t qoff = (row * g.t + i) * d;
    float qr[kMaxR], gr[kMaxR];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      qr[r] = e < d ? to_f(q[qoff + e]) : 0.f;
      gr[r] = e < d ? to_f(gout[qoff + e]) : 0.f;
    }
    const float m = lse[row * g.t + i];
    if (kDrop) {
      for (int j = lane; j < slots; j += 32)
        keep[j] = keep_factor(drop, row_stream, h, i, slot_key(s_nb, j));
      __syncwarp();
    }

    // ---- P and dA of this head, one warp-wide dot product each ----------
    float* p = s_p + h * slots;
    float* da = s_da + h * slots;
    {
      const float sc = row_dot(qr, nk, lane, d);
      const float a = row_dot(gr, nv, lane, d);
      if (lane == 0) {
        p[0] = expf(sc - m);
        da[0] = kDrop ? a * keep[0] : a;
      }
    }
    for (int j = 0; j < kn; ++j) {
      const int tok = s_nb[j];  // uniform across the warp
      float pj = 0.f, aj = 0.f;
      if (tok >= 0) {
        pj = expf(row_dot(qr, kplane + static_cast<size_t>(tok) * d, lane, d) - m);
        aj = row_dot(gr, vplane + static_cast<size_t>(tok) * d, lane, d);
      }
      if (lane == 0) {
        p[1 + j] = pj;
        da[1 + j] = kDrop ? aj * keep[1 + j] : aj;
      }
    }
    __syncthreads();  // every head's P and dA

    // ---- through the mix and the softmax --------------------------------
    float* dsr = s_ds + h * slots;
    float* mixr = s_mix + h * slots;
    float rho = 0.f;
    for (int j = lane; j < slots; j += 32) {
      float dp = 0.f, mx = 0.f;
      for (int a = 0; a < heads; ++a) {
        dp += s_th[a * heads + h] * s_da[a * slots + j];
        mx += s_th[h * heads + a] * s_p[a * slots + j];
      }
      dsr[j] = dp;
      mixr[j] = kDrop ? mx * keep[j] : mx;
      rho += p[j] * dp;
    }
    rho = warp_sum(rho);
    const size_t soff = (row * g.t + i) * slots;
    for (int j = lane; j < slots; j += 32) {
      const float dsj = p[j] * (dsr[j] - rho);
      dsr[j] = dsj;
      ds_out[soff + j] = dsj;
      mix_out[soff + j] = mixr[j];
    }
    // dth[h, b] += sum_j dA[h, j] P[b, j]: lane b, row h is this warp's own
    for (int b2 = lane; b2 < heads; b2 += 32) {
      float acc = 0.f;
      for (int j = 0; j < slots; ++j) acc += da[j] * s_p[b2 * slots + j];
      s_dth[h * heads + b2] += acc;
    }
    __syncwarp();

    // ---- dq = sum_j dS[j] k_j; the null rows' sums ------------------------
    float o[kMaxR];
    {
      const float w = dsr[0], wm = mixr[0];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        o[r] = e < d ? w * to_f(nk[e]) : 0.f;
        dnk[r] += w * qr[r];
        dnv[r] += wm * gr[r];
      }
    }
    for (int j = 0; j < kn; ++j) {
      const int tok = s_nb[j];
      if (tok < 0) continue;  // its dS is 0 in every head
      const float w = dsr[1 + j];
      const T* kr = kplane + static_cast<size_t>(tok) * d;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        if (e < d) o[r] += w * to_f(kr[e]);
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int e = lane + 32 * r;
      if (e < d) dq[qoff + e] = from_f<T>(o[r]);
    }
  }

  // ---- this block's share of the sums over queries, in its own slot:
  // [dth (heads, heads) | dnull_k (heads, d) | dnull_v (heads, d)]
  const int hh = heads * heads, hd = heads * d;
  float* part = partial + (static_cast<size_t>(bi) * gridDim.x + blockIdx.x) * (hh + 2 * hd);
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) {
      part[hh + h * d + e] = dnk[r];
      part[hh + hd + h * d + e] = dnv[r];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < hh; x += blockDim.x) part[x] = s_dth[x];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* null_k,
           const void* null_v, const float* th, const unsigned char* cmask, const void* gout,
           const float* lse, void* dq, float* ds, float* mix, float* partial, int b,
           int heads, int d, Geometry g, Dropout drop, cudaStream_t stream) {
  const int kn = (g.lc / (g.fmap * g.fmap)) * g.k * g.k;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(heads) * heads +
                       (drop.on ? 5 : 4) * static_cast<size_t>(heads) * (kn + 1)) +
      sizeof(int) * kn;
  const auto kernel = drop.on ? sparse_cross2dna_bwd_q_kernel<T, true>
                              : sparse_cross2dna_bwd_q_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((g.t + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
  const dim3 block(32 * heads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(null_k), static_cast<const T*>(null_v), th, cmask,
      static_cast<const T*>(gout), lse, static_cast<T*>(dq), ds, mix, partial, heads, d, g,
      drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, gout, dq
// (b, heads, t, d); k, v (b, heads, lc, d); null_k, null_v (b, heads, 1, d);
// th (heads, heads) fp32; cmask (b, lc) bytes, nonzero where a context token
// may be attended, or null for all; lse (b, heads, t) fp32; ds, mix
// (b, heads, t, lc / (fmap * fmap) * ksize * ksize + 1) fp32; partial
// (b, ceil(t / 4), heads*heads + 2*heads*d) fp32, every slot written: per
// block [dth | dnull_k | dnull_v] over its 4 queries, for the caller to sum
// over the block axis; drop 1 for the forward's attention dropout with its
// seed, threshold and fp32 scale (sparse3dna_dropout.cuh), 0 for none: mix
// is then the dropped mix.
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_bwd_q(int dtype, const void* q, const void* k, const void* v,
                                const void* null_k, const void* null_v, const float* th,
                                const unsigned char* cmask, const void* gout,
                                const float* lse, void* dq, float* ds, float* mix,
                                float* partial, int b, int heads, int t, int d, int lc,
                                int fmap, int ksize, int dil, int drop, unsigned int seed,
                                unsigned int thresh, float scale, void* stream) {
  const Geometry g{t, lc, fmap, ksize, dil};
  const Dropout dp{drop, seed, thresh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds, mix, partial,
                         b, heads, d, g, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds, mix,
                                 partial, b, heads, d, g, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
