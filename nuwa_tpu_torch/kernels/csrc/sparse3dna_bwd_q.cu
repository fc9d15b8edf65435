// Sparse3DNA backward, query side (causal, centered or audio, with or
// without attention dropout) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_q_kernel` in nuwa_tpu/kernels/nda_pallas.py
// (reached through `_bwd_q_call`, its pl.pallas_call), and in the audio
// geometry the same kernel and the row-blocked `_rb_bwd_q_kernel` as
// `_audio_core_op` and `_audio_rb_core_op` run them for SparseCausal2DNA.
// Given the forward's inputs, its per-row logsumexp `lse` and the output
// cotangent `g`, it recomputes for every query the probabilities P over bos
// and its Kn dilated neighbours (the forward's windows, by the rule of
// sparse3dna_geometry.cuh: causal, centered, or the audio geometry's whole
// timesteps, where Kn = K*H), and forms, per head a and slot j:
//
//   dA[a, j] = g[a] . v_j[a]                 (cotangent of the mixed probs)
//   dP[b, j] = sum_a th[a, b] * dA[a, j]     (through the talking-heads mix)
//   rho[b]   = sum_j P[b, j] * dP[b, j]
//   dS[b, j] = P[b, j] * (dP[b, j] - rho[b]) (through the softmax)
//   mix[a, j] = sum_b th[a, b] * P[b, j]     (the forward's mixed probs)
//
// With attention dropout the forward weighted the values by the dropped
// mixed probabilities D[a, j] = mix[a, j] * z[a, j], z the keep factor of
// sparse3dna_dropout.cuh (the fp32 scale 1 / keep or 0, the same hash as the
// forward's), so the cotangent of the mix is dA[a, j] * z[a, j]: the kernel
// multiplies dA by z as it forms it, and every term above that reads dA
// (dP, hence rho and dS; dth) follows from the masked cotangent, the
// rel-pos bias cotangent and dk_bos through dS. The mix it writes, and dv_bos
// reads, is D: the probabilities that weighted the values. (The Pallas
// kernels mask dA and the recomputed mix the same way: nda_pallas.py:624,
// :907, :981.) Every value row is still read: skipping those of dropped
// pairs puts a shared-memory test before each value row's load, which
// measured slower on an H100 (dropout cost +14-23% of the time without it,
// against +6-12% reading every row).
//
// It writes dq = sum_j dS[., j] k_j (bos included), and dS and mix as fp32
// (b, h, t, Kn + 1) tensors for the key-side kernel (sparse3dna_bwd_kv.cu),
// which gathers them per key instead of recomputing the scores. It sums over
// all queries dth[a, b] = sum dA[a, j] P[b, j], the rel-pos bias cotangent
// dbias[h, j] = sum dS[h, 1 + j], dk_bos = sum dS[., 0] q and
// dv_bos = sum mix[., 0] g.
//
// The talking-heads mix sits between the softmax and PV, so rho is not the
// usual flash identity rowsum(dO * O): it needs every head's P and dA of a
// query first. As in the forward kernel, one block holds all h heads of a
// query (one warp per head), and the h x (Kn + 1) values meet in shared
// memory.
//
// What bounds it on the card: memory. Per query and head it does about
// 6 * (Kn + 1) * d operations (scores, dA and dq), against one row each of
// q, g, k, v and dq and 2 * (Kn + 1) fp32 values of dS and mix written: at
// the training shape (Kn = 45, d = 64, bf16) about 1,010 bytes and 17,700
// operations a (query, head), 17 operations per byte, far under the ~300 of
// the bf16 tensor cores and near the ~20 of the fp32 cores it runs on. The dS and mix tensors it writes are 15 MB at
// b = 2, h = 8, t = 2559, Kn = 45: smaller than q, k, v and g together
// (21 MB in bf16), and they spare the key side a second pass over the scores.
//
// Reductions across queries: a block takes kQueriesPerBlock consecutive
// queries and sums its share of dth, dk_bos, dv_bos and dbias in shared
// memory and registers, in a fixed order, then writes it to its own slot of
// the fp32 buffer `partial` (b, blocks along t, nsum), nsum = h*h + 2*h*d
// (+ h*Kn with a bias). The wrapper sums the slots over the block axis in
// one fixed-order reduction, so every output is the same, bit for bit, on
// every run: no atomics. At the fmap-32 training shape (b = 2, t = 10,239,
// h = 8, d = 64, Kn = 45) the buffer holds 2 x 2,560 slots of 1,448 floats,
// about 30 MB, against about 145 MB of q, k, v, g (bf16), dS and mix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"

namespace {

constexpr int kMaxR = 8;              // head dim up to 32 * kMaxR = 256
constexpr int kQueriesPerBlock = 4;   // queries whose sums share one slot of `partial`

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

template <typename T>
__device__ __forceinline__ float row_dot(const float (&x)[kMaxR], const T* row, int lane,
                                         int d) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) acc += x[r] * to_f(row[e]);
  }
  return warp_sum(acc);
}

// grid (ceil(t / kQueriesPerBlock), b), block 32 * heads: warp w handles
// head w of each of the block's queries in turn. kDrop: with attention
// dropout (false compiles none of the dropout code).
template <typename T, bool kDrop>
__global__ void __launch_bounds__(1024) sparse3dna_bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    const T* __restrict__ gout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ ds_out, float* __restrict__ mix_out,
    float* __restrict__ partial, int heads, int d, Geometry g, Dropout drop) {
  extern __shared__ float smem[];
  const int kn = g.kf * g.kh * g.kw;
  const int slots = kn + 1;  // slot 0 is bos
  float* s_th = smem;                        // (heads, heads)
  float* s_dth = s_th + heads * heads;       // (heads, heads) this block's sum
  float* s_p = s_dth + heads * heads;        // (heads, slots) probabilities
  float* s_da = s_p + heads * slots;         // (heads, slots) dA
  float* s_ds = s_da + heads * slots;        // (heads, slots) dP, then dS
  float* s_mix = s_ds + heads * slots;       // (heads, slots) mixed probs
  float* s_dbias = s_mix + heads * slots;    // (heads, kn) this block's sum
  float* s_keep = s_dbias + heads * kn;      // (heads, slots) keep factors, with dropout
  int* s_nb = reinterpret_cast<int*>(s_keep + (kDrop ? heads * slots : 0));  // (kn)

  const int bi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp;
  const size_t row = static_cast<size_t>(bi) * heads + h;  // (b, h) plane
  const T* kplane = k + row * g.t * d;
  const T* vplane = v + row * g.t * d;
  const T* kb = kbos + row * d;
  const T* vb = vbos + row * d;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  float* keep = s_keep + h * slots;  // this head's keep factors, with dropout

  for (int x = threadIdx.x; x < heads * heads; x += blockDim.x) {
    s_th[x] = th[x];
    s_dth[x] = 0.f;
  }
  for (int x = threadIdx.x; x < heads * kn; x += blockDim.x) s_dbias[x] = 0.f;

  float dkb[kMaxR], dvb[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) dkb[r] = dvb[r] = 0.f;

  const int hw = g.fh * g.fw;
  for (int qi = 0; qi < kQueriesPerBlock; ++qi) {
    const int i = blockIdx.x * kQueriesPerBlock + qi;
    if (i >= g.t) break;  // uniform across the block
    __syncthreads();      // the previous query is done with s_nb, s_p, s_da
    const int f = i / hw, y = (i % hw) / g.fw, xx = i % g.fw;
    for (int j = threadIdx.x; j < kn; j += blockDim.x) s_nb[j] = neighbour(g, f, y, xx, j);
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
      const float s = row_dot(qr, kb, lane, d);
      const float a = row_dot(gr, vb, lane, d);
      if (lane == 0) {
        p[0] = expf(s - m);
        da[0] = kDrop ? a * keep[0] : a;
      }
    }
    for (int j = 0; j < kn; ++j) {
      const int tok = s_nb[j];  // uniform across the warp
      float pj = 0.f, aj = 0.f;
      if (tok >= 0) {
        const float s = row_dot(qr, kplane + static_cast<size_t>(tok) * d, lane, d) +
                        (bias != nullptr ? bias[h * kn + j] : 0.f);
        pj = expf(s - m);
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
      const float ds = p[j] * (dsr[j] - rho);
      dsr[j] = ds;
      ds_out[soff + j] = ds;
      mix_out[soff + j] = mixr[j];
      if (j > 0) s_dbias[h * kn + j - 1] += ds;  // row h is this warp's own
    }
    // dth[h, b] += sum_j dA[h, j] P[b, j]: lane b, row h is this warp's own
    for (int b2 = lane; b2 < heads; b2 += 32) {
      float acc = 0.f;
      for (int j = 0; j < slots; ++j) acc += da[j] * s_p[b2 * slots + j];
      s_dth[h * heads + b2] += acc;
    }
    __syncwarp();

    // ---- dq = sum_j dS[j] k_j; bos sums -----------------------------------
    float o[kMaxR];
    {
      const float w = dsr[0], wm = mixr[0];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        const int e = lane + 32 * r;
        o[r] = e < d ? w * to_f(kb[e]) : 0.f;
        dkb[r] += w * qr[r];
        dvb[r] += wm * gr[r];
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

  // ---- this block's share of the sums over all queries, in its own slot:
  // [dth (heads, heads) | dk_bos (heads, d) | dv_bos (heads, d) | dbias (heads, kn)]
  const int hh = heads * heads, hd = heads * d;
  const size_t nsum = hh + 2 * hd + (bias != nullptr ? heads * kn : 0);
  float* part = partial + (static_cast<size_t>(bi) * gridDim.x + blockIdx.x) * nsum;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int e = lane + 32 * r;
    if (e < d) {
      part[hh + h * d + e] = dkb[r];
      part[hh + hd + h * d + e] = dvb[r];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < hh; x += blockDim.x) part[x] = s_dth[x];
  if (bias != nullptr) {
    for (int x = threadIdx.x; x < heads * kn; x += blockDim.x) part[hh + 2 * hd + x] = s_dbias[x];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kbos, const void* vbos,
           const float* th, const float* bias, const void* gout, const float* lse, void* dq,
           float* ds, float* mix, float* partial, int b, int heads, int d, Geometry g,
           Dropout drop, cudaStream_t stream) {
  const int kn = g.kf * g.kh * g.kw;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(heads) * heads +
                                       (drop.on ? 5 : 4) * static_cast<size_t>(heads) * (kn + 1) +
                                       static_cast<size_t>(heads) * kn) +
                      sizeof(int) * kn;
  const auto kernel =
      drop.on ? sparse3dna_bwd_q_kernel<T, true> : sparse3dna_bwd_q_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((g.t + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
  const dim3 block(32 * heads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<const T*>(gout), lse, static_cast<T*>(dq), ds, mix, partial, heads, d, g,
      drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, k, v, gout,
// dq (b, heads, t, d); kbos, vbos (b, heads, 1, d); th (heads, heads) fp32;
// bias (heads, kn) fp32 or null; lse (b, heads, t) fp32; ds, mix
// (b, heads, t, kn + 1) fp32; partial (b, ceil(t / 4), nsum) fp32 with
// nsum = heads*heads + 2*heads*d (+ heads*kn with a bias), every slot
// written: per block [dth | dk_bos | dv_bos | dbias] over its 4 queries, for
// the caller to sum over the block axis; mode 1 for causal windows, 0 for
// centered, 2 for the audio geometry (fh = kh = 1, kw = fw = H); drop 1 for
// the forward's attention dropout with its seed, threshold and fp32 scale
// (sparse3dna_dropout.cuh), 0 for none: mix is then the dropped mix.
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse3dna_bwd_q(int dtype, const void* q, const void* k, const void* v,
                          const void* kbos, const void* vbos, const float* th,
                          const float* bias, const void* gout, const float* lse, void* dq,
                          float* ds, float* mix, float* partial, int b, int heads, int t,
                          int d, int fh, int fw, int kf, int kh, int kw, int df, int dh,
                          int dw, int mode, int drop, unsigned int seed, unsigned int thresh,
                          float scale, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Dropout dp{drop, seed, thresh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix, partial, b,
                         heads, d, g, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix,
                                 partial, b, heads, d, g, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
