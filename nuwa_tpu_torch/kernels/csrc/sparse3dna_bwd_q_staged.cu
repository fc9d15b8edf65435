// Sparse3DNA backward, query side (causal, centered or audio, with or
// without attention dropout) for Hopper, sm_90a, with each head's window
// union staged in shared memory.
//
// The same function as sparse3dna_bwd_q.cu, which replaces the TPU kernels
// `_bwd_q_kernel` (nuwa_tpu/kernels/nda_pallas.py, `_bwd_q_call`) and
// `_rb_bwd_q_kernel` (`_rb_bwd_q_call`), with the same outputs: dq, dS and
// the (dropped) mix for the key side, and each tile's sums of dth, dk_bos,
// dv_bos and dbias in its own slot of `partial`, in one fixed order (that
// file says what each is). The wrapper launches this kernel where its plan
// stages (kernels/nda.py, `tile_plan` given a staged tile through the
// `tiles` argument); the rule's own tiles read the rows through L1 with
// sparse3dna_bwd_q.cu.
//
// What the design does (sparse3dna_tile.cuh). A block owns a tile of
// queries of one frame with all heads. Head by head it copies the key rows
// of the tile's window union and the head's bos row into a shared-memory
// buffer with cp.async and scores P, then the value rows and forms dA, a
// ring of p.stage buffers so each copy runs under earlier stages' work;
// the mix and the softmax backward then run over all heads in shared
// memory while the first head's key rows are on their way again, and a
// last pass stages the key rows head by head for dq. Each union row leaves
// L2 once a stage, where the first design read it once for each query
// whose window holds it.
//
// What bounds it on the card: as sparse3dna_fwd_staged.cu says, it measured
// 2-4x slower than reading through L1 on an H100 at every shape of the
// main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx queries of one
// frame with all heads, rows 16-byte aligned. kDrop: with attention dropout
// (false compiles none of the dropout code); kMaxH: at least the heads (8
// or 32), the length of a mixed column.
template <typename T, bool kDrop, int kMaxH>
__global__ void __launch_bounds__(512, 2) sparse3dna_bwd_q_staged_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    const T* __restrict__ gout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ ds_out, float* __restrict__ mix_out,
    float* __restrict__ partial, int heads, int d, Geometry g, Plan p, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.kf * g.kh * g.kw, slots = kn + 1;  // slot 0 is bos
  const TileView tv = tile_view(p);
  const int tq = tv.tq, rows = g.kf * p.uy * p.ux;
  float* s_p = reinterpret_cast<float*>(smem + p.off_s);        // (heads, tq, slots) P
  float* s_a = reinterpret_cast<float*>(smem + p.off_s2);       // (heads, tq, slots) dA, dP, dS
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);          // (tq, kn) union index or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);      // (tq) token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);      // (heads, heads)
  float* s_bias = reinterpret_cast<float*>(smem + p.off_bias);  // (heads, kn), with a bias
  float* s_lse = reinterpret_cast<float*>(smem + p.off_lse);    // (heads, tq)
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);    // dth parts; dq shares
  float* s_mix0 = reinterpret_cast<float*>(smem + p.off_aux);   // (heads, tq) mix of bos
  int* s_utok = reinterpret_cast<int*>(smem + p.off_utok);      // (rows) union tokens
  T* s_buf = reinterpret_cast<T*>(smem + p.off_buf);            // p.stage x (rows + 1, d)
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bplane = static_cast<size_t>(bi) * heads;  // this batch row's first plane

  for (int x = tid; x < heads * heads; x += nt) s_th[x] = th[x];
  if (bias != nullptr) {
    for (int x = tid; x < heads * kn; x += nt) s_bias[x] = bias[x];
  }
  for (int x = tid; x < tq; x += nt) s_qtok[x] = tile_query(g, p, tv, x);
  fill_union(g, p, tv, s_nb, s_utok, tid, nt);
  for (int x = tid; x < heads * tq; x += nt) {
    const int tok = tile_query(g, p, tv, x % tq);
    s_lse[x] = tok >= 0 ? lse[(bplane + x / tq) * g.t + tok] : 0.f;
  }
  __syncthreads();

  // Stages: the key rows of a head, then its value rows, for heads 0..; then
  // the key rows of heads 0.. again for dq.
  const Groups w = split_groups(p.group, tq, tid);
  const size_t buf_elems = static_cast<size_t>(rows + 1) * d, red_floats = tq * w.gpu * d;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  const int hh = heads * heads, hd = heads * d;
  float* part = partial + (static_cast<size_t>(bi) * p.blocks + blockIdx.x) *
                              (hh + 2 * hd + (bias != nullptr ? heads * kn : 0));
  const auto copy_stage = [&](int s) {  // stage s's rows into its buffer, one group
    if (s < 3 * heads) {
      const bool values = s < 2 * heads && (s & 1);
      stage_rows<T>(s_buf + (s % p.stage) * buf_elems, values ? v : k, values ? vbos : kbos,
                    bplane + (s < 2 * heads ? s / 2 : s - 2 * heads), s_utok, rows, g.t, d, tid,
                    nt);
    }
    cp_async_commit();
  };

  for (int s = 0; s < p.stage - 1; ++s) copy_stage(s);
  for (int s = 0; s < 3 * heads; ++s) {
    // stage s is in; stage s - 1's buffer is free for s + ring - 1
    cp_async_wait_ring(p.stage);
    __syncthreads();
    copy_stage(s + p.stage - 1);
    const T* buf = s_buf + (s % p.stage) * buf_elems;
    if (s < 2 * heads) {
      const int a = s / 2;
      if (s % 2 == 0) {  // ---- head a's P from the keys
        dot_stage<T>(w, buf, q, s_nb, s_qtok, bplane + a, tq, kn, rows, g.t, d,
                     [&](int qi, int tok, int j, bool valid, float sc) {
                       s_p[(a * tq + qi) * slots + j] =
                           valid ? expf((j > 0 && bias != nullptr ? sc + s_bias[a * kn + j - 1]
                                                                  : sc) -
                                        s_lse[a * tq + qi])
                                 : 0.f;
                     });
      } else {  // ---- head a's dA from the values
        dot_stage<T>(w, buf, gout, s_nb, s_qtok, bplane + a, tq, kn, rows, g.t, d,
                     [&](int qi, int tok, int j, bool valid, float da) {
                       // the cotangent of the dropped mix: dA times the keep factor
                       s_a[(a * tq + qi) * slots + j] =
                           !valid  ? 0.f
                           : kDrop ? da * keep_factor(drop, row_stream, a, tok,
                                                      union_slot_key(s_nb, s_utok, kn, qi, j))
                                   : da;
                     });
      }
      continue;
    }
    const int a = s - 2 * heads;
    if (a == 0) {
      // ---- dth[a, b] = sum over the tile's queries and slots of
      // dA[a, .] P[b, .]: `parts` threads a pair, each summing every
      // parts-th term, then the parts in order
      const int parts = max(1, nt / hh);
      for (int x = tid; x < hh * parts; x += nt) {
        const int pair = x / parts, pt = x % parts, a2 = pair / heads, b2 = pair % heads;
        float acc = 0.f;
        for (int y = pt; y < tq * slots; y += parts) {
          const int qq = y / slots, j = y % slots;
          if (s_qtok[qq] >= 0)
            acc += s_a[(a2 * tq + qq) * slots + j] * s_p[(b2 * tq + qq) * slots + j];
        }
        s_red[x] = acc;
      }
      __syncthreads();
      for (int pair = tid; pair < hh; pair += nt) {
        float acc = 0.f;
        for (int pt = 0; pt < parts; ++pt) acc += s_red[pair * parts + pt];
        part[pair] = acc;
      }
      // ---- through the mix, column by column: dP[b, j] = sum_a th[a, b]
      // dA[a, j] in place of dA, and the forward's mix[a, j] = sum_b th[a, b]
      // P[b, j] (dropped with dropout) to `mix_out`
      for (int x = tid; x < tq * slots; x += nt) {
        const int qq = x / slots, j = x % slots, tok = s_qtok[qq];
        if (tok < 0) continue;
        float pr[kMaxH], ar[kMaxH];
#pragma unroll
        for (int b2 = 0; b2 < kMaxH; ++b2) {
          pr[b2] = b2 < heads ? s_p[(b2 * tq + qq) * slots + j] : 0.f;
          ar[b2] = b2 < heads ? s_a[(b2 * tq + qq) * slots + j] : 0.f;
        }
        const uint32_t key = kDrop ? union_slot_key(s_nb, s_utok, kn, qq, j) : 0u;
        for (int h2 = 0; h2 < heads; ++h2) {
          float dp = 0.f, mx = 0.f;
#pragma unroll
          for (int b2 = 0; b2 < kMaxH; ++b2) {
            if (b2 < heads) {
              dp += s_th[b2 * heads + h2] * ar[b2];
              mx += s_th[h2 * heads + b2] * pr[b2];
            }
          }
          if (kDrop) mx *= keep_factor(drop, row_stream, h2, tok, key);
          s_a[(h2 * tq + qq) * slots + j] = dp;
          mix_out[((bplane + h2) * g.t + tok) * slots + j] = mx;
          if (j == 0) s_mix0[h2 * tq + qq] = mx;
        }
      }
      __syncthreads();
      // ---- through the softmax, row by row (kRowLanes lanes a row):
      // rho = sum_j P dP, dS = P (dP - rho)
      const int rl = lane % kRowLanes, rows_at_once = nt / kRowLanes;
      const unsigned rmask = group_mask(kRowLanes, lane);
      for (int r = tid / kRowLanes; r < heads * tq; r += rows_at_once) {
        const int tok = s_qtok[r % tq];
        if (tok < 0) continue;  // uniform across the row's lanes
        const float* pr = s_p + r * slots;
        float* dr = s_a + r * slots;
        float rho = 0.f;
        for (int j = rl; j < slots; j += kRowLanes) rho += pr[j] * dr[j];
        rho = row_sum(rho, rmask);
        float* dso = ds_out + ((bplane + r / tq) * g.t + tok) * slots;
        for (int j = rl; j < slots; j += kRowLanes) {
          const float ds = pr[j] * (dr[j] - rho);
          dr[j] = ds;
          dso[j] = ds;
        }
      }
      __syncthreads();
      // ---- this tile's share of the sums over queries, in query order:
      // [dth (heads, heads) | dk_bos (heads, d) | dv_bos (heads, d) | dbias (heads, kn)]
      for (int x = tid; x < hd; x += nt) {
        const int h2 = x / d, e = x % d;
        const size_t base = (bplane + h2) * g.t;
        float dk = 0.f, dv = 0.f;
#pragma unroll 4
        for (int qq = 0; qq < tq; ++qq) {
          const int tok = s_qtok[qq];
          if (tok < 0) continue;
          dk += s_a[(h2 * tq + qq) * slots] * to_f(q[(base + tok) * d + e]);
          dv += s_mix0[h2 * tq + qq] * to_f(gout[(base + tok) * d + e]);
        }
        part[hh + x] = dk;
        part[hh + hd + x] = dv;
      }
      if (bias != nullptr) {
        for (int x = tid; x < heads * kn; x += nt) {
          const int h2 = x / kn, j = x % kn + 1;
          float acc = 0.f;
          for (int qq = 0; qq < tq; ++qq) {
            if (s_qtok[qq] >= 0) acc += s_a[(h2 * tq + qq) * slots + j];
          }
          part[hh + 2 * hd + x] = acc;
        }
      }
    } else if (w.gpu > 1) {  // the last head's dq shares, summed in order
      sum_shares(dq, s_red + ((s - 1) & 1) * red_floats, s_qtok, bplane + a - 1, w.gpu, tq, g.t,
                 d, tid, nt);
    }
    // ---- head a's dq = sum_j dS[j] k_j, kAxpyBatch slots at a time
    axpy_stage<T>(w, buf, s_a + a * tq * slots, dq, s_red + (s & 1) * red_floats, s_nb, s_qtok,
                  bplane + a, tq, kn, rows, g.t, d);
  }
  if (w.gpu > 1) {
    __syncthreads();
    sum_shares(dq, s_red + ((3 * heads - 1) & 1) * red_floats, s_qtok, bplane + heads - 1,
               w.gpu, tq, g.t, d, tid, nt);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kbos, const void* vbos,
           const float* th, const float* bias, const void* gout, const float* lse, void* dq,
           float* ds, float* mix, float* partial, int b, int heads, int d, Geometry g,
           const Plan& p, Dropout drop, cudaStream_t stream) {
  const auto kernel = heads <= 8 ? (drop.on ? sparse3dna_bwd_q_staged_kernel<T, true, 8>
                                             : sparse3dna_bwd_q_staged_kernel<T, false, 8>)
                                 : (drop.on ? sparse3dna_bwd_q_staged_kernel<T, true, 32>
                                            : sparse3dna_bwd_q_staged_kernel<T, false, 32>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<const T*>(gout), lse, static_cast<T*>(dq), ds, mix, partial, heads, d, g, p,
      drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The arguments of nuwa_sparse3dna_bwd_q (sparse3dna_bwd_q.cu); the plan
// must stage (p.stage 2-4) and rows must be 16-byte aligned (p.vec).
int nuwa_sparse3dna_bwd_q_staged(int dtype, const void* q, const void* k, const void* v,
                                 const void* kbos, const void* vbos, const float* th,
                                 const float* bias, const void* gout, const float* lse, void* dq,
                                 float* ds, float* mix, float* partial, int b, int heads, int t,
                                 int d, int fh, int fw, int kf, int kh, int kw, int df, int dh,
                                 int dw, int mode, int drop, unsigned int seed,
                                 unsigned int thresh, float scale, const int* plan,
                                 void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stage < 2 || p.stage > 4 || !p.vec) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix, partial, b,
                         heads, d, g, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix, partial,
                                 b, heads, d, g, p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
