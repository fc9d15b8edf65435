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
// :907, :981.) Every value row is still read: a test before each value
// row's load, to skip those of dropped pairs, measured slower on an H100.
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
// query first, so a block holds all h heads of its queries and the
// h x (Kn + 1) values of each query meet in shared memory.
//
// What bounds it on the card. Per query and head it does about
// 6 * (Kn + 1) * d operations (scores, dA and dq), against one row each of
// q, g, k, v and dq and 2 * (Kn + 1) fp32 values of dS and mix written: at
// the training shape (Kn = 45, d = 64, bf16) about 1,010 bytes and 17,700
// operations a (query, head), 17 operations per byte, under the ~20 of the
// fp32 cores it runs on, so the byte bound is the least time. The dS and mix
// tensors it writes are 15 MB at b = 2, h = 8, t = 2559, Kn = 45: smaller
// than q, k, v and g together (21 MB in bf16), and they spare the key side
// a second pass over the scores. A first design (one warp a head, one row
// load in flight a warp) ran 26-290x over that bound on an H100: latency.
// This one runs about 16x over it at the training shapes, waiting on the
// 3 * (Kn + 1) key and value rows each (query, head) reads from L2.
//
// What the design does (sparse3dna_tile.cuh, as in sparse3dna_fwd.cu). A
// block owns a tile of queries of one frame with all heads; groups of lanes
// read rows in 16-byte chunks, each serving a (head, query) unit 8 slots
// at a time, straight from global memory with L1 serving the rows
// that overlapping windows share. One pass reads each slot's key and value
// rows for P and dA; the mix and the softmax backward then run over all
// heads in shared memory; a last pass reads the key rows again for dq.
// sparse3dna_bwd_q_staged.cu computes the same function with each head's
// window union staged in shared memory; it measured 2-4x slower on an H100.
//
// Reductions across queries: a block sums its tile's share of dth, dk_bos,
// dv_bos and dbias in one fixed order and writes it to its own slot of the
// fp32 buffer `partial` (b, p.blocks, nsum), nsum = h*h + 2*h*d (+ h*Kn with a
// bias). The wrapper sums the slots over the tile axis in one fixed-order
// reduction, so every output is the same, bit for bit, on every run: no
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx queries of one
// frame with all heads. Group gid of `group` lanes serves units (head,
// query) gid, gid + ngroups, ..., or a share of one unit's slots where there
// are more groups than units. kVec: rows in 16-byte chunks; kDrop: with
// attention dropout (false compiles none of the dropout code); kMaxH: at
// least the heads (8 or 32), the length of a mixed column.
template <typename T, bool kVec, bool kDrop, int kMaxH>
__global__ void __launch_bounds__(512, 2) sparse3dna_bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    const T* __restrict__ gout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ ds_out, float* __restrict__ mix_out,
    float* __restrict__ partial, int heads, int d, Geometry g, Window win, Plan p,
    Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.kf * g.kh * g.kw, slots = kn + 1;  // slot 0 is bos
  const TileView tv = window_view(p, g, win);
  const int tq = tv.tq;
  float* s_p = reinterpret_cast<float*>(smem + p.off_s);        // (heads, tq, slots) P
  float* s_a = reinterpret_cast<float*>(smem + p.off_s2);       // (heads, tq, slots) dA, dP, dS
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);          // (tq, kn) neighbour token or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);      // (tq) token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);      // (heads, heads)
  float* s_bias = reinterpret_cast<float*>(smem + p.off_bias);  // (heads, kn), with a bias
  float* s_lse = reinterpret_cast<float*>(smem + p.off_lse);    // (heads, tq)
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);    // dth parts; dq shares
  float* s_mix0 = reinterpret_cast<float*>(smem + p.off_aux);   // (heads, tq) mix of bos
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bplane = static_cast<size_t>(bi) * heads;  // this batch row's first plane

  for (int x = tid; x < heads * heads; x += nt) s_th[x] = th[x];
  if (bias != nullptr) {
    for (int x = tid; x < heads * kn; x += nt) s_bias[x] = bias[x];
  }
  for (int x = tid; x < tq; x += nt) s_qtok[x] = window_query(g, p, tv, win, x);
  for (int x = tid; x < tq * kn; x += nt) s_nb[x] = tile_neighbour(g, p, tv, x / kn, x % kn);
  for (int x = tid; x < heads * tq; x += nt) {
    const int tok = window_query(g, p, tv, win, x % tq);
    s_lse[x] = tok >= 0 ? lse[window_row(win, bplane + x / tq, tok)] : 0.f;
  }
  __syncthreads();

  const int G = p.group, gid = tid / G, gl = tid % G, ng = nt / G;
  const unsigned gmask = group_mask(G, lane);
  const int units = heads * tq;        // unit a * tq + qi: head a, query qi
  const int gpu = max(1, ng / units);  // groups a unit
  const int ustep = ng / gpu, first = gid / gpu < ustep ? gid / gpu : units, sub = gid % gpu;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  const int hh = heads * heads, hd = heads * d;
  float* part = partial + (static_cast<size_t>(bi) * p.blocks + blockIdx.x) *
                              (hh + 2 * hd + (bias != nullptr ? heads * kn : 0));

  // ---- P (keys) and dA (values) of every unit, kBatch slots at a time -----
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;  // uniform across the group
    const size_t plane = bplane + a;
    float qr[8], gr[8];
    load_row<T, kVec>(qr, q + window_row(win, plane, tok) * d, gl, G, d);
    load_row<T, kVec>(gr, gout + window_row(win, plane, tok) * d, gl, G, d);
    const float m = s_lse[un];
    for (int j0 = sub; j0 < slots; j0 += kBatch * gpu) {
      float sc[kBatch], da[kBatch];  // scores and dA
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i * gpu;
        // the neighbour's token, t for bos, -1 outside the grid or past t
        const int nb = j >= slots ? -1 : j == 0 ? g.t : s_nb[qi * kn + j - 1];
        const size_t row = (plane * g.t + max(nb, 0)) * d;
        const bool valid = nb >= 0, is_bos = nb == g.t;
        sc[i] = valid ? dot_row<T, kVec>(qr, is_bos ? kbos + plane * d : k + row, gl, G, d) : 0.f;
        da[i] = valid ? dot_row<T, kVec>(gr, is_bos ? vbos + plane * d : v + row, gl, G, d) : 0.f;
      }
      const int base = group_sum_spread(sc, G, gl, gmask);
      group_sum_spread(da, G, gl, gmask);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= kBatch / min(G, kBatch)) break;
        const int j = j0 + (base + i) * gpu;
        if (j >= slots) continue;
        const int nb = j == 0 ? g.t : s_nb[qi * kn + j - 1];
        float pj = 0.f, aj = 0.f;
        if (nb >= 0) {
          pj = expf((j > 0 && bias != nullptr ? sc[i] + s_bias[a * kn + j - 1] : sc[i]) - m);
          // the cotangent of the dropped mix: dA times the keep factor (the
          // hash keys the tokens' ids in the whole sequence)
          aj = kDrop ? da[i] * keep_factor(drop, row_stream, a, tok + win.tok0,
                                           j == 0 ? kBosKey
                                                  : static_cast<uint32_t>(nb + win.tok0))
                     : da[i];
        }
        s_p[un * slots + j] = pj;
        s_a[un * slots + j] = aj;
      }
    }
  }
  __syncthreads();

  // ---- dth[a, b] = sum over the tile's queries and slots of dA[a, .] P[b, .]:
  // `parts` threads a pair, each summing every parts-th term, then the parts
  // in order
  const int parts = max(1, nt / hh);
  for (int w = tid; w < hh * parts; w += nt) {
    const int pair = w / parts, pt = w % parts, a2 = pair / heads, b2 = pair % heads;
    float acc = 0.f;
    for (int x = pt; x < tq * slots; x += parts) {
      const int qq = x / slots, j = x % slots;
      if (s_qtok[qq] >= 0) acc += s_a[(a2 * tq + qq) * slots + j] * s_p[(b2 * tq + qq) * slots + j];
    }
    s_red[w] = acc;
  }
  __syncthreads();
  for (int pair = tid; pair < hh; pair += nt) {
    float acc = 0.f;
    for (int pt = 0; pt < parts; ++pt) acc += s_red[pair * parts + pt];
    part[pair] = acc;
  }
  // ---- through the mix, column by column: dP[b, j] = sum_a th[a, b] dA[a, j]
  // in place of dA, and the forward's mix[a, j] = sum_b th[a, b] P[b, j]
  // (dropped with dropout) to `mix_out`
  for (int x = tid; x < tq * slots; x += nt) {
    const int qq = x / slots, j = x % slots, tok = s_qtok[qq];
    if (tok < 0) continue;
    float pr[kMaxH], ar[kMaxH];
#pragma unroll
    for (int b2 = 0; b2 < kMaxH; ++b2) {
      pr[b2] = b2 < heads ? s_p[(b2 * tq + qq) * slots + j] : 0.f;
      ar[b2] = b2 < heads ? s_a[(b2 * tq + qq) * slots + j] : 0.f;
    }
    // a slot outside the grid has P and dA 0 in every head: its key is moot
    const uint32_t key =
        j == 0 ? kBosKey : static_cast<uint32_t>(s_nb[qq * kn + j - 1] + win.tok0);
    for (int h2 = 0; h2 < heads; ++h2) {
      float dp = 0.f, mx = 0.f;
#pragma unroll
      for (int b2 = 0; b2 < kMaxH; ++b2) {
        if (b2 < heads) {
          dp += s_th[b2 * heads + h2] * ar[b2];
          mx += s_th[h2 * heads + b2] * pr[b2];
        }
      }
      if (kDrop) mx *= keep_factor(drop, row_stream, h2, tok + win.tok0, key);
      s_a[(h2 * tq + qq) * slots + j] = dp;
      mix_out[window_row(win, bplane + h2, tok) * slots + j] = mx;
      if (j == 0) s_mix0[h2 * tq + qq] = mx;
    }
  }
  __syncthreads();
  // ---- through the softmax, row by row (kRowLanes lanes a row):
  // rho = sum_j P dP, dS = P (dP - rho)
  const int rl = lane % kRowLanes, rows_at_once = nt / kRowLanes;
  const unsigned rmask = group_mask(kRowLanes, lane);
  for (int r = tid / kRowLanes; r < units; r += rows_at_once) {
    const int tok = s_qtok[r % tq];
    if (tok < 0) continue;  // uniform across the row's lanes
    const float* pr = s_p + r * slots;
    float* dr = s_a + r * slots;
    float rho = 0.f;
    for (int j = rl; j < slots; j += kRowLanes) rho += pr[j] * dr[j];
    rho = row_sum(rho, rmask);
    float* dso = ds_out + window_row(win, bplane + r / tq, tok) * slots;
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
    float dk = 0.f, dv = 0.f;
#pragma unroll 4
    for (int qq = 0; qq < tq; ++qq) {
      const int tok = s_qtok[qq];
      if (tok < 0) continue;
      const size_t row = window_row(win, bplane + h2, tok);
      dk += s_a[(h2 * tq + qq) * slots] * to_f(q[row * d + e]);
      dv += s_mix0[h2 * tq + qq] * to_f(gout[row * d + e]);
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

  // ---- dq = sum_j dS[j] k_j of every unit, kAxpyBatch slots at a time -----
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;
    const size_t plane = bplane + a;
    const float* dsr = s_a + un * slots;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
    for (int j0 = sub; j0 < slots; j0 += kAxpyBatch * gpu) {
      float w[kAxpyBatch];
      int nbs[kAxpyBatch];
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int j = j0 + i * gpu;
        nbs[i] = j >= slots ? -1 : j == 0 ? g.t : s_nb[qi * kn + j - 1];
        w[i] = nbs[i] < 0 ? 0.f : dsr[j];  // a slot outside the grid: dS 0 in every head
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int nb = nbs[i];
        if (nb >= 0)
          axpy_row<T, kVec>(o, w[i], nb == g.t ? kbos + plane * d : k + (plane * g.t + nb) * d,
                            gl, G, d);
      }
    }
    if (gpu == 1) {
      store_row<T, kVec>(dq + window_row(win, plane, tok) * d, o, gl, G, d);
    } else {
      share_row<T, kVec>(s_red, un * gpu + sub, o, gl, G, d);
    }
  }
  if (gpu > 1) {
    // the groups that share a unit sum their shares in order
    __syncthreads();
    for (int x = tid; x < units * d; x += nt) {
      const int un = x / d, e = x % d, tok = s_qtok[un % tq];
      if (tok < 0) continue;
      float sum = 0.f;
      for (int sb = 0; sb < gpu; ++sb) sum += s_red[(un * gpu + sb) * d + e];
      dq[window_row(win, bplane + un / tq, tok) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* kbos, const void* vbos,
           const float* th, const float* bias, const void* gout, const float* lse, void* dq,
           float* ds, float* mix, float* partial, int b, int heads, int d, Geometry g,
           Window win, const Plan& p, Dropout drop, cudaStream_t stream) {
  const auto kernel = heads <= 8 ? (drop.on ? sparse3dna_bwd_q_kernel<T, kVec, true, 8>
                                             : sparse3dna_bwd_q_kernel<T, kVec, false, 8>)
                                 : (drop.on ? sparse3dna_bwd_q_kernel<T, kVec, true, 32>
                                            : sparse3dna_bwd_q_kernel<T, kVec, false, 32>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<const T*>(gout), lse, static_cast<T*>(dq), ds, mix, partial, heads, d, g, win,
      p, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: k, v
// (b, heads, t, d); q, gout, dq (b, heads, nq, d), the queries of the window
// [q_lo, q_hi) with nq = q_hi - q_lo (sparse3dna_geometry.cuh: `Window`, tok0
// the id of key token 0 in the whole sequence; the whole sequence is 0, t,
// 0); kbos, vbos (b, heads, 1, d); th (heads, heads) fp32; bias (heads, kn)
// fp32 or null; lse (b, heads, nq) fp32; ds, mix (b, heads, nq, kn + 1) fp32;
// partial (b, plan blocks, nsum) fp32 with
// nsum = heads*heads + 2*heads*d (+ heads*kn with a bias), every slot
// written: per tile [dth | dk_bos | dv_bos | dbias] over its queries, for
// the caller to sum over the tile axis; mode 1 for causal windows, 0 for
// centered, 2 for the audio geometry (fh = kh = 1, kw = fw = H); drop 1 for
// the forward's attention dropout with its seed, threshold and fp32 scale
// (sparse3dna_dropout.cuh), 0 for none: mix is then the dropped mix; plan:
// kPlanInts ints, the wrapper's tile and shared-memory layout
// (sparse3dna_tile.cuh). Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse3dna_bwd_q(int dtype, const void* q, const void* k, const void* v,
                          const void* kbos, const void* vbos, const float* th,
                          const float* bias, const void* gout, const float* lse, void* dq,
                          float* ds, float* mix, float* partial, int b, int heads, int t,
                          int d, int fh, int fw, int kf, int kh, int kw, int df, int dh,
                          int dw, int mode, int q_lo, int q_hi, int tok0, int drop,
                          unsigned int seed, unsigned int thresh, float scale, const int* plan,
                          void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Window win{q_lo, q_hi, tok0};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix, partial,
                               b, heads, d, g, win, p, dp, s);
  if (dtype == 0)
    return launch<float, false>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix, partial,
                                b, heads, d, g, win, p, dp, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix,
                                       partial, b, heads, d, g, win, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, kbos, vbos, th, bias, gout, lse, dq, ds, mix,
                                        partial, b, heads, d, g, win, p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
