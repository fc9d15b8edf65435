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
// so its dS and A are exactly 0. A row whose context is all masked (the
// unconditional half of a CFG batch, condition dropout) has the null column
// alone, whose softmax the forward gives as exactly 1 (lse is then the null
// score itself); this kernel sets P = 1 there rather than recomputing
// exp(score - lse) with its sums in another order than the forward's, so
// dS = 0 exactly and such a row sends gradient only to q, the null key and
// value and the talking heads. It sums per batch row
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
// side; the key side gathers dS and A per key with no atomics.
//
// What bounds it on the card: memory. Per query and head it does about
// 6 * (Fc*k*k + 1) * d operations (scores, dA and dq) against one row each
// of q, g and dq and 2 * (Fc*k*k + 1) fp32 values of dS and A written; the
// context's k and v rows are read by every query frame through L1/L2. A
// first design (a block of 4 queries taken one after another, one warp a
// head, each slot's two dot products one after the other with a 2-byte load
// a lane, the dq pass reading the key rows again one at a time) ran 23-31x
// over that bound on an H100: latency.
//
// What the design does (sparse3dna_tile.cuh, as sparse3dna_bwd_q.cu's). A
// block owns a tile of ty x tx query positions of one video frame with all
// heads (the wrapper's plan: kernels.nda `tile_plan` with which =
// "cross_bwd_q", the window (Fc, k, k) and the candidates of kernels.cross
// `TILES`, 2 x 4 first); groups of lanes read rows in 16-byte chunks, each
// serving a (head, query) unit kBatch slots at a time, forming q . k and
// g . v of a slot from the same batch, straight from global memory:
// neighbouring queries' centered windows overlap in every context frame (a
// 2 x 4 tile at dilation 1 reads 24 context positions a frame for its 72
// pair reads, and every query frame reads the same ones), and L1 serves the
// rows they share. The mix and the softmax backward then run over all heads
// in shared memory; a last pass weights kAxpyBatch key rows at a time for
// dq. It runs about 12x over the byte bound at the sketch training shape
// on an H100; what holds it there is not profiled (each tile's five
// barriers and its mix pass, one (query, slot) column a thread over few
// slots, Fc * 9 + 1, are fixed costs that few rows a unit do not amortise).
//
// Reductions across queries: a block sums its tile's share of dth,
// dnull_k and dnull_v in one fixed order and writes it to its own slot of
// the fp32 buffer `partial` (b, p.blocks, h*h + 2*h*d). The wrapper sums the
// slots over the block axis in one fixed-order reduction, so every output
// is the same, bit for bit, on every run: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"
#include "sparse_cross2dna_geometry.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx query
// positions of one video frame with all heads. Group gid of `group` lanes
// serves units (head, query) gid, gid + ngroups, ..., or a share of one
// unit's slots where there are more groups than units. kVec: rows in
// 16-byte chunks; kDrop: with attention dropout (false compiles none of the
// dropout code); kMaxH: at least the heads (8 or 32), the length of a mixed
// column.
template <typename T, bool kVec, bool kDrop, int kMaxH>
__global__ void __launch_bounds__(512, 2) sparse_cross2dna_bwd_q_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ null_k, const T* __restrict__ null_v,
    const float* __restrict__ th, const unsigned char* __restrict__ cmask,
    const T* __restrict__ gout, const float* __restrict__ lse, T* __restrict__ dq,
    float* __restrict__ ds_out, float* __restrict__ mix_out, float* __restrict__ partial,
    int heads, int d, CrossGeometry g, Plan p, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.lc / (g.fmap * g.fmap) * g.k * g.k, slots = kn + 1;  // slot 0 is null
  const Geometry vg{g.t, g.fmap, g.fmap, 1, 1, 1, 1, 1, 1, kCentered};  // the query frames
  const TileView tv = tile_view(p);
  const int tq = tv.tq;
  float* s_p = reinterpret_cast<float*>(smem + p.off_s);        // (heads, tq, slots) P
  float* s_a = reinterpret_cast<float*>(smem + p.off_s2);       // (heads, tq, slots) dA, dP, dS
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);          // (tq, kn) context token or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);      // (tq) token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);      // (heads, heads)
  float* s_lse = reinterpret_cast<float*>(smem + p.off_lse);    // (heads, tq)
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);    // dth parts; dq shares
  float* s_mix0 = reinterpret_cast<float*>(smem + p.off_aux);   // (heads, tq) mix of null
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bplane = static_cast<size_t>(bi) * heads;  // this batch row's first plane
  const unsigned char* mrow = cmask != nullptr ? cmask + static_cast<size_t>(bi) * g.lc : nullptr;

  for (int x = tid; x < heads * heads; x += nt) s_th[x] = th[x];
  for (int x = tid; x < tq; x += nt) s_qtok[x] = tile_query(vg, p, tv, x);
  for (int x = tid; x < tq * kn; x += nt) {
    const int qi = x / kn;
    s_nb[x] = cross_neighbour(g, mrow, tv.y0 + qi / p.tx, tv.x0 + qi % p.tx, x % kn);
  }
  for (int x = tid; x < heads * tq; x += nt) {
    const int tok = tile_query(vg, p, tv, x % tq);
    s_lse[x] = tok >= 0 ? lse[(bplane + x / tq) * g.t + tok] : 0.f;
  }
  __syncthreads();

  const int G = p.group, gid = tid / G, gl = tid % G, ng = nt / G;
  const unsigned gmask = group_mask(G, lane);
  const int units = heads * tq;        // unit a * tq + qi: head a, query qi
  const int gpu = max(1, ng / units);  // groups a unit
  const int ustep = ng / gpu, first = gid / gpu < ustep ? gid / gpu : units, sub = gid % gpu;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  const int hh = heads * heads, hd = heads * d;
  float* part = partial + (static_cast<size_t>(bi) * p.blocks + blockIdx.x) * (hh + 2 * hd);

  // ---- P (keys) and dA (values) of every unit, kBatch slots at a time -----
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;  // uniform across the group
    const size_t plane = bplane + a;
    float qr[8], gr[8];
    load_row<T, kVec>(qr, q + (plane * g.t + tok) * d, gl, G, d);
    load_row<T, kVec>(gr, gout + (plane * g.t + tok) * d, gl, G, d);
    const float m = s_lse[un];
    for (int j0 = sub; j0 < slots; j0 += kBatch * gpu) {
      float sc[kBatch], da[kBatch];  // scores and dA
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i * gpu;
        // the context token, lc for the null column, -1 masked or outside
        const int nb = j >= slots ? -1 : j == 0 ? g.lc : s_nb[qi * kn + j - 1];
        const size_t row = (plane * g.lc + max(nb, 0)) * d;
        const bool valid = nb >= 0, is_null = nb == g.lc;
        sc[i] = valid ? dot_row<T, kVec>(qr, is_null ? null_k + plane * d : k + row, gl, G, d)
                      : 0.f;
        da[i] = valid ? dot_row<T, kVec>(gr, is_null ? null_v + plane * d : v + row, gl, G, d)
                      : 0.f;
      }
      const int base = group_sum_spread(sc, G, gl, gmask);
      group_sum_spread(da, G, gl, gmask);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= kBatch / min(G, kBatch)) break;
        const int j = j0 + (base + i) * gpu;
        if (j >= slots) continue;
        const int nb = j == 0 ? g.lc : s_nb[qi * kn + j - 1];
        float pj = 0.f, aj = 0.f;
        if (nb >= 0) {
          pj = expf(sc[i] - m);
          if (j == 0) {  // the null column alone where every context slot is refused
            bool lone = true;
            for (int jj = 0; jj < kn; ++jj) lone = lone && s_nb[qi * kn + jj] < 0;
            if (lone) pj = 1.f;
          }
          // the cotangent of the dropped mix: dA times the keep factor
          aj = kDrop ? da[i] * keep_factor(drop, row_stream, a, tok,
                                           j == 0 ? kBosKey : static_cast<uint32_t>(nb))
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
    // a refused slot has P and dA 0 in every head: its key is moot
    const uint32_t key = j == 0 ? kBosKey : static_cast<uint32_t>(s_nb[qq * kn + j - 1]);
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
  for (int r = tid / kRowLanes; r < units; r += rows_at_once) {
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
  // [dth (heads, heads) | dnull_k (heads, d) | dnull_v (heads, d)]
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
        nbs[i] = j >= slots ? -1 : j == 0 ? g.lc : s_nb[qi * kn + j - 1];
        w[i] = nbs[i] < 0 ? 0.f : dsr[j];  // a refused slot: dS 0 in every head
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int nb = nbs[i];
        if (nb >= 0)
          axpy_row<T, kVec>(o, w[i],
                            nb == g.lc ? null_k + plane * d : k + (plane * g.lc + nb) * d, gl,
                            G, d);
      }
    }
    if (gpu == 1) {
      store_row<T, kVec>(dq + (plane * g.t + tok) * d, o, gl, G, d);
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
      dq[((bplane + un / tq) * g.t + tok) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* null_k,
           const void* null_v, const float* th, const unsigned char* cmask, const void* gout,
           const float* lse, void* dq, float* ds, float* mix, float* partial, int b,
           int heads, int d, CrossGeometry g, const Plan& p, Dropout drop,
           cudaStream_t stream) {
  const auto kernel =
      heads <= 8 ? (drop.on ? sparse_cross2dna_bwd_q_kernel<T, kVec, true, 8>
                            : sparse_cross2dna_bwd_q_kernel<T, kVec, false, 8>)
                 : (drop.on ? sparse_cross2dna_bwd_q_kernel<T, kVec, true, 32>
                            : sparse_cross2dna_bwd_q_kernel<T, kVec, false, 32>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(null_k), static_cast<const T*>(null_v), th, cmask,
      static_cast<const T*>(gout), lse, static_cast<T*>(dq), ds, mix, partial, heads, d, g, p,
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
// (b, plan blocks, heads*heads + 2*heads*d) fp32, every slot written: per
// tile [dth | dnull_k | dnull_v] over its queries, for the caller to sum
// over the block axis; drop 1 for the forward's attention dropout with its
// seed, threshold and fp32 scale (sparse3dna_dropout.cuh), 0 for none: mix
// is then the dropped mix; plan: kPlanInts ints, the wrapper's query tile
// and shared-memory layout (sparse3dna_tile.cuh).
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_bwd_q(int dtype, const void* q, const void* k, const void* v,
                                const void* null_k, const void* null_v, const float* th,
                                const unsigned char* cmask, const void* gout,
                                const float* lse, void* dq, float* ds, float* mix,
                                float* partial, int b, int heads, int t, int d, int lc,
                                int fmap, int ksize, int dil, int drop, unsigned int seed,
                                unsigned int thresh, float scale, const int* plan,
                                void* stream) {
  const CrossGeometry g{t, lc, fmap, ksize, dil};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds, mix,
                               partial, b, heads, d, g, p, dp, s);
  if (dtype == 0)
    return launch<float, false>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds, mix,
                                partial, b, heads, d, g, p, dp, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds,
                                       mix, partial, b, heads, d, g, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, null_k, null_v, th, cmask, gout, lse, dq, ds,
                                        mix, partial, b, heads, d, g, p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
