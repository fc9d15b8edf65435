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
// each of q and g and two fp32 values of dS and A read: at the sketch
// training shape (bf16, b = 2, 8 heads of 64, t = 2559, Lc 256) 14.8 MB
// must move. A first design (one block a (context key, batch row), one warp
// a head, the F*k*k pairs walked one after another with a 2-byte load a
// lane, each lone fp32 value of dS and A costing its 32-byte sector) ran
// 14-15x over that bound on an H100, and its grid of Lc * b blocks of 256
// threads (512 at Lc 256) held under half of what the card runs at once.
//
// What the design does (sparse3dna_tile.cuh, sparse_cross2dna_geometry.cuh,
// as sparse3dna_bwd_kv.cu's). A block owns a tile of ty x tx keys of one
// context frame and p.hs of the heads (the wrapper's plan: kernels.nda
// `tile_plan` with which = "cross_bwd_kv" and the candidates of
// kernels.cross `KV_TILES`). Nothing couples the heads on the key side (dS
// and A already carry the talking-heads mix), so the grid splits them over
// blocks, and the spare groups of a block split each key's pairs. It lists
// each key's reflected window in shared memory, compacted: the in-frame
// query positions and their slots, so that a key at the frame's edge walks
// only its valid pairs. Groups of lanes read q and g rows in 16-byte chunks,
// each serving a (head, key) unit or every gpu-th pair of one, kAxpyBatch
// (4) pairs at a time, the pairs taken query frame by query frame: the
// batch's dS and A values are loaded first, then its q and g rows, all in
// flight together, before the sums. Keys one step apart along x read the
// same query through neighbouring slots, so a tile at least k keys wide
// reads a query's dS and A values of all its keys in one or two sectors,
// which L1 serves. Registers are capped as the Sparse3DNA key side's are
// (256 threads, 48 registers, five blocks an SM), and dk and dv are written
// in 16-byte chunks. The groups that share a unit sum their shares in one
// fixed order in shared memory, so every key's sums run in one fixed order:
// no atomics, dk and dv written once, and every output the same bit for bit
// on every run.
//
// Measured (kernel_ab.py, bf16, b = 2, 8 heads of 64, on an H100 80GB HBM3
// at a 700 W power limit, the first design in turns with it): at the
// sketch training shape (t = 2559) 0.0243 ms at Lc 256 and 0.0395 at Lc 512
// (first design 0.0642 / 0.1209), 5.5x and 7.0x over the byte bound; at the
// forward shape (t = 1280) 0.0172 / 0.0264 (0.0354 / 0.0650). The spare
// groups and batches did most of it (all heads a block, one key: 0.0259 at
// the training shape, Lc 256); one head a block and tiles of 2 x 4 or 4 x 4
// keys the rest: the largest tile that still gives two blocks an SM
// (kernels.cross `KV_TILES`), 4 x 4 15-16% faster than 2 x 4 at Lc 512,
// where 2 x 4's grid runs in two waves, 2 x 4 17-25% faster than 4 x 4 at
// Lc 256, where 4 x 4's does not fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"
#include "sparse_cross2dna_geometry.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx keys of one
// context frame with p.hs heads. Group gid of `group` lanes serves units
// (head, key) gid, gid + ngroups, ..., or a share of one unit's pairs where
// there are more groups than units. kVec: rows in 16-byte chunks.
template <typename T, bool kVec>
__global__ void __launch_bounds__(256, 5) sparse_cross2dna_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ gout, const float* __restrict__ ds,
    const float* __restrict__ mix, T* __restrict__ dk, T* __restrict__ dv, int heads, int d,
    CrossGeometry g, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int hw = g.fmap * g.fmap, kk = g.k * g.k;
  const int slots = g.lc / hw * kk + 1, frames = (g.t + hw - 1) / hw;  // query frames
  const CrossKeyTile tv = cross_key_tile(p, heads);
  const int tq = tv.tq;
  int* s_pos = reinterpret_cast<int*>(smem + p.off_nb);       // (tq, kk) query position or -1
  int* s_ktok = reinterpret_cast<int*>(smem + p.off_qtok);    // (tq) key token or -1
  int* s_slot = reinterpret_cast<int*>(smem + p.off_aux);     // (tq, kk) its slot
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);  // (units, gpu, 2, d) shares
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t bplane = static_cast<size_t>(blockIdx.y) * heads;  // this batch row's first plane

  // each key's reflected window, compacted: the valid pairs first, in
  // window order, then -1
  const int half = (g.k - 1) / 2;
  for (int ki = tid; ki < tq; ki += nt) {
    const int y = tv.y0 + ki / p.tx, x = tv.x0 + ki % p.tx;
    const bool in = y < g.fmap && x < g.fmap;
    s_ktok[ki] = in ? (tv.c * g.fmap + y) * g.fmap + x : -1;
    int n = 0;
    for (int j = 0; in && j < kk; ++j) {
      const int qy = y - (j / g.k - half) * g.dil, qx = x - (j % g.k - half) * g.dil;
      if (qy < 0 || qy >= g.fmap || qx < 0 || qx >= g.fmap) continue;
      s_pos[ki * kk + n] = qy * g.fmap + qx;
      s_slot[ki * kk + n] = 1 + tv.c * kk + j;
      ++n;
    }
    for (; n < kk; ++n) s_pos[ki * kk + n] = -1;
  }
  __syncthreads();

  // unit a * tq + ki: head h0 + a, key ki; the groups split the plan's
  // p.hs * tq units, as its shares were laid out, the last head group's
  // spare ones idle
  const int units = tv.hn * tq;
  const Groups w = split_groups(p.group, p.hs * tq, tid);
  for (int un = w.first; un < units; un += w.ustep) {
    const int ki = un % tq, key = s_ktok[ki];
    if (key < 0) continue;  // uniform across the group
    const size_t plane = bplane + tv.h0 + un / tq;
    const T* qp = q + plane * g.t * d;
    const T* gp = gout + plane * g.t * d;
    const float* dsp = ds + plane * g.t * slots;
    const float* mxp = mix + plane * g.t * slots;
    const int *pos = s_pos + ki * kk, *sl = s_slot + ki * kk;
    int nj = 0;  // the key's valid window positions, at least its own
    while (nj < kk && pos[nj] >= 0) ++nj;
    // pair m = f * nj + n: query frame f, window position n; this group takes
    // pairs sub, sub + gpu, ..., (f, n) tracking the next
    int f = 0, n = w.sub;
    while (n >= nj) n -= nj, ++f;
    float ok[8], ov[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ok[e] = ov[e] = 0.f;
    while (f < frames) {
      int tok[kAxpyBatch];
      float wk[kAxpyBatch], wv[kAxpyBatch];
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {  // the batch's dS and A values first
        tok[i] = -1;
        wk[i] = wv[i] = 0.f;
        if (f < frames) {
          const int tk = f * hw + pos[n];
          if (tk < g.t) {  // only the last query frame is ragged
            const size_t s = static_cast<size_t>(tk) * slots + sl[n];
            tok[i] = tk;
            wk[i] = dsp[s];
            wv[i] = mxp[s];
          }
          n += w.gpu;
          while (n >= nj) n -= nj, ++f;
        }
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {  // then its rows, summed in pair order
        if (tok[i] >= 0) {
          const size_t r = static_cast<size_t>(tok[i]) * d;
          axpy_row<T, kVec>(ok, wk[i], qp + r, w.gl, w.G, d);
          axpy_row<T, kVec>(ov, wv[i], gp + r, w.gl, w.G, d);
        }
      }
    }
    if (w.gpu == 1) {
      store_row<T, kVec>(dk + (plane * g.lc + key) * d, ok, w.gl, w.G, d);
      store_row<T, kVec>(dv + (plane * g.lc + key) * d, ov, w.gl, w.G, d);
    } else {
      share_row<T, kVec>(s_red, (un * w.gpu + w.sub) * 2, ok, w.gl, w.G, d);
      share_row<T, kVec>(s_red, (un * w.gpu + w.sub) * 2 + 1, ov, w.gl, w.G, d);
    }
  }
  if (w.gpu > 1) {
    // the groups that share a unit sum their shares in order
    __syncthreads();
    for (int x = tid; x < units * 2 * d; x += nt) {
      const int un = x / (2 * d), which = x / d % 2, e = x % d, key = s_ktok[un % tq];
      if (key < 0) continue;
      float sum = 0.f;
      for (int sb = 0; sb < w.gpu; ++sb) sum += s_red[((un * w.gpu + sb) * 2 + which) * d + e];
      (which ? dv : dk)[((bplane + tv.h0 + un / tq) * g.lc + key) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* gout, const float* ds, const float* mix, void* dk,
           void* dv, int b, int heads, int d, CrossGeometry g, const Plan& p,
           cudaStream_t stream) {
  const auto kernel = sparse_cross2dna_bwd_kv_kernel<T, kVec>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(gout), ds, mix, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, d, g, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, gout
// (b, heads, t, d); ds, mix (b, heads, t, lc / (fmap * fmap) * ksize * ksize
// + 1) fp32, slot 0 being the null key; dk, dv (b, heads, lc, d), every row
// written; plan: kPlanInts ints, the wrapper's key tile, head split and
// shared-memory layout (sparse3dna_tile.cuh, kernels.nda `tile_plan` with
// which = "cross_bwd_kv").
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_bwd_kv(int dtype, const void* q, const void* gout, const float* ds,
                                 const float* mix, void* dk, void* dv, int b, int heads,
                                 int t, int d, int lc, int fmap, int ksize, int dil,
                                 const int* plan, void* stream) {
  const CrossGeometry g{t, lc, fmap, ksize, dil};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, gout, ds, mix, dk, dv, b, heads, d, g, p, s);
  if (dtype == 0) return launch<float, false>(q, gout, ds, mix, dk, dv, b, heads, d, g, p, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, gout, ds, mix, dk, dv, b, heads, d, g, p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, gout, ds, mix, dk, dv, b, heads, d, g, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
