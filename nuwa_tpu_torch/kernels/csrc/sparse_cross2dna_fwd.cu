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
// What the design does (sparse3dna_tile.cuh, sparse_cross2dna_geometry.cuh,
// as sparse_cross2dna_bwd_q.cu's and sparse3dna_fwd.cu's). The TPU kernels
// scored every query frame against whole context frames (dense HW x HW
// tiles masked to the window by an additive -inf table, the head dim padded
// to 128 lanes, a bf16 score cache in VMEM) because the matrix unit wants
// large dense tiles; none of that helps a gather of Fc*k*k + 1 rows on
// Hopper. A first design here (one block a (query, batch row), one warp a
// head, each slot a warp-wide dot product with a 2-byte load a lane and a
// 5-step shuffle sum, one slot after another) ran 19-24x over the byte
// bound on an H100: latency, one row load in flight a warp. This one: a
// block owns a tile of ty x tx query positions of tf consecutive video
// frames with all heads (the wrapper's plan: kernels.nda `tile_plan` with
// which = "cross_fwd" and the candidates of kernels.cross `FWD_TILES`). The
// tile's query frames read the same context window, so they share one slot
// table, built from the positions and the context mask (bytes; a masked key
// is left out, probability exactly 0), and the rows they share are read
// close together. Groups of lanes read rows in 16-byte chunks, each serving
// a (head, query) unit kBatch slots at a time, so the batch's loads are in
// flight together, straight from global memory: neighbouring queries'
// windows overlap in every context frame (a 2 x 4 tile at dilation 1 reads
// 24 context positions a frame for its 72 slot reads), and L1 serves the
// rows they share. The fp32 softmax of every (head, query) row stays in
// shared memory, 8 lanes a row, and the talking-heads mix of all heads (and
// the keep factors of dropout) is formed there in place, one (query, slot)
// column a thread, before PV weights kAxpyBatch value rows at a time. The
// null column is always present, so a row with every context key masked
// (the unconditional half of a classifier-free-guidance batch) gets the
// mixed null value, P = 1 exactly and a finite lse. Nothing but `out` and
// `lse` is written.
//
// Measured (kernel_ab.py, bf16, b = 2, 8 heads of 64, on an H100 80GB HBM3
// at a 700 W power limit, the first design in turns with it): at the
// sketch forward shape (t = 1280) 0.0207 ms at Lc 256 and 0.0261 at Lc 512
// (first design 0.0413 / 0.0538), at the training shape (t = 2559) 0.0349 /
// 0.0457 (0.0748 / 0.0990), 10-12x over the byte bound; dropout adds 1-2%.
// The grid's fill decided the tile: at the forward shape 2 x 4 positions
// (320 blocks) ran 23-27% slower than 2 x 2 (640), hence kernels.cross
// `FWD_FILL`; at the training shape 2 x 2 positions of two query frames ran
// 5% faster than of one, and 1-3% faster than 2 x 4 of one at the same
// fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"
#include "sparse_cross2dna_geometry.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx query
// positions of p.tf video frames with all heads. Group gid of `group` lanes
// serves units (head, query) gid, gid + ngroups, ..., or a share of one
// unit's slots where there are more groups than units. kVec: rows in
// 16-byte chunks; kDrop: with attention dropout (false compiles none of the
// dropout code); kMaxH: at least the heads (8 or 32), the length of a mixed
// column. At most 256 threads and 48 registers a thread, as the Sparse3DNA
// forward's.
template <typename T, bool kVec, bool kDrop, int kMaxH>
__global__ void __launch_bounds__(256, 5) sparse_cross2dna_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ null_k, const T* __restrict__ null_v,
    const float* __restrict__ th, const unsigned char* __restrict__ cmask,
    T* __restrict__ out, float* __restrict__ lse, int heads, int d, CrossGeometry g, Plan p,
    Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.lc / (g.fmap * g.fmap) * g.k * g.k, slots = kn + 1;  // slot 0 is null
  const CrossQueryTile tv = cross_query_tile(p);
  const int tq = tv.tq, txy = p.ty * p.tx;
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);      // (heads, tq, slots) scores, P, mix
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);        // (txy, kn) context token or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);    // (tq) video token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);    // (heads, heads)
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);  // (units, groups a unit, d) shares
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bplane = static_cast<size_t>(bi) * heads;  // this batch row's first plane
  const unsigned char* mrow = cmask != nullptr ? cmask + static_cast<size_t>(bi) * g.lc : nullptr;

  for (int x = tid; x < heads * heads; x += nt) s_th[x] = th[x];
  for (int x = tid; x < tq; x += nt) s_qtok[x] = cross_tile_query(g, p, tv, x);
  for (int x = tid; x < txy * kn; x += nt) {
    const int qi = x / kn;
    s_nb[x] = cross_neighbour(g, mrow, tv.y0 + qi / p.tx, tv.x0 + qi % p.tx, x % kn);
  }
  __syncthreads();

  const int G = p.group, gid = tid / G, gl = tid % G, ng = nt / G;
  const unsigned gmask = group_mask(G, lane);
  const int units = heads * tq;        // unit a * tq + qi: head a, query qi
  const int gpu = max(1, ng / units);  // groups a unit
  const int ustep = ng / gpu, first = gid / gpu < ustep ? gid / gpu : units, sub = gid % gpu;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;

  // ---- scores of every unit, kBatch slots at a time ----------------------
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;  // uniform across the group
    const size_t plane = bplane + a;
    const int* nbr = s_nb + (qi % txy) * kn;
    float xr[8];
    load_row<T, kVec>(xr, q + (plane * g.t + tok) * d, gl, G, d);
    const T* kplane = k + plane * g.lc * d;
    float* srow = s_s + un * slots;
    for (int j0 = sub; j0 < slots; j0 += kBatch * gpu) {
      float acc[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i * gpu;
        // the context token, lc for the null column, -1 masked or outside
        const int nb = j >= slots ? -1 : j == 0 ? g.lc : nbr[j - 1];
        const T* row = nb == g.lc ? null_k + plane * d
                                  : kplane + static_cast<size_t>(max(nb, 0)) * d;
        acc[i] = nb >= 0 ? dot_row<T, kVec>(xr, row, gl, G, d) : 0.f;
      }
      const int base = group_sum_spread(acc, G, gl, gmask);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= kBatch / min(G, kBatch)) break;
        const int j = j0 + (base + i) * gpu;
        if (j >= slots) continue;
        // the null column is never masked
        srow[j] = j > 0 && nbr[j - 1] < 0 ? -CUDART_INF_F : acc[i];
      }
    }
  }
  __syncthreads();

  // ---- fp32 softmax of every (head, query) row of scores, kRowLanes lanes
  // a row. A row whose context is all masked has the null column alone:
  // exp(0) = 1, so P = 1 exactly and lse is the null score, as the backward
  // kernels take it
  const int rl = lane % kRowLanes, rows_at_once = nt / kRowLanes;
  const unsigned rmask = group_mask(kRowLanes, lane);
  for (int r = tid / kRowLanes; r < units; r += rows_at_once) {
    const int tok = s_qtok[r % tq];
    if (tok < 0) continue;  // uniform across the row's lanes
    float* row = s_s + r * slots;
    float m = -CUDART_INF_F;
    for (int j = rl; j < slots; j += kRowLanes) m = fmaxf(m, row[j]);
    m = row_max(m, rmask);  // finite: the null slot is always present
    float den = 0.f;
    for (int j = rl; j < slots; j += kRowLanes) {
      const float e = expf(row[j] - m);
      row[j] = e;
      den += e;
    }
    den = row_sum(den, rmask);
    const float inv = 1.f / den;
    for (int j = rl; j < slots; j += kRowLanes) row[j] *= inv;
    if (rl == 0) lse[(bplane + r / tq) * g.t + tok] = m + logf(den);
  }
  __syncthreads();

  // ---- talking heads in place: mix[a, j] = sum_b th[a, b] * p[b, j], each
  // (query, slot) column by one thread, dropped with dropout
  for (int x = tid; x < tq * slots; x += nt) {
    const int qq = x / slots, j = x % slots, tok = s_qtok[qq];
    if (tok < 0) continue;
    float pr[kMaxH];
#pragma unroll
    for (int b2 = 0; b2 < kMaxH; ++b2) pr[b2] = b2 < heads ? s_s[(b2 * tq + qq) * slots + j] : 0.f;
    // a refused slot has probability 0 in every head: its key is moot
    const uint32_t key =
        j == 0 ? kBosKey : static_cast<uint32_t>(s_nb[(qq % txy) * kn + j - 1]);
    for (int a2 = 0; a2 < heads; ++a2) {
      float acc = 0.f;
#pragma unroll
      for (int b2 = 0; b2 < kMaxH; ++b2)
        if (b2 < heads) acc += s_th[a2 * heads + b2] * pr[b2];
      if (kDrop) acc *= keep_factor(drop, row_stream, a2, tok, key);
      s_s[(a2 * tq + qq) * slots + j] = acc;
    }
  }
  __syncthreads();

  // ---- PV of every unit, kAxpyBatch slots at a time -----------------------
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;
    const size_t plane = bplane + a;
    const int* nbr = s_nb + (qi % txy) * kn;
    const T* vplane = v + plane * g.lc * d;
    const float* mrow2 = s_s + un * slots;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
    for (int j0 = sub; j0 < slots; j0 += kAxpyBatch * gpu) {
      float w[kAxpyBatch];
      int nbs[kAxpyBatch];
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int j = j0 + i * gpu;
        nbs[i] = j >= slots ? -1 : j == 0 ? g.lc : nbr[j - 1];
        w[i] = nbs[i] < 0 ? 0.f : mrow2[j];  // a refused slot: 0 in every head
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int nb = nbs[i];
        if (nb >= 0)
          axpy_row<T, kVec>(o, w[i], nb == g.lc ? null_v + plane * d
                                                : vplane + static_cast<size_t>(nb) * d,
                            gl, G, d);
      }
    }
    if (gpu == 1) {
      store_row<T, kVec>(out + (plane * g.t + tok) * d, o, gl, G, d);
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
      out[((bplane + un / tq) * g.t + tok) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* null_k,
           const void* null_v, const float* th, const unsigned char* cmask, void* out,
           float* lse, int b, int heads, int d, CrossGeometry g, const Plan& p, Dropout drop,
           cudaStream_t stream) {
  const auto kernel =
      heads <= 8 ? (drop.on ? sparse_cross2dna_fwd_kernel<T, kVec, true, 8>
                            : sparse_cross2dna_fwd_kernel<T, kVec, false, 8>)
                 : (drop.on ? sparse_cross2dna_fwd_kernel<T, kVec, true, 32>
                            : sparse_cross2dna_fwd_kernel<T, kVec, false, 32>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(null_k), static_cast<const T*>(null_v), th, cmask,
      static_cast<T*>(out), lse, heads, d, g, p, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: q, out
// (b, heads, t, d); k, v (b, heads, lc, d); null_k, null_v (b, heads, 1, d);
// th (heads, heads) fp32; cmask (b, lc) bytes, nonzero where a context token
// may be attended, or null for all; lse (b, heads, t) fp32; drop 1 for
// attention dropout with the hash's seed, its threshold and the fp32 scale
// 1 / keep (sparse3dna_dropout.cuh), 0 for none; plan: kPlanInts ints, the
// wrapper's query tile and shared-memory layout (sparse3dna_tile.cuh,
// kernels.nda `tile_plan` with which = "cross_fwd").
// Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse_cross2dna_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* null_k, const void* null_v, const float* th,
                              const unsigned char* cmask, void* out, float* lse, int b,
                              int heads, int t, int d, int lc, int fmap, int ksize,
                              int dil, int drop, unsigned int seed, unsigned int thresh,
                              float scale, const int* plan, void* stream) {
  const CrossGeometry g{t, lc, fmap, ksize, dil};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, k, v, null_k, null_v, th, cmask, out, lse, b, heads, d, g,
                               p, dp, s);
  if (dtype == 0)
    return launch<float, false>(q, k, v, null_k, null_v, th, cmask, out, lse, b, heads, d, g,
                                p, dp, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, k, v, null_k, null_v, th, cmask, out, lse, b,
                                       heads, d, g, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, null_k, null_v, th, cmask, out, lse, b,
                                        heads, d, g, p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
