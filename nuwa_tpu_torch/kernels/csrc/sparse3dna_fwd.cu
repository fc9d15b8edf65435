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
// (nda_pallas.py:279, :447); `lse` stays the undropped softmax's. PV reads
// every value row, a dropped pair's too: skipping them measured no faster on
// an H100 once a batch of rows is in flight together.
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
// What bounds it on the card. Per query and head it does about
// 4*(Kn+1)*d operations (scores and PV over Kn neighbours plus bos) against
// one row each of q, k, v and out that must move: about 14 operations a byte
// in bf16, so the byte bound is the least time, but not what holds the
// kernel. A first design (one block a query, one warp a head, one 2-byte
// load a lane per row) ran 26-290x over that bound on an H100: each warp
// kept one row load in flight and walked its Kn + 1 slots one after
// another. This one runs about 15x over it at the training shapes, waiting
// on the key and value rows from L2: each (query, head) reads 2 * (Kn + 1)
// rows, and neighbouring queries' windows share them only through L1.
//
// What the design does (sparse3dna_tile.cuh). A block owns a tile of
// queries of one frame with all heads (the wrapper's `tile_plan` picks it:
// 2 x 2, 1 x 2 or one query); its threads form groups of lanes that read a
// row in 16-byte chunks, each group serving a (head, query) unit 8 slots at
// a time, so the batch's loads are in flight together, and a butterfly of
// 7 shuffles sums the 8 scores across the group. The rows come straight
// from global memory, all heads at once: the tile's queries and the
// neighbouring tiles resident on the same SM read overlapping windows, and
// L1 serves the rows they share. Scores and the fp32 softmax of every
// (head, query, slot) stay in shared memory, 8 lanes a row; the
// talking-heads mix (and the keep factors of dropout) is formed there in
// place, one (query, slot) column a thread, before PV. Nothing but `out`
// and `lse` is written. sparse3dna_fwd_staged.cu computes the same function
// with each head's window union staged in shared memory; it measured 2-4x
// slower on an H100, and the rule takes none of its tiles.

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
// least the heads (8 or 32), the length of a mixed column. At most 256
// threads and 48 registers a thread: five blocks an SM measured faster on
// an H100 than four with more registers.
template <typename T, bool kVec, bool kDrop, int kMaxH>
__global__ void __launch_bounds__(256, 5) sparse3dna_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ lse, int heads, int d, Geometry g, Window win,
    Plan p, Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.kf * g.kh * g.kw, slots = kn + 1;  // slot 0 is bos
  const TileView tv = window_view(p, g, win);
  const int tq = tv.tq;
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);        // (heads, tq, slots) scores, P, mix
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);          // (tq, kn) neighbour token or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);      // (tq) token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);      // (heads, heads)
  float* s_bias = reinterpret_cast<float*>(smem + p.off_bias);  // (heads, kn), with a bias
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);    // (units, groups a unit, d) shares
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t bplane = static_cast<size_t>(bi) * heads;  // this batch row's first plane

  for (int x = tid; x < heads * heads; x += nt) s_th[x] = th[x];
  if (bias != nullptr) {
    for (int x = tid; x < heads * kn; x += nt) s_bias[x] = bias[x];
  }
  for (int x = tid; x < tq; x += nt) s_qtok[x] = window_query(g, p, tv, win, x);
  for (int x = tid; x < tq * kn; x += nt) s_nb[x] = tile_neighbour(g, p, tv, x / kn, x % kn);
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
    float xr[8];
    load_row<T, kVec>(xr, q + window_row(win, bplane + a, tok) * d, gl, G, d);
    const T* kplane = k + (bplane + a) * g.t * d;
    float* srow = s_s + un * slots;
    for (int j0 = sub; j0 < slots; j0 += kBatch * gpu) {
      float acc[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i * gpu;
        // the neighbour's token, t for bos, -1 outside the grid or past t
        const int nb = j >= slots ? -1 : j == 0 ? g.t : s_nb[qi * kn + j - 1];
        const T* row = nb == g.t ? kbos + (bplane + a) * d
                                 : kplane + static_cast<size_t>(max(nb, 0)) * d;
        acc[i] = nb >= 0 ? dot_row<T, kVec>(xr, row, gl, G, d) : 0.f;
      }
      const int base = group_sum_spread(acc, G, gl, gmask);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= kBatch / min(G, kBatch)) break;
        const int j = j0 + (base + i) * gpu;
        if (j >= slots) continue;
        const int nb = j == 0 ? g.t : s_nb[qi * kn + j - 1];
        // the bos column has no bias and no mask
        srow[j] = nb < 0 ? -CUDART_INF_F
                  : j > 0 && bias != nullptr ? acc[i] + s_bias[a * kn + j - 1] : acc[i];
      }
    }
  }
  __syncthreads();

  // ---- fp32 softmax of every (head, query) row of scores, kRowLanes lanes
  // a row
  const int rl = lane % kRowLanes, rows_at_once = nt / kRowLanes;
  const unsigned rmask = group_mask(kRowLanes, lane);
  for (int r = tid / kRowLanes; r < units; r += rows_at_once) {
    const int tok = s_qtok[r % tq];
    if (tok < 0) continue;  // uniform across the row's lanes
    float* row = s_s + r * slots;
    float m = -CUDART_INF_F;
    for (int j = rl; j < slots; j += kRowLanes) m = fmaxf(m, row[j]);
    m = row_max(m, rmask);  // finite: the bos slot is always present
    float den = 0.f;
    for (int j = rl; j < slots; j += kRowLanes) {
      const float e = expf(row[j] - m);
      row[j] = e;
      den += e;
    }
    den = row_sum(den, rmask);
    const float inv = 1.f / den;
    for (int j = rl; j < slots; j += kRowLanes) row[j] *= inv;
    if (rl == 0) lse[window_row(win, bplane + r / tq, tok)] = m + logf(den);
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
    // a slot outside the grid has probability 0 in every head: its key is moot;
    // the hash keys the tokens' ids in the whole sequence
    const uint32_t key =
        j == 0 ? kBosKey : static_cast<uint32_t>(s_nb[qq * kn + j - 1] + win.tok0);
    for (int a2 = 0; a2 < heads; ++a2) {
      float acc = 0.f;
#pragma unroll
      for (int b2 = 0; b2 < kMaxH; ++b2)
        if (b2 < heads) acc += s_th[a2 * heads + b2] * pr[b2];
      if (kDrop) acc *= keep_factor(drop, row_stream, a2, tok + win.tok0, key);
      s_s[(a2 * tq + qq) * slots + j] = acc;
    }
  }
  __syncthreads();

  // ---- PV of every unit, kAxpyBatch slots at a time -----------------------
  for (int un = first; un < units; un += ustep) {
    const int a = un / tq, qi = un % tq, tok = s_qtok[qi];
    if (tok < 0) continue;
    const T* vplane = v + (bplane + a) * g.t * d;
    const float* mrow = s_s + un * slots;
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
        w[i] = nbs[i] < 0 ? 0.f : mrow[j];  // a slot outside the grid: 0 in every head
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int nb = nbs[i];
        if (nb >= 0)
          axpy_row<T, kVec>(o, w[i], nb == g.t ? vbos + (bplane + a) * d
                                               : vplane + static_cast<size_t>(nb) * d, gl, G, d);
      }
    }
    if (gpu == 1) {
      store_row<T, kVec>(out + window_row(win, bplane + a, tok) * d, o, gl, G, d);
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
      out[window_row(win, bplane + un / tq, tok) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* kbos, const void* vbos,
           const float* th, const float* bias, void* out, float* lse, int b, int heads, int d,
           Geometry g, Window win, const Plan& p, Dropout drop, cudaStream_t stream) {
  const auto kernel = heads <= 8 ? (drop.on ? sparse3dna_fwd_kernel<T, kVec, true, 8>
                                             : sparse3dna_fwd_kernel<T, kVec, false, 8>)
                                 : (drop.on ? sparse3dna_fwd_kernel<T, kVec, true, 32>
                                            : sparse3dna_fwd_kernel<T, kVec, false, 32>);
  // Past the 48 KB default the block's limit is raised to what the plan
  // asks; past the card's opt-in maximum that call fails, and its error is
  // returned (the wrapper raises it).
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<T*>(out), lse, heads, d, g, win, p, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: k, v
// (b, heads, t, d); q, out (b, heads, q_hi - q_lo, d), the queries of the
// window [q_lo, q_hi) (sparse3dna_geometry.cuh: `Window`, with tok0 the id
// of key token 0 in the whole sequence; the whole sequence is 0, t, 0); kbos,
// vbos (b, heads, 1, d); th (heads, heads) fp32; bias (heads, kf*kh*kw) fp32
// or null; lse (b, heads, q_hi - q_lo) fp32; mode 1 for
// causal windows, 0 for centered, 2 for the audio geometry (fh = kh = 1,
// kw = fw = H); drop 1 for attention dropout with the hash's seed, its
// threshold and the fp32 scale 1 / keep (sparse3dna_dropout.cuh), 0 for none;
// plan: kPlanInts ints, the wrapper's tile and shared-memory layout
// (sparse3dna_tile.cuh). Returns the cudaError_t of the launch (0 on success).
int nuwa_sparse3dna_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* kbos, const void* vbos, const float* th,
                        const float* bias, void* out, float* lse, int b,
                        int heads, int t, int d, int fh, int fw, int kf, int kh,
                        int kw, int df, int dh, int dw, int mode, int q_lo, int q_hi,
                        int tok0, int drop, unsigned int seed, unsigned int thresh, float scale,
                        const int* plan, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Window win{q_lo, q_hi, tok0};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, win, p,
                               dp, s);
  if (dtype == 0)
    return launch<float, false>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, win, p,
                                dp, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g,
                                       win, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g,
                                        win, p, dp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
