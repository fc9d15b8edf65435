// Sparse3DNA forward (causal, centered or audio, with or without attention
// dropout) for Hopper, sm_90a, with each head's window union staged in
// shared memory.
//
// The same function as sparse3dna_fwd.cu, which replaces the TPU kernels
// `_kernel` (nuwa_tpu/kernels/nda_pallas.py, `_fwd_call`) and `_rb_kernel`
// (`_rb_fwd_call`), and writes the same `out` and `lse` (the geometry, the
// mix and the dropout bits are that file's). The wrapper launches this
// kernel where its plan stages (kernels/nda.py, `tile_plan` given a staged
// tile through the `tiles` argument); the rule's own tiles read the rows
// through L1 with sparse3dna_fwd.cu.
//
// What the design does (sparse3dna_tile.cuh). A block owns a tile of
// queries of one frame with all heads. For head a it copies the key rows
// of the tile's window union (clipped to the grid and to t) and the head's
// bos row into a shared-memory buffer with cp.async, a ring of p.stage
// buffers, so later heads' copies run while head a is scored; then the
// value rows the same way for PV, the first head's copy running under the
// softmax and the mix. Each union row leaves L2 once a tile, where the
// first design read it once for each query whose window holds it. Groups of
// lanes read the staged rows in 16-byte chunks, 8 slots at a time, as
// sparse3dna_fwd.cu reads them from global memory.
//
// What bounds it on the card. It measured 2-4x slower than reading through
// L1 on an H100 at every shape of the main path, and deeper rings (3-4
// buffers) no faster than 2 at the same blocks an SM. At dilation 2 the
// windows of a 2 x 2 tile share no row, so the copy is a pass more over
// the same rows; a 4 x 4 tile's union shares rows (320 for 720 pair reads
// at kernel (5, 3, 3)), but its buffers and every head's scores hold
// 128-150 KB of shared memory, one block of 8 warps an SM, and a stage
// (one head of 16 queries) is too little work to hide the copy behind.

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
__global__ void __launch_bounds__(256, 2) sparse3dna_fwd_staged_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ kbos, const T* __restrict__ vbos,
    const float* __restrict__ th, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ lse, int heads, int d, Geometry g, Plan p,
    Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.kf * g.kh * g.kw, slots = kn + 1;  // slot 0 is bos
  const TileView tv = tile_view(p);
  const int tq = tv.tq, rows = g.kf * p.uy * p.ux;
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);        // (heads, tq, slots) scores, P, mix
  int* s_nb = reinterpret_cast<int*>(smem + p.off_nb);          // (tq, kn) union index or -1
  int* s_qtok = reinterpret_cast<int*>(smem + p.off_qtok);      // (tq) token or -1
  float* s_th = reinterpret_cast<float*>(smem + p.off_th);      // (heads, heads)
  float* s_bias = reinterpret_cast<float*>(smem + p.off_bias);  // (heads, kn), with a bias
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);    // 2 x (tq, gpu, d) shares
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
  __syncthreads();

  // Stages: the key rows of heads 0.., then their value rows, one head a stage.
  const Groups w = split_groups(p.group, tq, tid);
  const size_t buf_elems = static_cast<size_t>(rows + 1) * d, red_floats = tq * w.gpu * d;
  const uint32_t row_stream = kDrop ? drop_stream(drop, bi) : 0u;
  const auto copy_stage = [&](int s) {  // stage s's rows into its buffer, one group
    if (s < 2 * heads)
      stage_rows<T>(s_buf + (s % p.stage) * buf_elems, s < heads ? k : v,
                    s < heads ? kbos : vbos, bplane + s % heads, s_utok, rows, g.t, d, tid, nt);
    cp_async_commit();
  };

  for (int s = 0; s < p.stage - 1; ++s) copy_stage(s);
  for (int s = 0; s < 2 * heads; ++s) {
    // stage s is in; stage s - 1's buffer is free for s + ring - 1
    cp_async_wait_ring(p.stage);
    __syncthreads();
    copy_stage(s + p.stage - 1);
    const int a = s % heads;
    const T* buf = s_buf + (s % p.stage) * buf_elems;
    if (s < heads) {  // ---- head a's scores, kBatch slots at a time
      dot_stage<T>(w, buf, q, s_nb, s_qtok, bplane + a, tq, kn, rows, g.t, d,
                   [&](int qi, int tok, int j, bool valid, float acc) {
                     // the bos column has no bias and no mask
                     s_s[(a * tq + qi) * slots + j] =
                         !valid                       ? -CUDART_INF_F
                         : j > 0 && bias != nullptr ? acc + s_bias[a * kn + j - 1]
                                                      : acc;
                   });
      continue;
    }
    if (s == heads) {
      // ---- fp32 softmax of every (head, query) row of scores, kRowLanes
      // lanes a row
      const int rl = lane % kRowLanes, rows_at_once = nt / kRowLanes;
      const unsigned rmask = group_mask(kRowLanes, lane);
      for (int r = tid / kRowLanes; r < heads * tq; r += rows_at_once) {
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
        if (rl == 0) lse[(bplane + r / tq) * g.t + tok] = m + logf(den);
      }
      __syncthreads();
      // ---- talking heads in place: mix[a, j] = sum_b th[a, b] * p[b, j],
      // each (query, slot) column by one thread, dropped with dropout
      for (int x = tid; x < tq * slots; x += nt) {
        const int qq = x / slots, j = x % slots, tok = s_qtok[qq];
        if (tok < 0) continue;
        float pr[kMaxH];
#pragma unroll
        for (int b2 = 0; b2 < kMaxH; ++b2)
          pr[b2] = b2 < heads ? s_s[(b2 * tq + qq) * slots + j] : 0.f;
        const uint32_t key = kDrop ? union_slot_key(s_nb, s_utok, kn, qq, j) : 0u;
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
    } else if (w.gpu > 1) {  // the last head's shares of PV, summed in order
      sum_shares(out, s_red + ((s - 1) & 1) * red_floats, s_qtok, bplane + a - 1, w.gpu, tq,
                 g.t, d, tid, nt);
    }
    // ---- head a's PV, kAxpyBatch slots at a time
    axpy_stage<T>(w, buf, s_s + a * tq * slots, out, s_red + (s & 1) * red_floats, s_nb, s_qtok,
                  bplane + a, tq, kn, rows, g.t, d);
  }
  if (w.gpu > 1) {
    __syncthreads();
    sum_shares(out, s_red + ((2 * heads - 1) & 1) * red_floats, s_qtok, bplane + heads - 1,
               w.gpu, tq, g.t, d, tid, nt);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kbos, const void* vbos,
           const float* th, const float* bias, void* out, float* lse, int b, int heads, int d,
           Geometry g, const Plan& p, Dropout drop, cudaStream_t stream) {
  const auto kernel = heads <= 8 ? (drop.on ? sparse3dna_fwd_staged_kernel<T, true, 8>
                                             : sparse3dna_fwd_staged_kernel<T, false, 8>)
                                 : (drop.on ? sparse3dna_fwd_staged_kernel<T, true, 32>
                                            : sparse3dna_fwd_staged_kernel<T, false, 32>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kbos), static_cast<const T*>(vbos), th, bias,
      static_cast<T*>(out), lse, heads, d, g, p, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The arguments of nuwa_sparse3dna_fwd (sparse3dna_fwd.cu); the plan must
// stage (p.stage 2-4) and rows must be 16-byte aligned (p.vec).
int nuwa_sparse3dna_fwd_staged(int dtype, const void* q, const void* k, const void* v,
                               const void* kbos, const void* vbos, const float* th,
                               const float* bias, void* out, float* lse, int b, int heads, int t,
                               int d, int fh, int fw, int kf, int kh, int kw, int df, int dh,
                               int dw, int mode, int drop, unsigned int seed, unsigned int thresh,
                               float scale, const int* plan, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Dropout dp{drop, seed, thresh, scale};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stage < 2 || p.stage > 4 || !p.vec) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, p, dp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kbos, vbos, th, bias, out, lse, b, heads, d, g, p, dp,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
