// Sparse3DNA backward, key side (causal, centered or audio, with or without
// attention dropout) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_kv_kernel` in nuwa_tpu/kernels/nda_pallas.py
// (reached through `_bwd_kv_call`, its pl.pallas_call), and in the audio
// geometry the same kernel and the row-blocked `_rb_bwd_kv_kernel` as
// `_audio_core_op` and `_audio_rb_core_op` run them for SparseCausal2DNA.
// For every key token it sums, over the (query, slot) pairs that read that
// key,
//
//   dK = sum dS[query, slot] * q[query]
//   dV = sum mix[query, slot] * g[query]
//
// per head, from the fp32 (b, h, t, Kn + 1) tensors dS and mix that the
// query-side kernel (sparse3dna_bwd_q.cu) wrote. With attention dropout
// that kernel writes the dropped mix, the probabilities that weighted the
// values, and a dS that already carries the mask, so this kernel is the same
// function with or without dropout and takes no dropout argument (the Pallas
// key-side kernels regenerate the mask instead: nda_pallas.py:787, :1065,
// :1121). The TPU kernel recomputed
// S and P for each key frame instead, because on the TPU the probabilities
// are a dense (T x Kf*HW) tensor; here they are the sparse (T x Kn) one, 15 MB
// at the training shape (b = 2, h = 8, t = 2559, Kn = 45), which is cheaper
// to read back than to recompute.
//
// The inverse neighbourhood (`reader` in sparse3dna_geometry.cuh). With
// causal or centered windows, slot (a, b, c), row-major over (kf, kh, kw), has
// the offset ((a-cf)*df, (b-ch)*dh, (c-cw)*dw), with c_ = k_-1 on each axis
// when causal and (k_-1)/2 when centered, so key (f, y, x) is read through
// that slot by the one query (f - (a-cf)*df, y - (b-ch)*dh, x - (c-cw)*dw):
// the window reflected, Kn pairs, one a slot. In the audio geometry a slot's
// column is absolute, so the key (s, c) of a (timesteps, 1, H) grid is read
// through the one slot a*H + c of each time tap a, by every query of
// timestep s + (cf - a)*df, its H columns alike: K*H pairs (query, slot),
// again Kn of them, but H to a slot. A pair exists when its query lies inside
// the grid on each axis (checked per axis: a flat index would wrap across
// rows) and before the sequence end t (which the queries of a ragged last
// timestep pass or fail one by one); the key, below t, is then a valid
// neighbour of it.
//
// What bounds it on the card: memory. Per key and head it does 4 * Kn * d
// operations, while the bytes the function must move are one row each of q,
// g, dk and dv and the Kn + 1 fp32 values of dS and mix of one query: at the
// training shape (bf16, d = 64) about 880 bytes and 11,500 operations, 13
// operations per byte. A first design (one block a key, one warp a head,
// the Kn pairs walked one after another with a 2-byte load a lane: one pair
// in flight a warp) ran 12.5x over that bound on an H100 at the fmap-16
// training shape: latency, as the query side's first design did.
//
// The gather reads more than those bytes. Each pair reads its query's q and
// g rows whole and one fp32 value each of dS and mix, and a lone 4-byte
// value costs its 32-byte sector: at the fmap-16 training shape (dilation
// 2, 0.85 M valid pairs over b and h) that is 54 MB of dS and mix sectors
// and 217 MB of q and g rows read pair by pair, against 15 MB of dS and mix
// in all (`kernel_ab.py sectors` counts them). Keys one step apart along x
// read the same query through neighbouring slots (slot c + 1 for the key
// dw to the right), so a tile that holds both shares those sectors and
// rows: at dilation 1 any tile two keys wide (2 x 2: 46 MB and 147 MB once a
// tile), at dilation 2 only one four keys wide (1 x 4: 38 MB and 144 MB;
// 2 x 2 shares none). The 1 x 4 tile measured no faster than 2 x 2 on an
// H100 (within 2% either way at fmap 16 and 32, dilations 1-4), so the key
// side takes the query side's candidates (kernels.nda `TILES`). Laying dS
// and mix out slot-major, (b, h, Kn + 1, t), would make a tile row's reads
// contiguous at every dilation, but changes what the query side writes.
//
// What the design does (sparse3dna_tile.cuh, as the query side's). A block
// owns a tile of keys of one frame with all heads (the wrapper's `tile_plan`
// with which = "bwd_kv"); it lists each key's Kn pairs in reader order in
// shared memory, the query and its slot (`reader`, `reader_slot`: no integer
// division is left in the loop over pairs, which measured 1-8% faster on an
// H100 than the slot worked out pair by pair), and groups of lanes read q
// and g rows in 16-byte chunks, each group serving a (head, key) unit
// kAxpyBatch (4) pairs at a time: the batch's dS and mix values are loaded
// first, then its q and g rows, all in flight together, before the sums. Four pairs a batch at 48 registers a
// thread (five blocks of 256 an SM) measured 1.4x faster on an H100 than
// eight at 108 (two blocks an SM). dk and dv are written in 16-byte chunks.
// Where the grid is too small to fill the card (the audio geometry's),
// the plan gives a block more groups than units: the groups of a unit take
// every gpu-th pair and their shares are summed in order in shared memory.
// Every key's sums run in one fixed order, so no atomics are needed, dk and
// dv are written once, and every output is the same bit for bit on every
// run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse3dna_geometry.cuh"
#include "sparse3dna_tile.cuh"

namespace {

// grid (p.blocks, b), block p.threads: a tile of p.ty x p.tx keys of one
// frame with all heads (the plan's query tile read as a key tile: the same
// `tile_view` and `tile_query`). Group gid of `group` lanes serves units
// (head, key) gid, gid + ngroups, ..., or a share of one unit's pairs where
// there are more groups than units. kVec: rows in 16-byte chunks.
template <typename T, bool kVec>
__global__ void __launch_bounds__(256, 5) sparse3dna_bwd_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ gout, const float* __restrict__ ds,
    const float* __restrict__ mix, T* __restrict__ dk, T* __restrict__ dv, int heads, int d,
    Geometry g, Window win, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (dynamic_smem_bytes() < static_cast<unsigned>(p.smem)) __trap();
  const int kn = g.kf * g.kh * g.kw, slots = kn + 1;  // slot 0 is bos, read by no key
  const TileView tv = tile_view(p);
  const int tq = tv.tq;
  int* s_pq = reinterpret_cast<int*>(smem + p.off_nb);        // (tq, kn) query of pair p, or -1
  int* s_ktok = reinterpret_cast<int*>(smem + p.off_qtok);    // (tq) key token or -1
  int* s_ps = reinterpret_cast<int*>(smem + p.off_aux);       // (tq, kn) slot of pair p
  float* s_red = reinterpret_cast<float*>(smem + p.off_red);  // (units, gpu, 2, d) shares
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t bplane = static_cast<size_t>(blockIdx.y) * heads;  // this batch row's first plane

  for (int x = tid; x < tq; x += nt) s_ktok[x] = tile_query(g, p, tv, x);
  for (int x = tid; x < tq * kn; x += nt) {
    const int ki = x / kn, pr = x % kn, kx = tv.x0 + ki % p.tx;
    const int rq = tile_query(g, p, tv, ki) < 0 ? -1 : reader(g, tv.f, tv.y0 + ki / p.tx, kx, pr);
    // only the window's queries' pairs count; their rows are the window's
    s_pq[x] = rq >= win.q_lo && rq < win.q_hi ? rq - win.q_lo : -1;
    s_ps[x] = reader_slot(g, kx, pr - pr % g.kw, pr % g.kw);
  }
  __syncthreads();

  const int units = heads * tq;  // unit a * tq + ki: head a, key ki
  const Groups w = split_groups(p.group, units, tid);
  for (int un = w.first; un < units; un += w.ustep) {
    const int a = un / tq, ki = un % tq, key = s_ktok[ki];
    if (key < 0) continue;  // uniform across the group
    const size_t plane = bplane + a, nq = win.q_hi - win.q_lo;
    const T* qp = q + plane * nq * d;
    const T* gp = gout + plane * nq * d;
    const float* dsp = ds + plane * nq * slots + 1;  // past bos
    const float* mxp = mix + plane * nq * slots + 1;
    const int *pq = s_pq + ki * kn, *ps = s_ps + ki * kn;
    float ok[8], ov[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ok[e] = ov[e] = 0.f;
    for (int p0 = w.sub; p0 < kn; p0 += kAxpyBatch * w.gpu) {
      int tok[kAxpyBatch];
      float wk[kAxpyBatch], wv[kAxpyBatch];
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {  // the batch's dS and mix values first
        const int pr = p0 + i * w.gpu;
        tok[i] = pr < kn ? pq[pr] : -1;
        wk[i] = wv[i] = 0.f;
        if (tok[i] >= 0) {
          const size_t s = static_cast<size_t>(tok[i]) * slots + ps[pr];
          wk[i] = dsp[s];
          wv[i] = mxp[s];
        }
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {  // then its rows, summed in reader order
        if (tok[i] >= 0) {
          const size_t r = static_cast<size_t>(tok[i]) * d;
          axpy_row<T, kVec>(ok, wk[i], qp + r, w.gl, w.G, d);
          axpy_row<T, kVec>(ov, wv[i], gp + r, w.gl, w.G, d);
        }
      }
    }
    if (w.gpu == 1) {
      store_row<T, kVec>(dk + (plane * g.t + key) * d, ok, w.gl, w.G, d);
      store_row<T, kVec>(dv + (plane * g.t + key) * d, ov, w.gl, w.G, d);
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
      (which ? dv : dk)[((bplane + un / tq) * g.t + key) * d + e] = from_f<T>(sum);
    }
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* gout, const float* ds, const float* mix, void* dk,
           void* dv, int b, int heads, int d, Geometry g, Window win, const Plan& p,
           cudaStream_t stream) {
  const auto kernel = sparse3dna_bwd_kv_kernel<T, kVec>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.blocks, b);
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(gout), ds, mix, static_cast<T*>(dk),
      static_cast<T*>(dv), heads, d, g, win, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous: dk, dv
// (b, heads, t, d), the t keys; q, gout (b, heads, nq, d) and ds, mix
// (b, heads, nq, kn + 1) fp32, slot 0 being bos, the queries of the window
// [q_lo, q_hi) with nq = q_hi - q_lo (sparse3dna_geometry.cuh: `Window`;
// only their pairs are summed; the whole sequence is 0, t);
// mode 1 for causal windows, 0 for centered, 2 for the audio geometry
// (fh = kh = 1, kw = fw = H); plan: kPlanInts ints, the wrapper's key tile
// and shared-memory layout (sparse3dna_tile.cuh, kernels.nda `tile_plan`
// with which = "bwd_kv"). Returns the cudaError_t of the launch (0 on
// success).
int nuwa_sparse3dna_bwd_kv(int dtype, const void* q, const void* gout, const float* ds,
                           const float* mix, void* dk, void* dv, int b, int heads, int t, int d,
                           int fh, int fw, int kf, int kh, int kw, int df, int dh, int dw,
                           int mode, int q_lo, int q_hi, const int* plan, void* stream) {
  const Geometry g{t, fh, fw, kf, kh, kw, df, dh, dw, mode};
  const Window win{q_lo, q_hi, 0};
  const Plan p = read_plan(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && p.vec)
    return launch<float, true>(q, gout, ds, mix, dk, dv, b, heads, d, g, win, p, s);
  if (dtype == 0) return launch<float, false>(q, gout, ds, mix, dk, dv, b, heads, d, g, win, p, s);
  if (dtype == 1 && p.vec)
    return launch<__nv_bfloat16, true>(q, gout, ds, mix, dk, dv, b, heads, d, g, win, p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, gout, ds, mix, dk, dv, b, heads, d, g, win, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* nuwa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
