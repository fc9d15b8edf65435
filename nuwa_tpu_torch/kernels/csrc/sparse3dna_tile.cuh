// Tiles of the Sparse3DNA kernels (sparse3dna_fwd.cu, sparse3dna_bwd_q.cu,
// their staged variants sparse3dna_fwd_staged.cu and
// sparse3dna_bwd_q_staged.cu, and the key side sparse3dna_bwd_kv.cu) and of
// the SparseCross2DNA kernels (sparse_cross2dna_*.cu, whose own tiles are in
// sparse_cross2dna_geometry.cuh): a block owns a tile of queries (the key
// sides: of keys) of one frame with all heads.
//
// The tile is ty x tx queries at (y0, x0) of frame f (tiles_y x tiles_x
// tiles a frame, the last ones ragged at the frame's edge). The block's
// threads form groups of `group` lanes; a group reads a row in 16-byte
// chunks (8 bf16 or 4 fp32 a lane where rows are 16-byte aligned, one
// element a lane else), so a dot product is a shuffle sum over the group,
// and it serves one (head, query) unit, or a share of its slots where there
// are more groups than units, kBatch slots at a time: the batch's row loads
// are in flight together. The wrapper chooses the tile and lays out the
// shared memory (kernels/nda.py, `tile_plan`); the kernels read that plan as
// it is given.
//
// The staged kernels work on the tile's window union: the set of key
// positions any of its queries reads, kf frames of uy rows and ux columns
// (`axis_index` numbers an axis's positions compactly; in the audio
// geometry the columns are the whole timestep's). They copy one head's
// union of key or value rows, and that head's bos row after it, into a
// shared-memory buffer with cp.async, a ring of p.stage buffers in turn, so
// the next heads' copies run under this head's work, and find the rows a
// neighbour reads by their union index. The others read the rows from
// global memory, all heads at once, and L1 serves the rows overlapping
// windows share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse3dna_dropout.cuh"
#include "sparse3dna_geometry.cuh"

// The launch plan, passed by the wrapper as kPlanInts ints in this order.
struct Plan {
  int ty, tx;            // queries of a tile: rows and columns of one frame
  int tiles_y, tiles_x;  // tiles along a frame's height and width
  int blocks;            // the grid's blocks along the sequence: frames * tiles_y * tiles_x
  int group;             // lanes that read one row together (a power of 2, <= 32)
  int threads;           // threads of a block
  int vec;               // 1: rows are read in 16-byte chunks (d * size 16-byte aligned)
  int stage;             // buffers of the ring each head's window union is staged in (2-4),
                         // 0: rows read from global memory
  int uy, ux;            // rows and columns of a frame in the window union
  // byte offsets into the dynamic shared memory, and its size
  int off_s, off_s2, off_nb, off_qtok, off_th, off_bias, off_lse, off_red, off_aux, off_utok,
      off_buf, smem;
  int tf;  // the cross forward's query frames a tile (1 elsewhere)
  int hs;  // the cross key side's heads a block (all heads elsewhere)
};
constexpr int kPlanInts = 25;

__host__ inline Plan read_plan(const int* v) {
  return Plan{v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],  v[7],  v[8],
              v[9],  v[10], v[11], v[12], v[13], v[14], v[15], v[16], v[17],
              v[18], v[19], v[20], v[21], v[22], v[23], v[24]};
}

constexpr int kBatch = 8;  // slots a group scores at once
constexpr int kAxpyBatch = 4;  // slots (the key side: pairs) a group weights into its row at once

// What a block knows of its tile.
struct TileView {
  int f, y0, x0;  // frame and origin of the tile
  int tq;         // queries of the tile, ty * tx
};

__device__ __forceinline__ TileView tile_view(const Plan& p) {
  const int tiles = p.tiles_y * p.tiles_x;
  const int ti = blockIdx.x % tiles;
  return TileView{static_cast<int>(blockIdx.x) / tiles, (ti / p.tiles_x) * p.ty,
                  (ti % p.tiles_x) * p.tx, p.ty * p.tx};
}

// Token of query qi of the tile, or -1 outside the frame or at or past t.
__device__ __forceinline__ int tile_query(const Geometry& g, const Plan& p, const TileView& v,
                                          int qi) {
  const int y = v.y0 + qi / p.tx, x = v.x0 + qi % p.tx;
  if (y >= g.fh || x >= g.fw) return -1;
  const int tok = (v.f * g.fh + y) * g.fw + x;
  return tok < g.t ? tok : -1;
}

// Neighbour token of query qi's window slot j (0..kn-1), or -1.
__device__ __forceinline__ int tile_neighbour(const Geometry& g, const Plan& p,
                                              const TileView& v, int qi, int j) {
  return neighbour(g, v.f, v.y0 + qi / p.tx, v.x0 + qi % p.tx, j);
}

// ---- element access: rows are read in chunks of E elements ----------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements a chunk holds: 16 bytes where rows are 16-byte aligned, else one.
template <typename T, bool kVec> struct ChunkOf {
  static constexpr int kElems = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int kPerLane = 8 / kElems;  // chunks a lane holds: 8 elements, d <= 256
};

__device__ __forceinline__ void unpack_bf16x2(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* p, float* x) {
  if constexpr (!kVec) {
    x[0] = to_f(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    unpack_bf16x2(w.x, x);
    unpack_bf16x2(w.y, x + 2);
    unpack_bf16x2(w.z, x + 4);
    unpack_bf16x2(w.w, x + 6);
  }
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16(lo), b = __float2bfloat16(hi);
  return static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(&a)) |
         (static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(&b)) << 16);
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(T* p, const float* x) {
  if constexpr (!kVec) {
    *p = from_f<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]),
                                              pack_bf16x2(x[4], x[5]), pack_bf16x2(x[6], x[7]));
  }
}

// This lane's chunks of a row of d elements (chunks gl, gl + G, ...) as
// floats, into x (8 floats: CPL chunks of E).
template <typename T, bool kVec>
__device__ __forceinline__ void load_row(float* x, const T* row, int gl, int G, int d) {
  constexpr int E = ChunkOf<T, kVec>::kElems, CPL = ChunkOf<T, kVec>::kPerLane;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = gl + G * r;
    if (c * E < d) load_chunk<T, kVec>(row + c * E, x + r * E);
  }
}

// This lane's share of the dot product of x (its chunks) with a row.
template <typename T, bool kVec>
__device__ __forceinline__ float dot_row(const float* x, const T* row, int gl, int G, int d) {
  constexpr int E = ChunkOf<T, kVec>::kElems, CPL = ChunkOf<T, kVec>::kPerLane;
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = gl + G * r;
    if (c * E < d) {
      float y[E];
      load_chunk<T, kVec>(row + c * E, y);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e & 1] += x[r * E + e] * y[e];
    }
  }
  return acc[0] + acc[1];
}

// o (this lane's chunks) += w * row.
template <typename T, bool kVec>
__device__ __forceinline__ void axpy_row(float* o, float w, const T* row, int gl, int G, int d) {
  constexpr int E = ChunkOf<T, kVec>::kElems, CPL = ChunkOf<T, kVec>::kPerLane;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = gl + G * r;
    if (c * E < d) {
      float y[E];
      load_chunk<T, kVec>(row + c * E, y);
#pragma unroll
      for (int e = 0; e < E; ++e) o[r * E + e] += w * y[e];
    }
  }
}

// Store this lane's chunks of o to a row of d elements.
template <typename T, bool kVec>
__device__ __forceinline__ void store_row(T* row, const float* o, int gl, int G, int d) {
  constexpr int E = ChunkOf<T, kVec>::kElems, CPL = ChunkOf<T, kVec>::kPerLane;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = gl + G * r;
    if (c * E < d) store_chunk<T, kVec>(row + c * E, o + r * E);
  }
}

// This lane's chunks of o into row `slot` of the shares array `red` (rows of d).
template <typename T, bool kVec>
__device__ __forceinline__ void share_row(float* red, int slot, const float* o, int gl, int G,
                                          int d) {
  constexpr int E = ChunkOf<T, kVec>::kElems, CPL = ChunkOf<T, kVec>::kPerLane;
#pragma unroll
  for (int r = 0; r < CPL; ++r) {
    const int c = gl + G * r;
    if (c * E < d) {
#pragma unroll
      for (int e = 0; e < E; ++e) red[slot * d + c * E + e] = o[r * E + e];
    }
  }
}

// Sum each of the kBatch values v over the `group` lanes that share a row
// (mask: those lanes), spread over them: a butterfly in which each lane
// hands on the half it does not keep, kBatch - 1 shuffles for kBatch sums
// where a sum a value takes log2(group) each. Afterwards this lane holds the
// sums of values base, base + 1, ... in v[0], v[1], ...,
// kBatch / min(group, kBatch) of them; base is returned.
__device__ __forceinline__ int group_sum_spread(float (&v)[kBatch], int group, int gl,
                                                unsigned mask) {
  int base = 0, shift = 1;
#pragma unroll
  for (int half = kBatch / 2; half > 0; half /= 2, ++shift) {
    const int o = group >> shift;
    if (o == 0) break;
    const bool up = gl & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float give = up ? v[i] : v[half + i], keep = up ? v[half + i] : v[i];
      v[i] = keep + __shfl_xor_sync(mask, give, o);
    }
    base += up ? half : 0;
  }
  for (int o = group >> shift; o > 0; o >>= 1) v[0] += __shfl_xor_sync(mask, v[0], o);
  return base;
}

__device__ __forceinline__ unsigned group_mask(int group, int lane) {
  return group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (lane & ~(group - 1));
}

// Rows of (head, query) values (scores, P, dS) are worked on by kRowLanes
// lanes each, 32 / kRowLanes rows a warp at once.
constexpr int kRowLanes = 8;

__device__ __forceinline__ float row_sum(float v, unsigned mask) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v, unsigned mask) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// ---- the window union ------------------------------------------------------
// On an axis of kernel k and dilation dl, the tile's n queries read the
// positions i + m*dl (i < n, m < k) past the window's first: all of
// 0 .. n + (k-1)*dl - 1 where n >= dl, else k runs of n. `axis_index`
// numbers them compactly (the host's `_axis_span` counts them), and
// `axis_position` is its inverse.
__device__ __forceinline__ int axis_index(int pos, int n, int dl) {
  return n >= dl ? pos : (pos / dl) * n + pos % dl;
}

__device__ __forceinline__ int axis_position(int i, int n, int dl) {
  return n >= dl ? i : (i / n) * dl + i % n;
}

// Union index of query qi's window slot j (0..kn-1): (frame tap, row, column)
// row-major over (kf, uy, ux). Only where the slot's neighbour is valid.
__device__ __forceinline__ int union_index(const Geometry& g, const Plan& p, int qi, int j) {
  const int a = j / (g.kh * g.kw), r = j % (g.kh * g.kw);
  const int cy = axis_index(qi / p.tx + (r / g.kw) * g.dh, p.ty, g.dh);
  const int cx =
      g.mode == kAudio ? r % g.kw : axis_index(qi % p.tx + (r % g.kw) * g.dw, p.tx, g.dw);
  return (a * p.uy + cy) * p.ux + cx;
}

// Token of union row u, or -1 outside the grid or at or past t: the same
// token as `neighbour` gives every slot that `union_index` maps to u.
__device__ __forceinline__ int union_token(const Geometry& g, const Plan& p, const TileView& v,
                                           int u) {
  const int a = u / (p.uy * p.ux), cy = u / p.ux % p.uy, cx = u % p.ux;
  const int nf = v.f + (a - centre(g, g.kf)) * g.df;
  const int ny = v.y0 + axis_position(cy, p.ty, g.dh) - centre(g, g.kh) * g.dh;
  const int nx = g.mode == kAudio ? cx
                                  : v.x0 + axis_position(cx, p.tx, g.dw) - centre(g, g.kw) * g.dw;
  if (nf < 0 || ny < 0 || ny >= g.fh || nx < 0 || nx >= g.fw) return -1;
  const int tok = (nf * g.fh + ny) * g.fw + nx;
  return tok < g.t ? tok : -1;
}

// A staged block's table of its queries' slots (tq, kn): the union index of
// each valid neighbour, -1 where invalid; and s_utok, each union row's token.
__device__ __forceinline__ void fill_union(const Geometry& g, const Plan& p, const TileView& v,
                                           int* s_nb, int* s_utok, int tid, int nt) {
  const int kn = g.kf * g.kh * g.kw, rows = g.kf * p.uy * p.ux;
  for (int x = tid; x < v.tq * kn; x += nt)
    s_nb[x] = tile_neighbour(g, p, v, x / kn, x % kn) >= 0 ? union_index(g, p, x / kn, x % kn)
                                                            : -1;
  for (int u = tid; u < rows; u += nt) s_utok[u] = union_token(g, p, v, u);
}

// The staged row of tile query qi's slot j (0: bos, the row after the `rows`
// union rows of the buffer x), or null past the last slot or where the
// neighbour is invalid.
template <typename T> struct SlotRows {
  const T* x;
  const int* nb;  // the block's slot table (fill_union)
  int kn, rows, d;
  __device__ __forceinline__ const T* operator()(int qi, int j) const {
    if (j > kn) return nullptr;
    const int n = j == 0 ? rows : nb[qi * kn + j - 1];
    return n < 0 ? nullptr : x + static_cast<size_t>(n) * d;
  }
};

// The dropout key of a staged tile query qi's slot j: kBosKey for bos, else
// the neighbour's token (the all-ones word where the slot is invalid: its
// mixed probability is 0 in every head, so the key is moot).
__device__ __forceinline__ uint32_t union_slot_key(const int* s_nb, const int* s_utok, int kn,
                                                   int qi, int j) {
  if (j == 0) return kBosKey;
  const int n = s_nb[qi * kn + j - 1];
  return static_cast<uint32_t>(n >= 0 ? s_utok[n] : n);
}

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most ring - 2 groups of copies are in flight: in a ring of
// `ring` buffers (one group a stage, ring - 1 started ahead), the current
// stage's copy has landed.
__device__ __forceinline__ void cp_async_wait_ring(int ring) {
  if (ring <= 2) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (ring == 3) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// Copy plane `plane` of x's rows of the union (tokens s_utok, -1 skipped) and
// its bos row into `buf`, rows of d (16-byte aligned), with cp.async in
// 16-byte chunks; the caller commits the group and waits with
// cp_async_wait_ring.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* x, const T* bos, size_t plane,
                                           const int* s_utok, int rows, int t, int d, int tid,
                                           int nt) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int cpr = d / E;  // chunks a row
  for (int i = tid; i < (rows + 1) * cpr; i += nt) {
    const int u = i / cpr, c = i - u * cpr;
    const int tok = u == rows ? t : s_utok[u];
    if (tok < 0) continue;
    cp_async16(buf + static_cast<size_t>(u) * d + c * E,
               (tok == t ? bos + plane * d : x + (plane * t + tok) * d) + c * E);
  }
}

// ---- one stage's work of a staged block's groups --------------------------

// How a block's groups split a stage's units (the tq queries of one head):
// `gpu` groups a unit, each taking every gpu-th slot from `sub`; units
// first, first + ustep, ... (first = units: the group is idle).
struct Groups {
  int G, gl, gpu, ustep, first, sub;
  unsigned mask;
};

__device__ __forceinline__ Groups split_groups(int group, int units, int tid) {
  const int gid = tid / group, ng = blockDim.x / group;
  const int gpu = max(1, ng / units), ustep = ng / gpu;
  return Groups{group, tid % group, gpu, ustep, gid / gpu < ustep ? gid / gpu : units,
                gid % gpu, group_mask(group, tid & 31)};
}

// Dot products of head a's row x of each tile query (rows of `xq`, plane
// bplane + a) with the staged rows of its slots (`buf`), kBatch slots at a
// time; epi(qi, token, j, valid, dot) gets each slot's sum.
template <typename T, typename Epi>
__device__ __forceinline__ void dot_stage(const Groups& w, const T* buf, const T* xq,
                                          const int* s_nb, const int* s_qtok, size_t plane,
                                          int tq, int kn, int rows, int t, int d, Epi epi) {
  const int slots = kn + 1;
  const SlotRows<T> row_of{buf, s_nb, kn, rows, d};
  for (int qi = w.first; qi < tq; qi += w.ustep) {
    const int tok = s_qtok[qi];
    if (tok < 0) continue;  // uniform across the group
    float xr[8];
    load_row<T, true>(xr, xq + (plane * t + tok) * d, w.gl, w.G, d);
    for (int j0 = w.sub; j0 < slots; j0 += kBatch * w.gpu) {
      float acc[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const T* row = row_of(qi, j0 + i * w.gpu);
        acc[i] = row != nullptr ? dot_row<T, true>(xr, row, w.gl, w.G, d) : 0.f;
      }
      const int base = group_sum_spread(acc, w.G, w.gl, w.mask);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= kBatch / min(w.G, kBatch)) break;
        const int j = j0 + (base + i) * w.gpu;
        if (j < slots) epi(qi, tok, j, row_of(qi, j) != nullptr, acc[i]);
      }
    }
  }
}

// Each tile query's weighted sum of its slots' staged rows (`buf`), weights
// (tq, slots) in `wts`, kAxpyBatch slots at a time, into its row of `out`
// (plane `plane`), or, where groups share a query, into its share of `red`
// (tq, gpu, d) for `sum_shares`.
template <typename T>
__device__ __forceinline__ void axpy_stage(const Groups& w, const T* buf, const float* wts,
                                           T* out, float* red, const int* s_nb,
                                           const int* s_qtok, size_t plane, int tq, int kn,
                                           int rows, int t, int d) {
  const int slots = kn + 1;
  const SlotRows<T> row_of{buf, s_nb, kn, rows, d};
  for (int qi = w.first; qi < tq; qi += w.ustep) {
    const int tok = s_qtok[qi];
    if (tok < 0) continue;
    const float* wrow = wts + qi * slots;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = 0.f;
    for (int j0 = w.sub; j0 < slots; j0 += kAxpyBatch * w.gpu) {
      const T* row[kAxpyBatch];
      float wt[kAxpyBatch];
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i) {
        const int j = j0 + i * w.gpu;
        row[i] = row_of(qi, j);
        wt[i] = row[i] != nullptr ? wrow[j] : 0.f;  // an invalid slot weighs 0 in every head
      }
#pragma unroll
      for (int i = 0; i < kAxpyBatch; ++i)
        if (row[i] != nullptr) axpy_row<T, true>(o, wt[i], row[i], w.gl, w.G, d);
    }
    if (w.gpu == 1) {
      store_row<T, true>(out + (plane * t + tok) * d, o, w.gl, w.G, d);
    } else {
      share_row<T, true>(red, qi * w.gpu + w.sub, o, w.gl, w.G, d);
    }
  }
}

// The shares of a stage's tile queries (`red` as axpy_stage filled it)
// summed in order into their rows of `out` (plane `plane`).
template <typename T>
__device__ __forceinline__ void sum_shares(T* out, const float* red, const int* s_qtok,
                                           size_t plane, int gpu, int tq, int t, int d, int tid,
                                           int nt) {
  for (int x = tid; x < tq * d; x += nt) {
    const int qi = x / d, e = x % d, tok = s_qtok[qi];
    if (tok < 0) continue;
    float sum = 0.f;
    for (int sb = 0; sb < gpu; ++sb) sum += red[(qi * gpu + sb) * d + e];
    out[(plane * t + tok) * d + e] = from_f<T>(sum);
  }
}
