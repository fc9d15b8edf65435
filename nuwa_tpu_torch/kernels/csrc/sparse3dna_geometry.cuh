// The Sparse3DNA window geometry, shared by the forward and both backward
// kernels (sparse3dna_fwd.cu, sparse3dna_bwd_q.cu, sparse3dna_bwd_kv.cu), so
// that the query side's neighbour rule and the key side's inverse of it live
// in one place.
//
// Three modes. Causal windows (the video decoder) and centered ones (the
// sketch encoder) offset a query's (frame, row, column) by (a - c)*d on each
// axis of kernel k and dilation d, with c = k - 1 when causal and (k - 1)/2
// when centered. The audio geometry is SparseCausal2DNA's grid of
// (timesteps, 1, H): the time axis is causal with kernel Kf and dilation df,
// and on the width axis the window is the whole timestep, the absolute
// columns 0..H-1 (kw = fw = H), not offsets around the query. A neighbour
// counts when it lies in the grid and before the sequence end t.
#pragma once

struct Geometry {
  int t;           // valid tokens (rows of q, k, v)
  int fh, fw;      // frame height and width
  int kf, kh, kw;  // kernel size per axis
  int df, dh, dw;  // dilation per axis
  int mode;        // kCentered, kCausal or kAudio
};

constexpr int kCentered = 0, kCausal = 1, kAudio = 2;

// The query window of a launch of the three kernels (not of the staged
// variants): the queries are the tokens [q_lo, q_hi) of the t keys, q_lo the
// first token of a frame, and q, the output, lse, dS and mix hold their rows
// in that order, q_hi - q_lo of them a (batch row, head) plane; tok0 is the
// id of key token 0 in the whole sequence, which the dropout hash keys. A
// shard of a context-parallel run (nuwa_tpu_torch/parallel/context_parallel.py)
// passes its own frames as the window of a key buffer that adds its halo
// frames, and the buffer's first token as tok0; the whole sequence is
// {0, t, 0}.
struct Window {
  int q_lo, q_hi, tok0;
};

// Row of query token `tok` (q_lo <= tok < q_hi) in plane `plane` of a
// windowed tensor.
__device__ __forceinline__ size_t window_row(const Window& w, size_t plane, int tok) {
  return plane * static_cast<size_t>(w.q_hi - w.q_lo) + static_cast<size_t>(tok - w.q_lo);
}

// The window's centre on an axis of kernel k.
__device__ __forceinline__ int centre(const Geometry& g, int k) {
  return g.mode != kCentered ? k - 1 : (k - 1) / 2;
}

// Token id of the neighbour of (f, y, x) through window slot j, or -1 where
// it lies outside the grid or at or past t. Slot j enumerates (a, b, c)
// row-major over (kf, kh, kw); in the audio geometry the column is c itself.
__device__ __forceinline__ int neighbour(const Geometry& g, int f, int y, int x, int j) {
  const int a = j / (g.kh * g.kw), r = j % (g.kh * g.kw);
  const int nf = f + (a - centre(g, g.kf)) * g.df;
  const int ny = y + (r / g.kw - centre(g, g.kh)) * g.dh;
  const int nx = g.mode == kAudio ? r % g.kw : x + (r % g.kw - centre(g, g.kw)) * g.dw;
  if (nf < 0 || ny < 0 || ny >= g.fh || nx < 0 || nx >= g.fw) return -1;
  const int tok = (nf * g.fh + ny) * g.fw + nx;
  return tok < g.t ? tok : -1;
}

// The inverse of `neighbour` for the key (f, y, x), a token below t: the
// query of its pair p = tap + c, p in 0..kf*kh*kw-1 (tap = p - p % kw, the
// pair's (a, b), and c in 0..kw-1), or -1 where that query lies outside the
// grid (checked per axis: a flat index would wrap across rows) or at or past
// t. `reader_slot` gives the slot through which that query reads the key.
//
// Causal and centered windows map one query to one key per slot, so pair p
// is slot p and its query is the key's coordinates less the slot's offset:
// the window reflected. In the audio geometry the key (s, c) is read through
// the one slot tap + x of its time tap a by every query of timestep
// s - (a - cf)*df, its H columns alike: pair tap + c is the query
// (s - (a - cf)*df, y, c) through slot tap + x. The pairs number kf*kh*kw in
// both cases (kh = 1, kw = H in the audio geometry).
__device__ __forceinline__ int reader(const Geometry& g, int f, int y, int x, int p) {
  const int a = p / (g.kh * g.kw), r = p % (g.kh * g.kw);
  const int qf = f - (a - centre(g, g.kf)) * g.df;
  const int qy = y - (r / g.kw - centre(g, g.kh)) * g.dh;
  const int qx = g.mode == kAudio ? r % g.kw : x - (r % g.kw - centre(g, g.kw)) * g.dw;
  if (qf < 0 || qy < 0 || qy >= g.fh || qx < 0 || qx >= g.fw) return -1;
  const int tok = (qf * g.fh + qy) * g.fw + qx;
  return tok < g.t ? tok : -1;
}

__device__ __forceinline__ int reader_slot(const Geometry& g, int x, int tap, int c) {
  return g.mode == kAudio ? tap + x : tap + c;
}
