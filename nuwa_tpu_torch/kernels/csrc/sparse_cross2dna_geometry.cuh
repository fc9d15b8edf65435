// The SparseCross2DNA window and tiles, shared by the forward and both
// backward kernels (sparse_cross2dna_fwd.cu, sparse_cross2dna_bwd_q.cu,
// sparse_cross2dna_bwd_kv.cu), so that the query side's window and the key
// side's inverse of it live in one place.
//
// Every video query at spatial position (y, x) of any query frame reads,
// through window slot j = c*k*k + a*k + e (0..Fc*k*k-1; slot 0 of a row of
// probabilities is the null key, so this is column j + 1), the context token
// (c, y + (a-half)*dil, x + (e-half)*dil), half = (k-1)/2, where that lies
// in the frame and the context mask allows it. The query frames all read the
// same window: the window depends on the position alone. So the key at
// (y, x) of context frame c is read through the slot c*k*k + a*k + e by the
// queries at (y - (a-half)*dil, x - (e-half)*dil) (the window reflected) of
// every query frame, where that position lies in the frame and its token is
// below t.
//
// Tiles (the plan's fields, sparse3dna_tile.cuh): the forward's block owns
// ty x tx query positions of p.tf consecutive query frames (its queries
// qi = frame * ty*tx + row * tx + column), which share one slot table; the
// key side's block owns ty x tx keys of one context frame and p.hs of the
// heads (the grid's blocks run over head groups fastest).
#pragma once

#include "sparse3dna_tile.cuh"

struct CrossGeometry {
  int t;     // video queries (rows of q)
  int lc;    // context tokens: whole frames of fmap * fmap
  int fmap;  // side of a context frame (and of a query frame)
  int k;     // window side, odd
  int dil;   // window step
};

// Context token of window slot j (0..kn-1) of the query at (y, x), or -1
// outside the frame or where the context mask (`row`, the batch row's
// bytes, or null) refuses it. Slot j is context frame j / (k*k), window
// position j % (k*k) row-major, as the plain version's table enumerates
// them.
__device__ __forceinline__ int cross_neighbour(const CrossGeometry& g,
                                               const unsigned char* row, int y, int x, int j) {
  const int kk = g.k * g.k, c = j / kk, r = j % kk, half = (g.k - 1) / 2;
  const int ny = y + (r / g.k - half) * g.dil, nx = x + (r % g.k - half) * g.dil;
  if (ny < 0 || ny >= g.fmap || nx < 0 || nx >= g.fmap) return -1;
  const int tok = (c * g.fmap + ny) * g.fmap + nx;
  return row != nullptr && !row[tok] ? -1 : tok;
}

// What a forward block knows of its tile: the first of its query frames,
// the tile's origin in the frame, and its queries, tf * ty * tx.
struct CrossQueryTile {
  int f0, y0, x0, tq;
};

__device__ __forceinline__ CrossQueryTile cross_query_tile(const Plan& p) {
  const int tiles = p.tiles_y * p.tiles_x;
  const int ti = blockIdx.x % tiles;
  return CrossQueryTile{static_cast<int>(blockIdx.x) / tiles * p.tf, (ti / p.tiles_x) * p.ty,
                        (ti % p.tiles_x) * p.tx, p.tf * p.ty * p.tx};
}

// Video token of the tile's query qi, or -1 outside the frame or at or past t.
__device__ __forceinline__ int cross_tile_query(const CrossGeometry& g, const Plan& p,
                                                const CrossQueryTile& v, int qi) {
  const int txy = p.ty * p.tx, r = qi % txy;
  const int f = v.f0 + qi / txy, y = v.y0 + r / p.tx, x = v.x0 + r % p.tx;
  if (y >= g.fmap || x >= g.fmap) return -1;
  const int tok = (f * g.fmap + y) * g.fmap + x;
  return tok < g.t ? tok : -1;
}

// What a key-side block knows of its tile: the context frame, the tile's
// origin in it, its keys (ty * tx), and its heads h0 .. h0 + hn - 1.
struct CrossKeyTile {
  int c, y0, x0, tq, h0, hn;
};

__device__ __forceinline__ CrossKeyTile cross_key_tile(const Plan& p, int heads) {
  const int hblocks = (heads + p.hs - 1) / p.hs, tiles = p.tiles_y * p.tiles_x;
  const int hb = blockIdx.x % hblocks, rest = blockIdx.x / hblocks, ti = rest % tiles;
  const int h0 = hb * p.hs;
  return CrossKeyTile{rest / tiles, (ti / p.tiles_x) * p.ty, (ti % p.tiles_x) * p.tx,
                      p.ty * p.tx, h0, min(p.hs, heads - h0)};
}
