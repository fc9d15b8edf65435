// Attention dropout of the Sparse3DNA kernels (sparse3dna_fwd.cu and
// sparse3dna_bwd_q.cu) and of the SparseCross2DNA kernels
// (sparse_cross2dna_fwd.cu and sparse_cross2dna_bwd_q.cu), one counter hash
// for all four.
//
// The mask is inverted dropout on the mixed probabilities (after the
// talking-heads mix, before PV): a (head, query, slot) factor that is the
// fp32 scale 1 / keep where the hash keeps the pair and 0 where it drops it.
// It is a function of (seed, batch row, head, query token, key token) and of
// nothing else, so the forward and the backward draw the same bits, any
// recompute replays them, and a shard of the sequence draws the ones the
// whole sequence would. The hash is `_coord_keep_mask` of nuwa_tpu/nda.py,
// the twin of the Pallas kernels' `_keep_mask_abs` (nda_pallas.py:91), in
// uint32 arithmetic that wraps:
//
//   s    = h(seed * 0x9E3779B9 + batch + 0x85EBCA6B)
//   e    = query * 0x27D4EB2F ^ key * 0x165667B1 ^ head * 0x9E3779B9
//   keep = h(e ^ s) >= thresh
//
// with h the splitmix32 avalanche of `_hash_u32` (nda_pallas.py:63-67),
// query and key the token ids after bos (0..t-1) and the bos column's key
// id the sentinel -2 as uint32. In the cross kernels the query is the video
// token after bos (0..t-1) and the key the context token, frame * HW +
// y * fmap + x, which is what their neighbour list holds, so `slot_key`
// serves them too; their null column takes the bos column's -2, as the
// Pallas kernels key it (nda_pallas.py:2759, :2844, :2906). The wrapper
// computes thresh = round((1 - keep) * 2^32) and the scale in Python, as
// the JAX package does.
#pragma once

#include <cstdint>

struct Dropout {
  int on;           // 0: no dropout (the other fields are not read)
  uint32_t seed;
  uint32_t thresh;  // a pair is kept where its hash >= thresh
  float scale;      // fp32 1 / keep
};

constexpr uint32_t kBosKey = 0xFFFFFFFEu;  // the bos column's key id, -2

__device__ __forceinline__ uint32_t avalanche(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The hash's stream for one batch row: s above.
__device__ __forceinline__ uint32_t drop_stream(const Dropout& dp, int batch) {
  return avalanche(dp.seed * 0x9E3779B9u + static_cast<uint32_t>(batch) + 0x85EBCA6Bu);
}

// The factor of the mixed probability of (head, query, key): the scale where
// the pair is kept, 0 where it is dropped.
__device__ __forceinline__ float keep_factor(const Dropout& dp, uint32_t stream, int head,
                                             int query, uint32_t key) {
  const uint32_t e = static_cast<uint32_t>(query) * 0x27D4EB2Fu ^ key * 0x165667B1u ^
                     static_cast<uint32_t>(head) * 0x9E3779B9u;
  return avalanche(e ^ stream) >= dp.thresh ? dp.scale : 0.f;
}

// The key id of slot j of a query whose neighbours are nb (slot 0 is bos, or
// the cross kernels' null column; a neighbour of -1, outside the grid or
// masked, has probability 0, so its id is moot).
__device__ __forceinline__ uint32_t slot_key(const int* nb, int j) {
  return j == 0 ? kBosKey : static_cast<uint32_t>(nb[j - 1]);
}
