// The port's host-side batch loader for uint8 memmap datasets.
//
// Three functions with a plain C interface, bound with ctypes by loader.py
// (which builds this file with g++ at first use): gather image rows by
// index from a uint8 memmap and convert them to float32 in [0, 1], rotate a
// (c, h, w) float32 image by k * 90 degrees, and gather int64 rows. The
// bindings check every index on the host before a call; nothing here does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// out[b] = src[indices[b]] * scale for the rows b0..b1. Every argument by
// value and every pointer restrict, so that the inner loop vectorises: in a
// lambda that captures by reference, each store through float* may alias
// the captured scale, which is then reloaded element by element.
void gather_rows(const uint8_t* __restrict src, const int64_t* __restrict indices,
                 int64_t b0, int64_t b1, int64_t item_elems, float scale,
                 float* __restrict out) {
    for (int64_t b = b0; b < b1; ++b) {
        const uint8_t* __restrict s = src + indices[b] * item_elems;
        float* __restrict d = out + b * item_elems;
        for (int64_t i = 0; i < item_elems; ++i) {
            d[i] = static_cast<float>(s[i]) * scale;
        }
    }
}

constexpr int64_t kTile = 32;

}  // namespace

extern "C" {

// src is (num_items, item_elems) uint8, out is (batch, item_elems) float32:
// out[b] = src[indices[b]] * scale. Rows are split over num_threads
// std::threads; one thread below 4 rows.
void gather_normalize_f32(const uint8_t* src, const int64_t* indices,
                          int64_t batch, int64_t item_elems, float scale,
                          float* out, int num_threads) {
    if (num_threads <= 1 || batch < 4) {
        gather_rows(src, indices, 0, batch, item_elems, scale, out);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (batch + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
        int64_t b0 = t * per;
        int64_t b1 = b0 + per > batch ? batch : b0 + per;
        if (b0 >= b1) break;
        threads.emplace_back(gather_rows, src, indices, b0, b1, item_elems, scale, out);
    }
    for (auto& th : threads) th.join();
}

// src (c, h, w) float32 rotated counter-clockwise by k * 90 degrees (k
// taken mod 4) into out: (c, h, w) for even k, (c, w, h) for odd k. The odd
// k transpose a plane: out is written row by row in tiles of kTile x kTile,
// so that the rows a tile reads stay in L1 (the plain loop over the input's
// rows writes with a stride of h floats and runs slower than numpy's copy).
void rot90_f32(const float* __restrict src, int64_t c, int64_t h, int64_t w, int k,
               float* __restrict out) {
    k = ((k % 4) + 4) % 4;
    for (int64_t ch = 0; ch < c; ++ch) {
        const float* __restrict s = src + ch * h * w;
        float* __restrict d = out + ch * h * w;
        if (k == 0) {
            std::memcpy(d, s, sizeof(float) * h * w);
        } else if (k == 2) {  // (i, j) -> (h - 1 - i, w - 1 - j)
            for (int64_t i = 0; i < h; ++i)
                for (int64_t j = 0; j < w; ++j)
                    d[(h - 1 - i) * w + (w - 1 - j)] = s[i * w + j];
        } else {  // out (w, h): k == 1 out(r, q) = in(q, w - 1 - r), k == 3 in(h - 1 - q, r)
            for (int64_t r0 = 0; r0 < w; r0 += kTile) {
                const int64_t r1 = std::min(r0 + kTile, w);
                for (int64_t q0 = 0; q0 < h; q0 += kTile) {
                    const int64_t q1 = std::min(q0 + kTile, h);
                    for (int64_t r = r0; r < r1; ++r)
                        for (int64_t q = q0; q < q1; ++q)
                            d[r * h + q] = k == 1 ? s[q * w + (w - 1 - r)]
                                                  : s[(h - 1 - q) * w + r];
                }
            }
        }
    }
}

// src is (num_items, item_elems) int64: out[b] = src[indices[b]].
void gather_i64(const int64_t* src, const int64_t* indices, int64_t batch,
                int64_t item_elems, int64_t* out) {
    for (int64_t b = 0; b < batch; ++b) {
        std::memcpy(out + b * item_elems, src + indices[b] * item_elems,
                    sizeof(int64_t) * item_elems);
    }
}

}  // extern "C"
