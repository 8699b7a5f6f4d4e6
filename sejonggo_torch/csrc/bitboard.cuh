// Bitboards for the Go kernels: one board of N*N <= 361 points held as
// W = ceil(N*N/64) 64-bit words in registers of one thread.  Point
// i = y*N + x is bit (i & 63) of word (i >> 6).  Every loop over words is
// unrolled at compile time (W is a template parameter), so the words stay
// in registers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sejonggo {

constexpr int kMaxSize = 19;
constexpr int kMaxWords = (kMaxSize * kMaxSize + 63) / 64;  // 6

// Per-size column masks, built on the host and passed by value (they
// land in the kernel's constant parameter bank).
template <int W>
struct Masks {
  uint64_t on[W];         // on-board points, i < N*N
  uint64_t not_left[W];   // on board and x != 0
  uint64_t not_right[W];  // on board and x != N-1
};

template <int W>
inline Masks<W> make_masks(int n) {
  Masks<W> m;
  for (int w = 0; w < W; ++w) m.on[w] = m.not_left[w] = m.not_right[w] = 0;
  for (int i = 0; i < n * n; ++i) {
    const uint64_t bit = 1ull << (i & 63);
    m.on[i >> 6] |= bit;
    if (i % n != 0) m.not_left[i >> 6] |= bit;
    if (i % n != n - 1) m.not_right[i >> 6] |= bit;
  }
  return m;
}

// bit i of out = bit (i - s) of a, for 0 < s < 64
template <int W>
__device__ __forceinline__ void shl(const uint64_t (&a)[W], int s,
                                    uint64_t (&out)[W]) {
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    uint64_t v = a[w] << s;
    if (w > 0) v |= a[w > 0 ? w - 1 : 0] >> (64 - s);
    out[w] = v;
  }
}

// bit i of out = bit (i + s) of a, for 0 < s < 64
template <int W>
__device__ __forceinline__ void shr(const uint64_t (&a)[W], int s,
                                    uint64_t (&out)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint64_t v = a[w] >> s;
    if (w < W - 1) v |= a[w < W - 1 ? w + 1 : w] << (64 - s);
    out[w] = v;
  }
}

// 4-neighbourhood dilation: a point is set when an orthogonal
// neighbour on the board is set.
template <int W>
__device__ __forceinline__ void dilate(const uint64_t (&a)[W], int n,
                                       const Masks<W>& m,
                                       uint64_t (&out)[W]) {
  uint64_t l[W], r[W], u[W], d[W];
  shl<W>(a, 1, l);  // from the left neighbour
  shr<W>(a, 1, r);  // from the right neighbour
  shl<W>(a, n, u);  // from the point above
  shr<W>(a, n, d);  // from the point below
#pragma unroll
  for (int w = 0; w < W; ++w)
    out[w] = ((l[w] & m.not_left[w]) | (r[w] & m.not_right[w]) | u[w] | d[w])
             & m.on[w];
}

// Grow seed & allowed inside allowed to the fixpoint.  A region of the
// board is covered within N*N - 1 steps, so the loop is capped at
// N*N + 1 iterations; returns false if the cap was hit.
template <int W>
__device__ __forceinline__ bool flood(const uint64_t (&seed)[W],
                                      const uint64_t (&allowed)[W], int n,
                                      const Masks<W>& m, uint64_t (&out)[W]) {
  uint64_t cur[W], d[W];
#pragma unroll
  for (int w = 0; w < W; ++w) cur[w] = seed[w] & allowed[w];
  const int cap = n * n + 1;
  for (int it = 0; it < cap; ++it) {
    dilate<W>(cur, n, m, d);
    bool changed = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t nxt = cur[w] | (allowed[w] & d[w]);
      changed |= nxt != cur[w];
      cur[w] = nxt;
    }
    if (!changed) {
#pragma unroll
      for (int w = 0; w < W; ++w) out[w] = cur[w];
      return true;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = cur[w];
  return false;
}

template <int W>
__device__ __forceinline__ bool any(const uint64_t (&a)[W]) {
  uint64_t acc = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) acc |= a[w];
  return acc != 0;
}

template <int W>
__device__ __forceinline__ int popcount(const uint64_t (&a)[W]) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) c += __popcll(a[w]);
  return c;
}

// Threads per block such that a block's staging tiles of
// `bytes_per_board` bytes each fit the default 48 KB of shared memory.
inline int threads_for(int bytes_per_board) {
  int threads = 128;
  while (threads > 32 && threads * bytes_per_board > 48 * 1024) threads /= 2;
  return threads;
}

}  // namespace sejonggo
