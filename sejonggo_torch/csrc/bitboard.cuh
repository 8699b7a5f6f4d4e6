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

// ---------------------------------------------------------------------
// Word-wide packing.  A board's bytes sit in a shared tile at any byte
// offset; they are read and written four at a time as 32-bit words.

// Bit 0 of each byte of m (0x00 or 0xff per byte) gathered into a nibble,
// byte k -> bit k.  The four products land on distinct bits: no carries.
__device__ __forceinline__ uint32_t nibble(uint32_t m) {
  return ((m & 0x01010101u) * 0x10204080u) >> 28;
}

// The inverse: bit k of a nibble -> byte k as 0x00 or 0x01.
__device__ __forceinline__ uint32_t spread(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Nibble k (points 4k..4k+3) of a bitboard; 0 past its last word.
template <int W>
__device__ __forceinline__ uint32_t nibble_of(const uint64_t (&a)[W], int k) {
  return k < 16 * W ? (uint32_t)(a[k < 16 * W ? k >> 4 : 0] >> (4 * (k & 15))) & 0xfu
                    : 0u;
}

// Calls f(j, word) for j = 0 .. ceil(len/4)-1, word = bytes 4j..4j+3 of the
// row of `len` <= 64*W bytes that starts at byte `start` of a shared tile
// (byte 4j in the low byte).  Aligned 32-bit loads joined with a funnel
// shift; the tile must be readable up to 8 bytes past the row (the bytes
// past the row are passed on, the caller masks them).  j is a constant
// after unrolling, so f can index register arrays with it.
template <int W, class F>
__device__ __forceinline__ void for_each_word(const uint8_t* tile, int start,
                                              int len, F f) {
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile + (start & ~3));
  const int sh = 8 * (start & 3);
  uint32_t lo = t32[0];
#pragma unroll
  for (int j = 0; j < 16 * W; ++j) {
    if (4 * j < len) {
      const uint32_t hi = t32[j + 1];
      f(j, __funnelshift_r(lo, hi, sh));
      lo = hi;
    }
  }
}

// Writes the row of `len` <= 64*W + 1 bytes that starts at byte `start` of
// a shared tile, from word(k) = its bytes 4k..4k+3: aligned 32-bit stores
// inside the row, byte stores for the at most 3 + 3 bytes at its two
// ragged ends, so no store touches a byte of a neighbouring row.
template <int W, class G>
__device__ __forceinline__ void write_row(uint8_t* tile, int start, int len,
                                          G word) {
  const int d = start & 3;
  uint8_t* base = tile + (start - d);
  uint32_t prev = 0;
#pragma unroll
  for (int k = 0; k < 16 * W + 2; ++k) {
    if (4 * k < len + d) {
      const uint32_t cur = word(k);
      // tile bytes base+4k .. +3 hold row bytes 4k-d .. 4k-d+3
      const uint32_t v = __funnelshift_l(prev, cur, 8 * d);
      const int first = 4 * k - d;
      if (first >= 0 && first + 4 <= len) {
        *reinterpret_cast<uint32_t*>(base + 4 * k) = v;
      } else {
        for (int i = 0; i < 4; ++i)
          if (first + i >= 0 && first + i < len)
            base[4 * k + i] = (uint8_t)(v >> (8 * i));
      }
      prev = cur;
    }
  }
}

// ---------------------------------------------------------------------
// Moving a block's tiles between device and shared memory.  A contiguous
// range whose address is 16-byte aligned and whose size is a multiple of
// 16 goes as one bulk asynchronous copy (TMA); any other range (the
// ragged last block, or a tensor that starts off alignment) as 16-byte
// vector copies where both ends allow it, else byte by byte.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bulk_ok(const void* g, int bytes) {
  return ((reinterpret_cast<uintptr_t>(g) | (uintptr_t)bytes) & 15) == 0 &&
         bytes > 0;
}

// Cooperative copy by all threads of the block (no barrier inside).
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int bytes) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = n16 << 4;
  }
  for (int i = done + threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
}

// Loads up to two ranges into shared memory and returns once they are
// there (all threads call it; it ends in a barrier).  `bar` is an
// mbarrier in shared memory used once per launch.
__device__ __forceinline__ void tiles_in(uint64_t* bar, uint8_t* s0,
                                         const uint8_t* g0, int n0,
                                         uint8_t* s1, const uint8_t* g1,
                                         int n1) {
  const bool bulk0 = bulk_ok(g0, n0), bulk1 = n1 > 0 && bulk_ok(g1, n1);
  const uint32_t b = smem_addr(bar);
  if (bulk0 || bulk1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const int tx = (bulk0 ? n0 : 0) + (bulk1 ? n1 : 0);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(b), "r"(tx) : "memory");
      if (bulk0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            ::"r"(smem_addr(s0)), "l"(g0), "r"(n0), "r"(b) : "memory");
      if (bulk1)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            ::"r"(smem_addr(s1)), "l"(g1), "r"(n1), "r"(b) : "memory");
    }
  }
  if (!bulk0) copy_bytes(s0, g0, n0);
  if (n1 > 0 && !bulk1) copy_bytes(s1, g1, n1);
  // the init above must be seen before any thread waits on the barrier
  __syncthreads();
  if (bulk0 || bulk1) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(b) : "memory");
  }
}

// Stores up to two shared ranges to device memory (all threads call it,
// after their last write to the tiles).
__device__ __forceinline__ void tiles_out(uint8_t* g0, const uint8_t* s0,
                                          int n0, uint8_t* g1,
                                          const uint8_t* s1, int n1) {
  const bool bulk0 = bulk_ok(g0, n0), bulk1 = n1 > 0 && bulk_ok(g1, n1);
  // make this thread's shared writes visible to the bulk copy engine
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && (bulk0 || bulk1)) {
    if (bulk0)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(g0), "r"(smem_addr(s0)), "r"(n0) : "memory");
    if (bulk1)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(g1), "r"(smem_addr(s1)), "r"(n1) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  if (!bulk0) copy_bytes(g0, s0, n0);
  if (n1 > 0 && !bulk1) copy_bytes(g1, s1, n1);
  if (threadIdx.x == 0 && (bulk0 || bulk1))
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) & ~15; }

// The largest board size whose N*N points fit W words.
inline int max_size(int W) {
  int n = 2;
  while (n < kMaxSize && (n + 1) * (n + 1) <= 64 * W) ++n;
  return n;
}

}  // namespace sejonggo
