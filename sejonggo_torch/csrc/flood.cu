// Batched flood fill to a fixpoint, one thread per board.
//
// Replaces the Pallas TPU kernel sejonggo_tpu/ops/flood.py
// (flood_fixpoint_pallas / _flood_kernel): out = the region reachable from
// seed & allowed by 4-neighbour steps inside allowed.
//
// What bounds it: bytes.  Per board it reads 2*N*N bytes and writes N*N
// (0.75 MB at B=3072, 9x9: about 0.22 us at 3.35 TB/s), against a few
// hundred register operations per board, so at the main path's B=3072
// one launch's latency dominates: the floor is the time of one block.
//
// Design: small blocks of kBoards boards (one warp), so that the main
// path's 3072 boards spread over 96 SMs instead of 24; every block runs
// the same short serial chain as the one-block floor.  The block brings
// its boards' seed and allowed bytes in as two bulk asynchronous copies
// (TMA, completion on an mbarrier) and stores its result as one, with
// 16-byte or byte copies for a ragged or unaligned range (bitboard.cuh).
// Each thread packs its board four bytes at a time (funnel shift,
// __vcmpne4, a multiply gathering four bits into a nibble) into
// W = ceil(N*N/64) 64-bit words, iterates the dilation (shifts by 1 and N
// with column masks) to its own fixpoint, and unpacks with aligned
// 32-bit stores.  The loop is capped at N*N + 1 iterations; a hit cap ORs
// bit 2 into the error word (ops/errors.py), which the host reads once a
// move.  No barrier sits inside a loop whose trip count differs between
// threads.
#include "bitboard.cuh"

namespace sejonggo {
namespace {

constexpr int kBoards = 32;      // boards (= threads) per block
constexpr int32_t kErrBit = 2;   // ops/errors.py: FLOOD

template <int W>
__global__ void __launch_bounds__(kBoards)
flood_kernel(const uint8_t* __restrict__ seed,
             const uint8_t* __restrict__ allowed, uint8_t* __restrict__ out,
             int32_t* __restrict__ err, int B, int n, Masks<W> m) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar;
  const int nn = n * n;
  const int b0 = blockIdx.x * kBoards;
  const int nb = min(kBoards, B - b0);
  const int tile = round16(kBoards * nn + 8);   // + the packing over-read
  uint8_t* s_tile = smem;
  uint8_t* a_tile = smem + tile;
  uint8_t* o_tile = smem + 2 * tile;
  const size_t off = (size_t)b0 * nn;
  tiles_in(&bar, s_tile, seed + off, nb * nn, a_tile, allowed + off, nb * nn);

  const int t = threadIdx.x;
  if (t < nb) {
    uint64_t s[W], a[W], r[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = a[w] = 0;
    for_each_word<W>(s_tile, t * nn, nn, [&](int j, uint32_t x) {
      s[j >> 4] |= (uint64_t)nibble(__vcmpne4(x, 0u)) << (4 * (j & 15));
    });
    for_each_word<W>(a_tile, t * nn, nn, [&](int j, uint32_t x) {
      a[j >> 4] |= (uint64_t)nibble(__vcmpne4(x, 0u)) << (4 * (j & 15));
    });
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] &= m.on[w];
    if (!flood<W>(s, a, n, m, r)) atomicOr(err, kErrBit);
    write_row<W>(o_tile, t * nn, nn,
                 [&](int k) { return spread(nibble_of<W>(r, k)); });
  }
  tiles_out(out + off, o_tile, nb * nn, nullptr, nullptr, 0);
}

size_t shmem_bytes(int n) { return 3 * (size_t)round16(kBoards * n * n + 8); }

template <int W>
int launch(const uint8_t* seed, const uint8_t* allowed, uint8_t* out,
           int32_t* err, int B, int n, cudaStream_t stream) {
  const int blocks = (B + kBoards - 1) / kBoards;
  flood_kernel<W><<<blocks, kBoards, shmem_bytes(n), stream>>>(
      seed, allowed, out, err, B, n, make_masks<W>(n));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sejonggo

// seed, allowed, out: (B, N, N) bytes of 0/1 (torch.bool); err: the
// device's int32 error word, bit 2 set if an iteration cap was hit.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int sejonggo_flood(const void* seed, const void* allowed,
                              void* out, void* err, int B, int n,
                              cudaStream_t stream) {
  using namespace sejonggo;
  if (B <= 0 || n < 2 || n > kMaxSize) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const uint8_t*>(seed);
  const auto* a = static_cast<const uint8_t*>(allowed);
  auto* o = static_cast<uint8_t*>(out);
  auto* e = static_cast<int32_t*>(err);
  switch ((n * n + 63) / 64) {
    case 1: return launch<1>(s, a, o, e, B, n, stream);
    case 2: return launch<2>(s, a, o, e, B, n, stream);
    case 3: return launch<3>(s, a, o, e, B, n, stream);
    case 4: return launch<4>(s, a, o, e, B, n, stream);
    case 5: return launch<5>(s, a, o, e, B, n, stream);
    case 6: return launch<6>(s, a, o, e, B, n, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Boards per block of the launch (any board size).
extern "C" int sejonggo_flood_block(int) { return sejonggo::kBoards; }
