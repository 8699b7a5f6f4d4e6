// Batched flood fill to a fixpoint, one thread per board.
//
// Replaces the Pallas TPU kernel sejonggo_tpu/ops/flood.py
// (flood_fixpoint_pallas / _flood_kernel): out = the region reachable from
// seed & allowed by 4-neighbour steps inside allowed.
//
// What bounds it: bytes.  Per board it reads 2*N*N bytes and writes N*N
// (0.75 MB at B=3072, 9x9: about 0.22 us at 3.35 TB/s), against a few
// hundred register operations per board, so at the main path's B=3072
// the launch latency dominates.
//
// Design: the block stages its boards' seed and allowed bytes through
// shared memory with coalesced copies; each thread then packs its board
// into W = ceil(N*N/64) 64-bit words in registers and iterates the
// dilation (shifts by 1 and N with column masks) until nothing changes.
// Each board stops at its own fixpoint; the loop is capped at N*N + 1
// iterations and sets *err if the cap is ever hit.  No barrier sits
// inside a loop whose trip count differs between threads.
#include "bitboard.cuh"

namespace sejonggo {
namespace {

template <int W>
__global__ void flood_kernel(const uint8_t* __restrict__ seed,
                             const uint8_t* __restrict__ allowed,
                             uint8_t* __restrict__ out,
                             int32_t* __restrict__ err, int B, int n,
                             Masks<W> m) {
  extern __shared__ uint8_t smem[];
  const int nn = n * n;
  const int b0 = blockIdx.x * blockDim.x;
  const int nb = min((int)blockDim.x, B - b0);
  uint8_t* s_tile = smem;                      // [blockDim.x * nn]
  uint8_t* a_tile = smem + blockDim.x * nn;    // [blockDim.x * nn]
  const size_t off = (size_t)b0 * nn;
  for (int i = threadIdx.x; i < nb * nn; i += blockDim.x) {
    s_tile[i] = seed[off + i];
    a_tile[i] = allowed[off + i];
  }
  __syncthreads();

  if ((int)threadIdx.x < nb) {
    uint8_t* srow = s_tile + threadIdx.x * nn;
    const uint8_t* arow = a_tile + threadIdx.x * nn;
    uint64_t s[W], a[W], r[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint64_t sv = 0, av = 0;
      for (int bit = 0; bit < 64; ++bit) {
        const int i = w * 64 + bit;
        if (i < nn) {
          sv |= (uint64_t)(srow[i] != 0) << bit;
          av |= (uint64_t)(arow[i] != 0) << bit;
        }
      }
      s[w] = sv;
      a[w] = av;
    }
    if (!flood<W>(s, a, n, m, r)) atomicOr(err, 1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      for (int bit = 0; bit < 64; ++bit) {
        const int i = w * 64 + bit;
        if (i < nn) srow[i] = (uint8_t)((r[w] >> bit) & 1ull);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * nn; i += blockDim.x) out[off + i] = s_tile[i];
}

template <int W>
int launch(const uint8_t* seed, const uint8_t* allowed, uint8_t* out,
           int32_t* err, int B, int n, cudaStream_t stream) {
  const int threads = threads_for(2 * n * n);
  const int blocks = (B + threads - 1) / threads;
  const size_t shmem = (size_t)threads * 2 * n * n;
  flood_kernel<W><<<blocks, threads, shmem, stream>>>(
      seed, allowed, out, err, B, n, make_masks<W>(n));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sejonggo

// seed, allowed, out: (B, N, N) bytes of 0/1 (torch.bool); err: one
// int32 set nonzero if an iteration cap was hit.  Returns the CUDA error
// of the launch (0 = launched).
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
