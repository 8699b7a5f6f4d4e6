// Fused leaf step + next-mover legality, one thread per board.
//
// Replaces the Pallas TPU kernel sejonggo_tpu/ops/gostep.py
// (step_legal_pallas / _step_legal_kernel).  For each board: place the
// mover's stone; remove the dead opponent groups that touch it; remove
// own groups without liberty at or next to it (the reference's
// take_stones order, play.py:182-217); write the new signed grid.  Then,
// for the next mover: the simple-ko point (exactly one stone of the next
// mover's colour gone since the parent), the capturable groups (one
// distinct liberty or none), and
//     legal = empty & ~ko & (next to empty | next to a capturable group);
// pass is always legal.  Same function as engine.step_stones_batch
// followed by engine.illegal_moves_mask_stones_batch(new, parent, -side).
//
// What bounds it: bytes.  Per board it reads N*N + 5 bytes and writes
// 2*N*N + 1 (about 25 MB at the main path's B = 98,304 leaves, 9x9:
// about 7.4 us at 3.35 TB/s).
//
// Design: the block stages its parent grids through shared memory with
// coalesced copies, and stages both outputs there before coalesced
// stores, so device memory sees each byte once.  In between each thread
// works on its own board as W = ceil(N*N/64) 64-bit words in registers:
// dilation is shifts by 1 and N with column masks, every flood stops at
// its own board's fixpoint.  Capturable groups are found group by group
// (flood from the lowest remaining stone, count the distinct empty
// neighbours with popcount), which gives the same mask as the TPU's
// distinct-liberty min/max fixpoint.  Every loop is capped at N*N + 1
// iterations and sets *err if a cap is hit.  No barrier sits inside a
// loop whose trip count differs between threads.
#include "bitboard.cuh"

namespace sejonggo {
namespace {

template <int W>
__device__ __forceinline__ void lowest_bit(const uint64_t (&a)[W],
                                           uint64_t (&out)[W]) {
  bool found = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    out[w] = found ? 0ull : (a[w] & (~a[w] + 1ull));
    found |= a[w] != 0;
  }
}

template <int W>
__global__ void step_legal_kernel(const int8_t* __restrict__ stones,
                                  const int8_t* __restrict__ sides,
                                  const int32_t* __restrict__ actions,
                                  int8_t* __restrict__ out_stones,
                                  uint8_t* __restrict__ out_illegal,
                                  int32_t* __restrict__ err, int B, int n,
                                  Masks<W> m) {
  extern __shared__ uint8_t smem[];
  const int nn = n * n;
  const int b0 = blockIdx.x * blockDim.x;
  const int nb = min((int)blockDim.x, B - b0);
  int8_t* g_tile = reinterpret_cast<int8_t*>(smem);   // [blockDim.x * nn]
  uint8_t* i_tile = smem + blockDim.x * nn;           // [blockDim.x * (nn+1)]
  const size_t goff = (size_t)b0 * nn;
  const size_t ioff = (size_t)b0 * (nn + 1);
  for (int i = threadIdx.x; i < nb * nn; i += blockDim.x)
    g_tile[i] = stones[goff + i];
  __syncthreads();

  if ((int)threadIdx.x < nb) {
    const int b = b0 + threadIdx.x;
    const int8_t side = sides[b];
    const int action = actions[b];
    int8_t* row = g_tile + threadIdx.x * nn;
    uint8_t* irow = i_tile + threadIdx.x * (nn + 1);
    bool ok = true;

    uint64_t own[W], opp[W], onehot[W], prev_opp[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint64_t o = 0, p = 0;
      for (int bit = 0; bit < 64; ++bit) {
        const int i = w * 64 + bit;
        if (i < nn) {
          const int8_t v = row[i];
          o |= (uint64_t)(v == side) << bit;
          p |= (uint64_t)(v == -side) << bit;
        }
      }
      onehot[w] = (action >= 0 && action < nn && (action >> 6) == w)
                      ? (1ull << (action & 63)) : 0ull;
      own[w] = o | onehot[w];
      opp[w] = p;
      prev_opp[w] = p;
    }

    uint64_t empty[W], t[W], alive[W], dead[W], removed[W], nb1[W];
    // opponent captures: dead groups next to the placed stone
#pragma unroll
    for (int w = 0; w < W; ++w) empty[w] = m.on[w] & ~(own[w] | opp[w]);
    dilate<W>(empty, n, m, t);
#pragma unroll
    for (int w = 0; w < W; ++w) t[w] &= opp[w];
    ok &= flood<W>(t, opp, n, m, alive);
    dilate<W>(onehot, n, m, nb1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dead[w] = opp[w] & ~alive[w];
      t[w] = dead[w] & nb1[w];
    }
    ok &= flood<W>(t, dead, n, m, removed);
#pragma unroll
    for (int w = 0; w < W; ++w) opp[w] &= ~removed[w];

    // own suicide: own groups without liberty at or next to the stone
#pragma unroll
    for (int w = 0; w < W; ++w) empty[w] = m.on[w] & ~(own[w] | opp[w]);
    dilate<W>(empty, n, m, t);
#pragma unroll
    for (int w = 0; w < W; ++w) t[w] &= own[w];
    ok &= flood<W>(t, own, n, m, alive);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dead[w] = own[w] & ~alive[w];
      t[w] = dead[w] & (nb1[w] | onehot[w]);
    }
    ok &= flood<W>(t, dead, n, m, removed);
#pragma unroll
    for (int w = 0; w < W; ++w) own[w] &= ~removed[w];

    // legality for the next mover: its stones are opp, its targets own
    uint64_t ko[W], capt[W], remaining[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ko[w] = prev_opp[w] & ~opp[w];
      empty[w] = m.on[w] & ~(own[w] | opp[w]);
      capt[w] = 0;
      remaining[w] = own[w];
    }
    const bool single_ko = popcount<W>(ko) == 1;
    bool groups_done = false;
    for (int g = 0; g < nn + 1; ++g) {
      if (!any<W>(remaining)) {
        groups_done = true;
        break;
      }
      uint64_t seed[W], grp[W], libs[W];
      lowest_bit<W>(remaining, seed);
      ok &= flood<W>(seed, remaining, n, m, grp);
      dilate<W>(grp, n, m, libs);
#pragma unroll
      for (int w = 0; w < W; ++w) libs[w] &= empty[w];
      const bool capturable = popcount<W>(libs) <= 1;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (capturable) capt[w] |= grp[w];
        remaining[w] &= ~grp[w];
      }
    }
    ok &= groups_done;

    uint64_t breath_e[W], breath_c[W];
    dilate<W>(empty, n, m, breath_e);
    dilate<W>(capt, n, m, breath_c);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t legal = empty[w] & ~(single_ko ? ko[w] : 0ull)
                             & (breath_e[w] | breath_c[w]);
      for (int bit = 0; bit < 64; ++bit) {
        const int i = w * 64 + bit;
        if (i < nn) {
          const bool is_own = (own[w] >> bit) & 1ull;
          const bool is_opp = (opp[w] >> bit) & 1ull;
          row[i] = is_own ? side : (is_opp ? (int8_t)-side : (int8_t)0);
          irow[i] = (uint8_t)(((legal >> bit) & 1ull) ^ 1ull);
        }
      }
    }
    irow[nn] = 0;  // pass is always legal
    if (!ok) atomicOr(err, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * nn; i += blockDim.x)
    out_stones[goff + i] = g_tile[i];
  for (int i = threadIdx.x; i < nb * (nn + 1); i += blockDim.x)
    out_illegal[ioff + i] = i_tile[i];
}

template <int W>
int launch(const int8_t* stones, const int8_t* sides, const int32_t* actions,
           int8_t* out_stones, uint8_t* out_illegal, int32_t* err, int B,
           int n, cudaStream_t stream) {
  const int per_board = n * n + (n * n + 1);
  const int threads = threads_for(per_board);
  const int blocks = (B + threads - 1) / threads;
  const size_t shmem = (size_t)threads * per_board;
  step_legal_kernel<W><<<blocks, threads, shmem, stream>>>(
      stones, sides, actions, out_stones, out_illegal, err, B, n,
      make_masks<W>(n));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sejonggo

// stones: (B, N, N) int8 signed parent grids; sides: (B,) int8 movers
// (+-1); actions: (B,) int32 in [0, N*N] (N*N = pass); out_stones:
// (B, N, N) int8; out_illegal: (B, N*N+1) bytes of 0/1 (torch.bool) for
// the next mover; err: one int32 set nonzero if an iteration cap was
// hit.  Returns the CUDA error of the launch (0 = launched).
extern "C" int sejonggo_step_legal(const void* stones, const void* sides,
                                   const void* actions, void* out_stones,
                                   void* out_illegal, void* err, int B, int n,
                                   cudaStream_t stream) {
  using namespace sejonggo;
  if (B <= 0 || n < 2 || n > kMaxSize) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const int8_t*>(stones);
  const auto* sd = static_cast<const int8_t*>(sides);
  const auto* a = static_cast<const int32_t*>(actions);
  auto* os = static_cast<int8_t*>(out_stones);
  auto* oi = static_cast<uint8_t*>(out_illegal);
  auto* e = static_cast<int32_t*>(err);
  switch ((n * n + 63) / 64) {
    case 1: return launch<1>(s, sd, a, os, oi, e, B, n, stream);
    case 2: return launch<2>(s, sd, a, os, oi, e, B, n, stream);
    case 3: return launch<3>(s, sd, a, os, oi, e, B, n, stream);
    case 4: return launch<4>(s, sd, a, os, oi, e, B, n, stream);
    case 5: return launch<5>(s, sd, a, os, oi, e, B, n, stream);
    case 6: return launch<6>(s, sd, a, os, oi, e, B, n, stream);
  }
  return (int)cudaErrorInvalidValue;
}
