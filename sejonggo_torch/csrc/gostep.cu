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
// Design:
// - A block of kBoards boards reads one contiguous range of parent grids
//   and writes two contiguous ranges, so each moves as one bulk
//   asynchronous copy (TMA, completion on an mbarrier) between device and
//   shared memory; a ragged or unaligned range falls back to 16-byte or
//   byte copies (bitboard.cuh: tiles_in / tiles_out).
// - Each thread owns one board as W = ceil(N*N/64) 64-bit words in
//   registers.  It packs its row four bytes at a time (funnel shift for
//   the unaligned start, __vcmpeq4, a multiply gathering four compare
//   bits into a nibble) and unpacks the same way (a multiply spreading a
//   nibble to four bytes, aligned 32-bit stores).
// - Dilation is shifts by 1 and N with column masks; every flood stops at
//   its own board's fixpoint.
// - Capturable groups: a group that holds a stone with two empty
//   neighbours, or two neighbouring stones with an empty neighbour each,
//   has two liberties, so one flood from those stones removes every such
//   group at once.  Of the groups left (mostly groups in atari), a lone
//   stone is capturable as it stands; only the others are walked one by
//   one: flood from the lowest remaining stone, popcount its empty
//   neighbours.  This gives the same mask as the TPU's distinct-liberty
//   min/max fixpoint.
// - Every loop is capped at N*N + 1 iterations; a hit cap ORs bit 1 into
//   the error word (ops/errors.py), which the host reads once a move.
//   No barrier sits inside a loop whose trip count differs between
//   threads.
#include "bitboard.cuh"

namespace sejonggo {
namespace {

constexpr int kBoards = 64;      // boards (= threads) per block
constexpr int32_t kErrBit = 1;   // ops/errors.py: GOSTEP

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

// Points with at least two empty orthogonal neighbours on the board.
template <int W>
__device__ __forceinline__ void two_empty_neighbours(
    const uint64_t (&empty)[W], int n, const Masks<W>& m, uint64_t (&out)[W]) {
  uint64_t l[W], r[W], u[W], d[W];
  shl<W>(empty, 1, l);
  shr<W>(empty, 1, r);
  shl<W>(empty, n, u);
  shr<W>(empty, n, d);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t lw = l[w] & m.not_left[w], rw = r[w] & m.not_right[w];
    const uint64_t uw = u[w], dw = d[w] & m.on[w];
    out[w] = ((lw & rw) | ((lw | rw) & (uw | dw)) | (uw & dw)) & m.on[w];
  }
}

template <int W>
__global__ void __launch_bounds__(kBoards)
step_legal_kernel(const int8_t* __restrict__ stones,
                  const int8_t* __restrict__ sides,
                  const int32_t* __restrict__ actions,
                  int8_t* __restrict__ out_stones,
                  uint8_t* __restrict__ out_illegal,
                  int32_t* __restrict__ err, int B, int n, Masks<W> m) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bar;
  const int nn = n * n;
  const int b0 = blockIdx.x * kBoards;
  const int nb = min(kBoards, B - b0);
  // tiles: parent grids, new grids, illegal rows; each padded for the
  // 8-byte over-read of the word-wide packing
  uint8_t* in_tile = smem;
  uint8_t* s_tile = in_tile + round16(kBoards * nn + 8);
  uint8_t* i_tile = s_tile + round16(kBoards * nn + 8);
  const size_t goff = (size_t)b0 * nn;
  const size_t ioff = (size_t)b0 * (nn + 1);

  const int t = threadIdx.x;
  const bool mine = t < nb;
  // per-board scalars first, so their loads overlap the tile copy
  const int8_t side = mine ? sides[b0 + t] : (int8_t)1;
  const int action = mine ? actions[b0 + t] : nn;
  tiles_in(&bar, in_tile, reinterpret_cast<const uint8_t*>(stones) + goff,
           nb * nn, nullptr, nullptr, 0);

  if (mine) {
    bool ok = true;
    uint64_t own[W], opp[W], onehot[W], prev_opp[W];
#pragma unroll
    for (int w = 0; w < W; ++w) own[w] = opp[w] = 0;
    const uint32_t own4 = 0x01010101u * (uint8_t)side;
    const uint32_t opp4 = 0x01010101u * (uint8_t)(-side);
    for_each_word<W>(in_tile, t * nn, nn, [&](int j, uint32_t x) {
      own[j >> 4] |= (uint64_t)nibble(__vcmpeq4(x, own4)) << (4 * (j & 15));
      opp[j >> 4] |= (uint64_t)nibble(__vcmpeq4(x, opp4)) << (4 * (j & 15));
    });
#pragma unroll
    for (int w = 0; w < W; ++w) {
      onehot[w] = (action >= 0 && action < nn && (action >> 6) == w)
                      ? (1ull << (action & 63)) : 0ull;
      own[w] = (own[w] & m.on[w]) | onehot[w];
      opp[w] &= m.on[w];
      prev_opp[w] = opp[w];
    }

    uint64_t empty[W], tt[W], alive[W], dead[W], removed[W], nb1[W];
    // opponent captures: dead groups next to the placed stone
#pragma unroll
    for (int w = 0; w < W; ++w) empty[w] = m.on[w] & ~(own[w] | opp[w]);
    dilate<W>(empty, n, m, tt);
#pragma unroll
    for (int w = 0; w < W; ++w) tt[w] &= opp[w];
    ok &= flood<W>(tt, opp, n, m, alive);
    dilate<W>(onehot, n, m, nb1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dead[w] = opp[w] & ~alive[w];
      tt[w] = dead[w] & nb1[w];
    }
    ok &= flood<W>(tt, dead, n, m, removed);
#pragma unroll
    for (int w = 0; w < W; ++w) opp[w] &= ~removed[w];

    // own suicide: own groups without liberty at or next to the stone
#pragma unroll
    for (int w = 0; w < W; ++w) empty[w] = m.on[w] & ~(own[w] | opp[w]);
    dilate<W>(empty, n, m, tt);
#pragma unroll
    for (int w = 0; w < W; ++w) tt[w] &= own[w];
    ok &= flood<W>(tt, own, n, m, alive);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dead[w] = own[w] & ~alive[w];
      tt[w] = dead[w] & (nb1[w] | onehot[w]);
    }
    ok &= flood<W>(tt, dead, n, m, removed);
#pragma unroll
    for (int w = 0; w < W; ++w) own[w] &= ~removed[w];

    // legality for the next mover: its stones are opp, its targets own
    uint64_t ko[W], capt[W], remaining[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      ko[w] = prev_opp[w] & ~opp[w];
      empty[w] = m.on[w] & ~(own[w] | opp[w]);
      capt[w] = 0;
    }
    const bool single_ko = popcount<W>(ko) == 1;
    // groups with two liberties for sure are not capturable: a stone next
    // to two empty points, or two neighbouring stones next to an empty
    // point each (neighbouring points share no neighbour, so those are
    // two different liberties)
    uint64_t breath[W], lib1[W];
    dilate<W>(empty, n, m, breath);
#pragma unroll
    for (int w = 0; w < W; ++w) lib1[w] = own[w] & breath[w];
    dilate<W>(lib1, n, m, dead);
    two_empty_neighbours<W>(empty, n, m, tt);
#pragma unroll
    for (int w = 0; w < W; ++w) tt[w] = (tt[w] & own[w]) | (dead[w] & lib1[w]);
    ok &= flood<W>(tt, own, n, m, alive);
#pragma unroll
    for (int w = 0; w < W; ++w) remaining[w] = own[w] & ~alive[w];
    // a stone left without a neighbour of its colour is a whole group,
    // with at most one liberty: capturable without a walk
    dilate<W>(remaining, n, m, tt);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      capt[w] = remaining[w] & ~tt[w];
      remaining[w] &= tt[w];
    }
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

    uint64_t illegal[W];
    dilate<W>(capt, n, m, dead);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t legal = empty[w] & ~(single_ko ? ko[w] : 0ull)
                             & (breath[w] | dead[w]);
      illegal[w] = m.on[w] & ~legal;   // the pass bit N*N stays 0: legal
    }
    const uint32_t side4 = (uint8_t)side, nside4 = (uint8_t)(-side);
    write_row<W>(s_tile, t * nn, nn, [&](int k) {
      return spread(nibble_of<W>(own, k)) * side4 |
             spread(nibble_of<W>(opp, k)) * nside4;
    });
    write_row<W>(i_tile, t * (nn + 1), nn + 1, [&](int k) {
      return spread(nibble_of<W>(illegal, k));
    });
    if (!ok) atomicOr(err, kErrBit);
  }
  tiles_out(reinterpret_cast<uint8_t*>(out_stones) + goff, s_tile, nb * nn,
            out_illegal + ioff, i_tile, nb * (nn + 1));
}

size_t shmem_bytes(int n) {
  const int nn = n * n;
  return 2 * round16(kBoards * nn + 8) + round16(kBoards * (nn + 1) + 8);
}

template <int W>
int launch(const int8_t* stones, const int8_t* sides, const int32_t* actions,
           int8_t* out_stones, uint8_t* out_illegal, int32_t* err, int B,
           int n, cudaStream_t stream) {
  // above 48 KB a block needs the opt-in, set once for the largest board
  // of this word count (host-side, so it is also allowed while a CUDA
  // graph is being captured)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      step_legal_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem_bytes(max_size(W)));
  if (opt_in != cudaSuccess) return (int)opt_in;
  const size_t shmem = shmem_bytes(n);
  const int blocks = (B + kBoards - 1) / kBoards;
  step_legal_kernel<W><<<blocks, kBoards, shmem, stream>>>(
      stones, sides, actions, out_stones, out_illegal, err, B, n,
      make_masks<W>(n));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sejonggo

// stones: (B, N, N) int8 signed parent grids; sides: (B,) int8 movers
// (+-1); actions: (B,) int32 in [0, N*N] (N*N = pass); out_stones:
// (B, N, N) int8; out_illegal: (B, N*N+1) bytes of 0/1 (torch.bool) for
// the next mover; err: the device's int32 error word, bit 1 set if an
// iteration cap was hit.  Returns the CUDA error of the launch
// (0 = launched).
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

// Boards per block of the launch (any board size).
extern "C" int sejonggo_step_legal_block(int) { return sejonggo::kBoards; }
