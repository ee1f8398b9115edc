// Kernel B: backtrace chase over the banded fill's packed trace.
//
// Replaces dnascent_tpu/ops/banded_pallas.py:_chase_kernel.  Output format
// is kept: a (Sp, B) u8 stream, Sp = S rounded up to a multiple of 4, four
// 2-bit codes per byte in strictly descending band order from the top band
// 4*Sp+1 down to band 2.  A read emits its move (D=0, U=1, L=2) at band
// e+k+2 and PAD (3) at every other band, so the native decoder
// (native.decode_moves, which skips PADs) consumes it unchanged.
//
// What bounds it on this card: the walk is a serial pointer chase, one
// trace byte per band whose address depends on the previous move, so
// latency, not bandwidth, sets the time.  Design: one warp (one block) per
// read.  The warp stages its read's trace rows in chunks of kRows rows
// (kRows x W bytes) in shared memory, double-buffered: the next chunk's rows
// are copied with cp.async (4-byte words, coalesced along a row) while the
// current chunk is walked, so the chain only ever reads shared memory.
// Every lane walks (the walk is warp-uniform, and a shared-memory read of
// one address is a broadcast); each lane holds one row's rights byte of the
// chunk and passes it by shuffle, and keeps its row's output byte, so the
// warp stores a chunk's bytes together after the walk.  A row whose four
// bands lie above the read's next move, or any row after the walk ends, is
// emitted as four PADs in one step.  The rights popcount that places the top
// band is a warp-parallel reduction.  The band's lower-left event index
// (which selects the trace lane) unwinds from the rights bits, so no
// per-band index plane is built.  What remains is the move's dependent
// chain (a shared-memory read, the decode, the next offset): ~90 ns a band
// on an H100 80GB HBM3 at 700 W (PERF.md, PR 3), against ~230 ns for the
// PR 2 design (a thread per read reading each byte from device memory).
#include "common.cuh"

namespace {

constexpr int kRows = 32;    // trace rows a chunk stages: one rights byte a lane
constexpr int kMaxW = 128;   // row stride in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [r0, r0 + kRows) of read b's trace into dst (row stride
// kMaxW); rows outside [0, S) read as 0.  Rows of a width that is a multiple
// of 4 go by cp.async and land by the next cp_async_wait_all; other widths
// are copied at once.
__device__ __forceinline__ void stage(uint8_t* dst,
                                      const uint8_t* __restrict__ trace,
                                      int r0, int S, int B, int W, int b,
                                      int lane) {
  if ((W & 3) == 0) {
    const int words = W >> 2;
    for (int i = lane; i < kRows * words; i += 32) {
      const int r = i / words;
      const int w = i - r * words;
      const int sr = r0 + r;
      uint8_t* d = dst + r * kMaxW + 4 * w;
      if (sr >= 0 && sr < S)
        cp_async4(d, trace + ((size_t)sr * B + b) * W + 4 * w);
      else
        *reinterpret_cast<uint32_t*>(d) = 0u;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = lane; i < kRows * W; i += 32) {
      const int r = i / W;
      const int o = i - r * W;
      const int sr = r0 + r;
      dst[r * kMaxW + o] =
          (sr >= 0 && sr < S) ? trace[((size_t)sr * B + b) * W + o] : 0;
    }
  }
}

__device__ __forceinline__ unsigned rights_row(
    const uint8_t* __restrict__ rights, int sr, int S, int B, int b) {
  return (sr >= 0 && sr < S) ? rights[(size_t)sr * B + b] : 0u;
}

__global__ void __launch_bounds__(32) banded_chase_kernel(
    const uint8_t* __restrict__ trace, const uint8_t* __restrict__ rights,
    const int* __restrict__ best_event, const int* __restrict__ n_kmers,
    int S, int Sp, int B, int W, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t buf[2][kRows * kMaxW];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int half = W / 2;

  int r0 = Sp - kRows;  // the chunk's lowest row; rows are walked top down
  stage(buf[0], trace, r0, S, B, W, b, lane);
  unsigned rcur = rights_row(rights, r0 + lane, S, B, b);

  int n_right = 0;
  for (int s = lane; s < S; s += 32)
    n_right += __popc(rights[(size_t)s * B + b] & 15u);
  n_right = __reduce_add_sync(kFull, n_right);
  // lower-left event index of the top band (padded rows count as downs)
  int bll = half + 4 * Sp - n_right;
  int e = best_event[b];
  int k = n_kmers[b] - 1;
  bool done = (e < 0) || (k < 0);
  cp_async_wait_all();
  __syncwarp();

  const int n_chunks = (Sp + kRows - 1) / kRows;
  for (int ch = 0; ch < n_chunks; ++ch, r0 -= kRows) {
    unsigned rnext = 0;
    if (ch + 1 < n_chunks) {
      stage(buf[(ch + 1) & 1], trace, r0 - kRows, S, B, W, b, lane);
      rnext = rights_row(rights, r0 - kRows + lane, S, B, b);
    }
    const uint8_t* cur = buf[ch & 1];
    unsigned mine = 0xffu;  // the output byte of row r0 + lane
    for (int r = kRows - 1; r >= 0; --r) {
      const int sr = r0 + r;
      if (sr < 0) break;
      const unsigned rrow = __shfl_sync(kFull, rcur, r);
      unsigned acc;
      if (done || e + k + 2 < sr * 4 + 2) {
        acc = 0xffu;  // no band of this row holds a move: four PADs
        bll -= 4 - __popc(rrow & 15u);
      } else {
        acc = 0;
        for (int m = 0; m < 4; ++m) {
          const int j = 3 - m;
          const int band = sr * 4 + j + 2;
          unsigned code = 3u;
          if (!done && e + k + 2 == band) {
            const int off = min(max(bll - e, 0), W - 1);
            code = (cur[r * kMaxW + off] >> (2 * j)) & 3u;
            if (code == 0u || code == 1u) e -= 1;
            if (code == 0u || code == 2u) k -= 1;
            if (e < 0 || k < 0) done = true;
          }
          acc |= code << (2 * m);
          bll -= 1 - (int)((rrow >> j) & 1u);
        }
      }
      mine = (lane == r) ? acc : mine;
    }
    if (r0 + lane >= 0)
      out[(size_t)(Sp - 1 - r0 - lane) * B + b] = (uint8_t)mine;
    cp_async_wait_all();
    __syncwarp();
    rcur = rnext;
  }
}

}  // namespace

DT_EXPORT int dt_banded_chase(const uint8_t* trace, const uint8_t* rights,
                              const int* best_event, const int* n_kmers,
                              int S, int Sp, int B, int W, uint8_t* out,
                              void* stream) {
  if (B < 1 || W < 2 || W > kMaxW || Sp < S || Sp % 4 != 0)
    return (int)cudaErrorInvalidValue;
  banded_chase_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      trace, rights, best_event, n_kmers, S, Sp, B, W, out);
  return (int)cudaGetLastError();
}
