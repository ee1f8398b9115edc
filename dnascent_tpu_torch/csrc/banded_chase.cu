// Kernel B: backtrace chase over the banded fill's packed trace.
//
// Replaces dnascent_tpu/ops/banded_pallas.py:_chase_kernel.  Output format
// is kept: a (Sp, B) u8 stream, Sp = S rounded up to a multiple of 4, four
// 2-bit codes per byte in strictly descending band order from the top band
// 4*Sp+1 down to band 2.  A read emits its move (D=0, U=1, L=2) at band
// e+k+2 and PAD (3) at every other band, so the shared native decoder
// (native.decode_moves, which skips PADs) consumes it unchanged.
//
// What bounds it on this card: the walk is a serial pointer chase, one
// dependent trace-byte load per band, so latency, not bandwidth, sets the
// time.  Design: one thread per read walking the band countdown; the band's
// lower-left event index (which selects the trace lane) unwinds from the
// rights bits one band at a time, so no per-band index plane is built.
// Reads in a batch are few (32), so the launch is one small block; splitting
// the chase of a long read into segments is later work.
#include "common.cuh"

namespace {

__global__ void banded_chase_kernel(
    const uint8_t* __restrict__ trace, const uint8_t* __restrict__ rights,
    const int* __restrict__ best_event, const int* __restrict__ n_kmers,
    int S, int Sp, int B, int W, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int half = W / 2;
  int n_right = 0;
  for (int s = 0; s < S; ++s) n_right += __popc(rights[(size_t)s * B + b] & 15u);
  // lower-left event index of the top band (padded rows count as downs)
  int bll = half + 4 * Sp - n_right;
  int e = best_event[b];
  int k = n_kmers[b] - 1;
  bool done = (e < 0) || (k < 0);
  for (int r = 0; r < Sp; ++r) {
    const int sr = Sp - 1 - r;
    const unsigned rrow = (sr < S) ? rights[(size_t)sr * B + b] : 0u;
    unsigned acc = 0;
    for (int m = 0; m < 4; ++m) {
      const int j = 3 - m;
      const int band = sr * 4 + j + 2;
      unsigned code = 3u;
      if (!done && e + k + 2 == band) {
        const int off = min(max(bll - e, 0), W - 1);
        const unsigned byte =
            (sr < S) ? trace[((size_t)sr * B + b) * W + off] : 0u;
        code = (byte >> (2 * j)) & 3u;
        if (code == 0u || code == 1u) e -= 1;
        if (code == 0u || code == 2u) k -= 1;
        if (e < 0 || k < 0) done = true;
      }
      acc |= code << (2 * m);
      bll -= 1 - (int)((rrow >> j) & 1u);
    }
    out[(size_t)r * B + b] = (uint8_t)acc;
  }
}

}  // namespace

DT_EXPORT int dt_banded_chase(const uint8_t* trace, const uint8_t* rights,
                              const int* best_event, const int* n_kmers,
                              int S, int Sp, int B, int W, uint8_t* out,
                              void* stream) {
  if (B < 1 || W < 2 || Sp < S || Sp % 4 != 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  banded_chase_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      trace, rights, best_event, n_kmers, S, Sp, B, W, out);
  return (int)cudaGetLastError();
}
