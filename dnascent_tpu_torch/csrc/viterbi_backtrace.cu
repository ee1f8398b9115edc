// Kernel D: Viterbi backtrace from each window's termination kind.
//
// Replaces dnascent_tpu/ops/viterbi_pallas.py:_bt_kernel.  Same contract as
// viterbi_backtrace_pallas: path codes ``kind | delta << 2`` in forward
// order in a (W, s_pad) u8 plane, one slot per s = column + position, with
// PAD (3) at every s the walk skips; consumers PAD-filter.  Every move
// strictly decreases s, so slot order is walk order reversed.
//
// What bounds it on this card: a serial walk of at most T+N dependent code
// loads per window; latency-bound, with W independent walks in flight.
// Design: one thread per window counting s down from s_pad-1 and reading
// codes[t, pos, w] directly, so the sheared, i32-packed diagonal planes the
// TPU kernel needed for Mosaic's sublane indexing are not built.
#include "common.cuh"

namespace {

constexpr int KIND_D = 0, KIND_M = 1, KIND_I = 2, KIND_PAD = 3;

__global__ void viterbi_backtrace_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ kind0,
    const int* __restrict__ n_obs, const int* __restrict__ n_states, int T,
    int N, int W, int s_pad, uint8_t* __restrict__ path_code,
    int* __restrict__ path_len) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int kind = kind0[w];
  int pos = n_states[w] - 1;
  int col = n_obs[w];
  bool done = col < 0;
  int n = 0;
  uint8_t* row = path_code + (size_t)w * s_pad;
  for (int s = s_pad - 1; s >= 0; --s) {
    uint8_t out = KIND_PAD;
    if (!done && col + pos == s) {
      const int posc = min(max(pos, 0), N - 1);
      const int t = s - 1 - posc;
      const unsigned byte =
          (t >= 0 && t < T) ? codes[((size_t)t * N + posc) * W + w] : 0u;
      const unsigned cI = byte & 3u, cM = (byte >> 2) & 7u, cD = (byte >> 5) & 1u;
      const bool at_init = col == 0;
      int nk, np, nc;
      bool fin;
      if (kind == KIND_D) {  // same column; the init column chains to start
        nk = (at_init || cD == 1u) ? KIND_D : KIND_M;
        np = pos - 1;
        nc = col;
        fin = at_init && pos == 0;
      } else if (kind == KIND_M) {  // column - 1; cM == 4 is the start
        nk = (cM == 0u) ? KIND_I : (cM == 3u ? KIND_D : KIND_M);
        np = (cM == 2u || cM >= 4u) ? pos : pos - 1;
        nc = col - 1;
        fin = cM == 4u;
      } else {  // insertion: column - 1; cI == 2 is the start
        nk = (cI == 0u) ? KIND_I : KIND_M;
        np = pos;
        nc = col - 1;
        fin = cI == 2u;
      }
      const int delta = min(max(pos - np, 0), 1);
      out = (uint8_t)(kind | (delta << 2));
      ++n;
      done = fin;
      kind = nk;
      pos = np;
      col = nc;
    }
    row[s] = out;
  }
  path_len[w] = n;
}

}  // namespace

DT_EXPORT int dt_viterbi_backtrace(const uint8_t* codes, const int* kind0,
                                   const int* n_obs, const int* n_states,
                                   int T, int N, int W, int s_pad,
                                   uint8_t* path_code, int* path_len,
                                   void* stream) {
  if (W < 1 || T < 1 || N < 1 || s_pad < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (W + threads - 1) / threads;
  viterbi_backtrace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      codes, kind0, n_obs, n_states, T, N, W, s_pad, path_code, path_len);
  return (int)cudaGetLastError();
}
