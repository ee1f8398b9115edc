// Kernel C: max-product Viterbi fill over the M/I/D states of a window.
//
// Replaces dnascent_tpu/ops/viterbi_pallas.py:_kernel (reference
// alignment.cpp:193-516).  Same contract as viterbi_fill_codes_pallas: one
// u8 pointer code per (t, state, window) cell (I in bits 0-1, M in bits
// 2-4, D in bit 5), ties to the first candidate in lnArgMax order, the D
// chain in the closed form D[i] = max_{j<i}(M[j] - j*eD2D) + eM2D +
// (i-1)*eD2D, plus the final I/M/D columns for termination.  Codes and
// finals are bitwise equal to viterbi_fill_plain (-fmad=false, every cell
// of every column, t >= n_obs included).  The codes' window stride Wc (>= W)
// is the caller's: a multiple of 16 lets kernel D fetch them by TMA.
//
// What bounds it on this card: T dependent columns per window, each ~40
// operations a state; the code stream (T*N*W bytes) is the only large
// memory traffic.  A thread per window walking its states in order leaves
// 2048 windows as one warp on each of 64 SMs, ~200 ns a cell.  Design: a
// group of G lanes owns one window, 3 consecutive states a lane: G = 16
// for the path's N=48 bucket, G = 32 for N=72 (24 lanes hold states; the
// states past N are padding that no state below reads).  Measured at the
// path's shapes, 3 states a lane beat 5 (16 lanes at N=72, 1.3-1.4x
// slower) and 2 (32 lanes at N=48, 1.2-1.3x slower), and 6 (8 lanes) lost
// everywhere.  A column is G-way parallel:
//   - the previous column's I/M/D stay in registers; state i-1 of a lane's
//     first state comes from the lane below by one __shfl_up each;
//   - the D chain's exclusive prefix max runs inside the lane, then across
//     the G lanes as a shuffle scan (max is exact, so it equals the
//     sequential running max bit for bit), and the D pointer's M[i-1] and
//     D[i-1] of this column come up by one shuffle each;
//   - mu, inv_sigma and lp_const do not depend on t: loaded once into
//     registers;
//   - a block of 128 threads holds 128 / G consecutive windows (256 blocks
//     at W=2048, N=48, and 312 at the path's ~1250-window N=72 launches, so
//     every SM gets work; 256-thread blocks left SMs idle at N=72 and
//     measured 16 % slower), stages each 8-column chunk of observations in
//     shared memory (the next chunk's loads are issued before the current
//     chunk's columns) and collects the chunk's codes there, written out as
//     rows of 128 / G window-consecutive bytes after one barrier per chunk
//     (both buffers are double-buffered).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;  // observation columns per staged chunk
constexpr int kS = 3;      // states a lane
constexpr unsigned kFull = 0xffffffffu;

// G lanes own a window (16 or 32), kWin = 128 / G windows a block
template <int G>
__global__ void __launch_bounds__(kThreads) viterbi_fill_kernel(
    const float* __restrict__ obs, const float* __restrict__ mu,
    const float* __restrict__ inv_sigma, const float* __restrict__ lp_const,
    const int* __restrict__ n_obs, const int* __restrict__ n_states,
    const float* __restrict__ iM2M_w, const float* __restrict__ eM2M_w,
    const float* __restrict__ eOrIM2M_w, int T, int N, int W, int Wc,
    float eD2D, float eD2M, float eI2M, float eM2D, float iM2I, float iI2I,
    uint8_t* __restrict__ codes, float* __restrict__ I_fin,
    float* __restrict__ M_fin, float* __restrict__ D_fin) {
  constexpr int S = kS, kWin = kThreads / G;
  static_assert(kChunk * kWin <= kThreads, "one prefetch slot a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  float* obs_s = reinterpret_cast<float*>(smem);  // [2][kChunk][kWin]
  uint8_t* code_s = smem + 2 * kChunk * kWin * sizeof(float);  // [2][kChunk][N][kWin]
  const int tid = threadIdx.x;
  const int wl = tid / G;  // window within the block
  const int lg = tid % G;  // lane within the window's group
  const int w0 = blockIdx.x * kWin;
  const int w = w0 + wl;
  // windows past W run along (no early return: every lane takes part in
  // the shuffles and barriers) and store nothing
  const bool valid = w < W;
  const int nobs = valid ? n_obs[w] : 0;
  const int nst = valid ? n_states[w] : 0;
  const float iM2M = valid ? iM2M_w[w] : 0.0f;
  const float eM2M = valid ? eM2M_w[w] : 0.0f;
  const float eOrIM2M = valid ? eOrIM2M_w[w] : 0.0f;

  float cmu[S], cis[S], clp[S], fjD[S], fjm1D[S];
  float pI[S], pM[S], pD[S];  // previous column, as stored
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = lg * S + k;
    const bool real = valid && i < N;
    const size_t ci = (size_t)i * W + w;
    cmu[k] = real ? mu[ci] : 0.0f;
    cis[k] = real ? inv_sigma[ci] : 0.0f;
    clp[k] = real ? lp_const[ci] : DT_NEG;
    const float fj = (float)i;
    fjD[k] = fj * eD2D;
    fjm1D[k] = (fj - 1.0f) * eD2D;
    // initial column: start -> D0 -> D1 -> ... (alignment.cpp:239-251)
    pI[k] = DT_NEG;
    pM[k] = DT_NEG;
    pD[k] = (i < nst) ? eM2D + (float)i * eD2D : DT_NEG;
  }

  // the prefetch slot of this thread: column pr of a chunk, window pc
  const int pr = tid / kWin, pc = tid % kWin;
  const bool fetcher = tid < kChunk * kWin;
  if (fetcher) {
    obs_s[tid] = (pr < T && w0 + pc < W) ? obs[(size_t)pr * W + w0 + pc]
                                         : 0.0f;
  }
  __syncthreads();

  const int n_chunks = (T + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    const int buf = c & 1;
    float next_x = 0.0f;
    if (fetcher) {
      const int tn = t0 + kChunk + pr;
      if (tn < T && w0 + pc < W) next_x = obs[(size_t)tn * W + w0 + pc];
    }
    const float* ob = obs_s + buf * kChunk * kWin;
    uint8_t* cs = code_s + (size_t)buf * kChunk * N * kWin;
    const int rows = min(kChunk, T - t0);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const int t = t0 + r;
      const float x = ob[r * kWin + wl];
      const bool act = t < nobs;
      const bool at0 = t == 0;
      // previous column at state i-1 of this lane's first state
      const float qI = __shfl_up_sync(kFull, pI[S - 1], 1, G);
      const float qM = __shfl_up_sync(kFull, pM[S - 1], 1, G);
      const float qD = __shfl_up_sync(kFull, pD[S - 1], 1, G);
      float Ic[S], Mc[S], A[S];
      unsigned code[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float a = (x - cmu[k]) * cis[k];
        const float em = clp[k] - (0.5f * a) * a;
        // insertions (alignment.cpp:277-302, 350-369); only state 0 has
        // the start candidate, which is -inf past the first column
        const float c0 = pI[k] + iI2I;
        const float c1 = pM[k] + iM2I;
        unsigned aI = c1 > c0 ? 1u : 0u;
        float I = fmaxf(c0, c1);
        if (k == 0) {
          const float c2 = (lg == 0 && at0) ? iM2I : DT_NEG;
          if (c2 > I) aI = 2u;
          I = fmaxf(I, c2);
        }
        Ic[k] = I;
        // matches (alignment.cpp:304-323, 371-402)
        const float m2 = pM[k] + iM2M;
        const float m0 = (k == 0 ? qI : pI[k > 0 ? k - 1 : 0]) + eI2M;
        const float m1 = (k == 0 ? qM : pM[k > 0 ? k - 1 : 0]) + eM2M;
        const float m3 = (k == 0 ? qD : pD[k > 0 ? k - 1 : 0]) + eD2M;
        unsigned aM = m1 > m0 ? 1u : 0u;
        float best = fmaxf(m0, m1);
        if (m2 > best) aM = 2u;
        best = fmaxf(best, m2);
        if (m3 > best) aM = 3u;
        best = fmaxf(best, m3);
        if (k == 0 && lg == 0) {  // state 0: [M+iM2M, start+eOrIM2M]
          const float s1 = at0 ? eOrIM2M : DT_NEG;
          aM = s1 > m2 ? 4u : 2u;
          best = fmaxf(m2, s1);
        }
        Mc[k] = best + em;
        A[k] = Mc[k] - fjD[k];
        code[k] = aI | (aM << 2);
      }
      // deletions: max of A over the states below, inside the lane ...
      float ex[S];
      float run = DT_NEG;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        ex[k] = run;
        run = fmaxf(run, A[k]);
      }
      // ... and across the lanes below (an exclusive shuffle scan)
      float below = __shfl_up_sync(kFull, run, 1, G);
      if (lg == 0) below = DT_NEG;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const float y = __shfl_up_sync(kFull, below, d, G);
        if (lg >= d) below = fmaxf(below, y);
      }
      float Dc[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float cm = fmaxf(below, ex[k]);
        Dc[k] = (k == 0 && lg == 0) ? DT_NEG : (cm + eM2D) + fjm1D[k];
      }
      // D pointer: this column's M[i-1]+eM2D vs D[i-1]+eD2D, M wins ties
      // (state 0 compares -inf with -inf: M)
      float qMc = __shfl_up_sync(kFull, Mc[S - 1], 1, G);
      float qDc = __shfl_up_sync(kFull, Dc[S - 1], 1, G);
      if (lg == 0) qMc = qDc = DT_NEG;
      uint8_t* crow = cs + (size_t)r * N * kWin + wl;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int i = lg * S + k;
        const float mm = k == 0 ? qMc : Mc[k > 0 ? k - 1 : 0];
        const float dd = k == 0 ? qDc : Dc[k > 0 ? k - 1 : 0];
        const unsigned aD = (mm + eM2D >= dd + eD2D) ? 0u : 1u;
        // keep the previous column beyond the window's observation count
        const bool inr = i < nst;
        const bool upd = act && inr;
        pI[k] = upd ? Ic[k] : (inr ? pI[k] : DT_NEG);
        pM[k] = upd ? Mc[k] : (inr ? pM[k] : DT_NEG);
        pD[k] = upd ? Dc[k] : (inr ? pD[k] : DT_NEG);
        if (i < N) crow[(size_t)i * kWin] = (uint8_t)(code[k] | (aD << 5));
      }
    }
    if (fetcher) obs_s[(buf ^ 1) * kChunk * kWin + tid] = next_x;
    __syncthreads();
    // the chunk's codes: rows (t, i) of kWin window-consecutive bytes
    const int n_win = min(kWin, W - w0);
    const int n_bytes = rows * N * kWin;
    uint8_t* dst = codes + (size_t)t0 * N * Wc + w0;
    for (int e = tid; e < n_bytes; e += kThreads) {
      const int row = e / kWin, col = e % kWin;
      if (col < n_win) dst[(size_t)row * Wc + col] = cs[e];
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = lg * S + k;
    if (valid && i < N) {
      const size_t ci = (size_t)i * W + w;
      I_fin[ci] = pI[k];
      M_fin[ci] = pM[k];
      D_fin[ci] = pD[k];
    }
  }
}

template <int G>
cudaError_t launch(const float* obs, const float* mu, const float* inv_sigma,
                   const float* lp_const, const int* n_obs,
                   const int* n_states, const float* iM2M, const float* eM2M,
                   const float* eOrIM2M, int T, int N, int W, int Wc,
                   float eD2D, float eD2M, float eI2M, float eM2D, float iM2I,
                   float iI2I,
                   uint8_t* codes, float* I_fin, float* M_fin, float* D_fin,
                   cudaStream_t stream) {
  constexpr int kWin = kThreads / G;
  const size_t smem = 2 * kChunk * kWin * (sizeof(float) + (size_t)N);
  const int blocks = (W + kWin - 1) / kWin;
  viterbi_fill_kernel<G><<<blocks, kThreads, smem, stream>>>(
      obs, mu, inv_sigma, lp_const, n_obs, n_states, iM2M, eM2M, eOrIM2M, T,
      N, W, Wc, eD2D, eD2M, eI2M, eM2D, iM2I, iI2I, codes, I_fin, M_fin,
      D_fin);
  return cudaGetLastError();
}

}  // namespace

DT_EXPORT int dt_viterbi_fill(
    const float* obs, const float* mu, const float* inv_sigma,
    const float* lp_const, const int* n_obs, const int* n_states,
    const float* iM2M, const float* eM2M, const float* eOrIM2M, int T, int N,
    int W, int Wc, float eD2D, float eD2M, float eI2M, float eM2D, float iM2I,
    float iI2I, uint8_t* codes, float* I_fin, float* M_fin, float* D_fin,
    void* stream) {
  if (W < 1 || T < 1 || N < 1 || N > 32 * kS || Wc < W)
    return (int)cudaErrorInvalidValue;
  // the path's state buckets, N=48 and N=72 (eventalign.py): 16 lanes for
  // the first, 32 (24 of them holding states) for the second
  auto fill = N <= 16 * kS ? launch<16> : launch<32>;
  return (int)fill(obs, mu, inv_sigma, lp_const, n_obs, n_states, iM2M, eM2M,
                   eOrIM2M, T, N, W, Wc, eD2D, eD2M, eI2M, eM2D, iM2I, iI2I,
                   codes, I_fin, M_fin, D_fin, (cudaStream_t)stream);
}
