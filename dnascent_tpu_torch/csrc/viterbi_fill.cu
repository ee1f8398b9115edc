// Kernel C: max-product Viterbi fill over the M/I/D states of a window.
//
// Replaces dnascent_tpu/ops/viterbi_pallas.py:_kernel (reference
// alignment.cpp:193-516).  Same contract as viterbi_fill_codes_pallas: one
// u8 pointer code per (t, state, window) cell (I in bits 0-1, M in bits
// 2-4, D in bit 5), ties to the first candidate in lnArgMax order, the D
// chain in the closed form D[i] = max_{j<i}(M[j] - j*eD2D) + eM2D +
// (i-1)*eD2D, plus the final I/M/D columns for termination.
//
// What bounds it on this card: T*N dependent cell updates per window
// (~30 flops each) and one code byte written per cell; the code stream is
// the only large memory traffic.  Design: one thread per window walking its
// states in order inside each column, so the D chain's cumulative max is a
// running max (max is exact, so it equals the closed form bit for bit) and
// the previous column lives in shared memory laid out state-major by lane
// (conflict-free).  Windows are the fastest axis of every plane, so a warp
// reads obs/mu and writes codes as 32 consecutive words or bytes.  With
// ~2048 windows per call the grid is only 64 warps; more windows per launch
// or several threads per window is later work.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;

__global__ void viterbi_fill_kernel(
    const float* __restrict__ obs, const float* __restrict__ mu,
    const float* __restrict__ inv_sigma, const float* __restrict__ lp_const,
    const int* __restrict__ n_obs, const int* __restrict__ n_states,
    const float* __restrict__ iM2M_w, const float* __restrict__ eM2M_w,
    const float* __restrict__ eOrIM2M_w, int T, int N, int W,
    float eD2D, float eD2M, float eI2M, float eM2D, float iM2I, float iI2I,
    uint8_t* __restrict__ codes, float* __restrict__ I_fin,
    float* __restrict__ M_fin, float* __restrict__ D_fin) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kLanes + lane;
  if (w >= W) return;  // no barriers below: each thread owns its columns
  float* Is = sm;
  float* Ms = sm + N * kLanes;
  float* Ds = sm + 2 * N * kLanes;
#define DT_AT(arr, i) arr[(i) * kLanes + lane]
  const int nobs = n_obs[w];
  const int nst = n_states[w];
  const float iM2M = iM2M_w[w];
  const float eM2M = eM2M_w[w];
  const float eOrIM2M = eOrIM2M_w[w];
  // initial column: start -> D0 -> D1 -> ... (alignment.cpp:239-251)
  for (int i = 0; i < N; ++i) {
    DT_AT(Is, i) = DT_NEG;
    DT_AT(Ms, i) = DT_NEG;
    DT_AT(Ds, i) = (i < nst) ? eM2D + (float)i * eD2D : DT_NEG;
  }
  for (int t = 0; t < T; ++t) {
    const float x = obs[(size_t)t * W + w];
    const bool act = t < nobs;
    const bool at0 = t == 0;
    float pI_m1 = DT_NEG, pM_m1 = DT_NEG, pD_m1 = DT_NEG;  // previous col, i-1
    float cM_m1 = DT_NEG, cD_m1 = DT_NEG;  // this column before masking, i-1
    float cm = DT_NEG;                     // max over j < i of M[j] - j*eD2D
    for (int i = 0; i < N; ++i) {
      const float pI = DT_AT(Is, i), pM = DT_AT(Ms, i), pD = DT_AT(Ds, i);
      const bool inr = i < nst;
      const size_t ci = (size_t)i * W + w;
      const float a = (x - mu[ci]) * inv_sigma[ci];
      const float em = lp_const[ci] - (0.5f * a) * a;
      // insertions (alignment.cpp:277-302, 350-369)
      const float c0 = pI + iI2I;
      const float c1 = pM + iM2I;
      const float c2 = (i == 0 && at0) ? iM2I : DT_NEG;
      unsigned aI = c1 > c0 ? 1u : 0u;
      float Ic = fmaxf(c0, c1);
      if (c2 > Ic) aI = 2u;
      Ic = fmaxf(Ic, c2);
      // matches (alignment.cpp:304-323, 371-402)
      const float m2 = pM + iM2M;
      unsigned aM;
      float Mc;
      if (i == 0) {
        const float s1 = at0 ? eOrIM2M : DT_NEG;
        aM = s1 > m2 ? 4u : 2u;
        Mc = fmaxf(m2, s1) + em;
      } else {
        const float m0 = pI_m1 + eI2M;
        const float m1 = pM_m1 + eM2M;
        const float m3 = pD_m1 + eD2M;
        aM = m1 > m0 ? 1u : 0u;
        float best = fmaxf(m0, m1);
        if (m2 > best) aM = 2u;
        best = fmaxf(best, m2);
        if (m3 > best) aM = 3u;
        best = fmaxf(best, m3);
        Mc = best + em;
      }
      // deletions, closed-form chain (alignment.cpp:405-427)
      const float fj = (float)i;
      const float A = Mc - fj * eD2D;
      const float cm_excl = cm;
      cm = fmaxf(cm, A);
      const float Dc =
          (i == 0) ? DT_NEG : (cm_excl + eM2D) + (fj - 1.0f) * eD2D;
      // D pointer: M[i-1]+eM2D vs D[i-1]+eD2D, M wins ties
      const unsigned aD = (cM_m1 + eM2D >= cD_m1 + eD2D) ? 0u : 1u;
      cM_m1 = Mc;
      cD_m1 = Dc;
      pI_m1 = pI;
      pM_m1 = pM;
      pD_m1 = pD;
      // keep the previous column beyond the window's observation count
      const bool upd = act && inr;
      DT_AT(Is, i) = upd ? Ic : (inr ? pI : DT_NEG);
      DT_AT(Ms, i) = upd ? Mc : (inr ? pM : DT_NEG);
      DT_AT(Ds, i) = upd ? Dc : (inr ? pD : DT_NEG);
      codes[((size_t)t * N + i) * W + w] =
          (uint8_t)(aI | (aM << 2) | (aD << 5));
    }
  }
  for (int i = 0; i < N; ++i) {
    const size_t ci = (size_t)i * W + w;
    I_fin[ci] = DT_AT(Is, i);
    M_fin[ci] = DT_AT(Ms, i);
    D_fin[ci] = DT_AT(Ds, i);
  }
#undef DT_AT
}

}  // namespace

DT_EXPORT int dt_viterbi_fill(
    const float* obs, const float* mu, const float* inv_sigma,
    const float* lp_const, const int* n_obs, const int* n_states,
    const float* iM2M, const float* eM2M, const float* eOrIM2M, int T, int N,
    int W, float eD2D, float eD2M, float eI2M, float eM2D, float iM2I,
    float iI2I, uint8_t* codes, float* I_fin, float* M_fin, float* D_fin,
    void* stream) {
  const size_t smem = (size_t)3 * N * kLanes * sizeof(float);
  if (W < 1 || T < 1 || N < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (W + kLanes - 1) / kLanes;
  viterbi_fill_kernel<<<blocks, kLanes, smem, (cudaStream_t)stream>>>(
      obs, mu, inv_sigma, lp_const, n_obs, n_states, iM2M, eM2M, eOrIM2M, T,
      N, W, eD2D, eD2M, eI2M, eM2D, iM2I, iI2I, codes, I_fin, M_fin, D_fin);
  return (int)cudaGetLastError();
}
