// Kernels A and E: adaptive banded fill of events against query k-mers.
//
// A replaces dnascent_tpu/ops/banded_pallas.py:_kernel_lean (the shipping
// static-stdv fill; reference event_handling.cpp:148-312).  E replaces
// banded_pallas.py:_kernel, the same fill for pore models whose stdv varies
// per k-mer.  Both keep banded_fill_pallas's contract: 2-bit trace codes
// packed four bands per byte in a (S, B, W) u8 plane, one rights bit per band
// in (S, B) u8, and each read's best end event and score.  One template,
// `PerKmerStdv`, covers both; only the emission differs:
//   A: em = h_c * (x - mu)^2, lp_const folded into the stay/step scores,
//      score = prev + (l_move + em);
//   E: em = (cA + cB * x) + (cC * x) * x from three coefficient planes the
//      wrapper forms (cA = lp_const - 0.5 (mu/sigma)^2, cB = mu/sigma^2,
//      cC = -0.5/sigma^2), score = (prev + l_move) + em.
// Each keeps its TPU kernel's operation order, so it is bitwise equal to its
// plain PyTorch twin.
//
// What bounds it on this card: each band depends on the previous two, so a
// read is a chain of ~E+K dependent steps of W=100 cells.  The chain's
// latency (one block barrier plus ~40 instructions per band), not bytes or
// FLOPs, sets the time; memory traffic is one event, one mu (or three
// coefficients) and one trace byte per cell.  Design: one block per read,
// one thread per band cell, the last three bands in shared memory (ring of
// three, so one __syncthreads per band suffices), the Suzuki right/down
// decision recomputed by every thread from the shared previous band, four
// bands of codes accumulated in a register before one coalesced store.  A
// batch of B reads fills only B of the 132 SMs; more reads per launch (or
// several reads per block) is the first thing to change for speed.  The TPU
// general kernel's sliding windows, permutation-matmul reversal and per-row
// refill DMAs were Mosaic workarounds and are gone: a thread reads its
// event and coefficients by index.
#include "common.cuh"

namespace {

constexpr int kMaxW = 128;

// c0 is the mu plane (A) or cA (E); c1, c2 are cB, cC (E only)
template <bool PerKmerStdv>
__global__ void banded_fill_kernel(
    const float* __restrict__ events, const float* __restrict__ c0,
    const float* __restrict__ c1, const float* __restrict__ c2,
    const int* __restrict__ n_events, const int* __restrict__ n_kmers,
    const float* __restrict__ lp_stay, const float* __restrict__ lp_step,
    int B, int E, int K, int W, int n_steps,
    float lp_skip, float lp_trim, float h_c,
    uint8_t* __restrict__ trace, uint8_t* __restrict__ rights,
    int* __restrict__ best_event, float* __restrict__ best_score) {
  __shared__ float buf[3][kMaxW];
  const int b = blockIdx.x;
  const int o = threadIdx.x;
  const bool lane = o < W;
  const int half = W / 2;
  const int ne = n_events[b];
  const int nk = n_kmers[b];
  const float lstay = lp_stay[b];
  const float lstep = lp_step[b];
  const float* ev = events + (size_t)b * E;
  const size_t kb = (size_t)b * K;

  // bands 0 and 1 (event_handling.cpp:212-228)
  if (lane) {
    buf[0][o] = (o == half) ? 0.0f : DT_NEG;
    buf[1][o] = (o == half) ? lp_trim : DT_NEG;
  }
  int e0 = half, k0 = -1 - half, rp = 0;
  float bs = DT_NEG;
  int be = 0;
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    unsigned acc = 0, racc = 0;
    for (int j = 0; j < 4; ++j) {
      const int band = step * 4 + j + 2;
      const float* p1 = buf[(band - 1) % 3];
      const float* p2 = buf[(band - 2) % 3];
      float* out = buf[band % 3];
      // Suzuki placement rule (event_handling.cpp:234-253)
      const float ll = p1[0], ur = p1[W - 1];
      const int right = (ll == DT_NEG && ur == DT_NEG) ? (band & 1)
                                                       : (ll < ur ? 1 : 0);
      e0 += 1 - right;
      k0 += right;
      const int dd = right + rp;
      rp = right;
      if (lane) {
        const float p1o = p1[o];
        const float p1up = (o + 1 < W) ? p1[o + 1] : DT_NEG;
        const float p1dn = (o > 0) ? p1[o - 1] : DT_NEG;
        const float up = right ? p1up : p1o;
        const float left = right ? p1o : p1dn;
        float diag;
        if (dd == 0) diag = (o > 0) ? p2[o - 1] : DT_NEG;
        else if (dd == 1) diag = p2[o];
        else diag = (o + 1 < W) ? p2[o + 1] : DT_NEG;
        // valid cells: e = e0-o in [0, ne), k = k0+o in [0, nk)
        const int lo = max(-k0, e0 - ne + 1);
        const int hi = min(e0, nk - k0 - 1);
        float val = DT_NEG;
        unsigned frm = 0;
        if (o >= lo && o <= hi) {
          const float x = ev[e0 - o];
          const size_t k = kb + (k0 + o);
          float sd, su;
          if constexpr (PerKmerStdv) {
            const float em = (c0[k] + c1[k] * x) + (c2[k] * x) * x;
            sd = (diag + lstep) + em;
            su = (up + lstay) + em;
          } else {
            const float t = x - c0[k];
            const float em = h_c * (t * t);
            sd = diag + (lstep + em);
            su = up + (lstay + em);
          }
          const float sl = left + lp_skip;
          // tie-break mirrors event_handling.cpp:300-306
          const float mdu = fmaxf(sd, su);
          const unsigned from_du = (mdu == su) ? 1u : 0u;
          const float mall = fmaxf(mdu, sl);
          frm = (mall == sl) ? 2u : from_du;
          val = mall;
        }
        // trim state (event_handling.cpp:255-265)
        const int ot = -1 - k0;
        const int et = e0 - ot;
        if (o == ot && et >= 0 && et < ne) {
          val = lp_trim * ((float)et + 1.0f);
          frm = 1u;
        }
        out[o] = val;
        acc |= frm << (2 * j);
      }
      racc |= (unsigned)right << j;
      __syncthreads();
      // final-k-mer start-cell search (event_handling.cpp:324-340), run by
      // every thread on the band just written so the copies stay identical
      const int o_fin = nk - 1 - k0;
      const int e_fin = e0 - o_fin;
      if (o_fin >= 0 && o_fin < W && e_fin >= 0 && e_fin < ne) {
        const float cand = out[o_fin] + (float)(ne - e_fin) * lp_trim;
        if (cand > bs) {
          bs = cand;
          be = e_fin;
        }
      }
    }
    if (lane) trace[((size_t)step * B + b) * W + o] = (uint8_t)acc;
    if (o == 0) rights[(size_t)step * B + b] = (uint8_t)racc;
  }
  if (o == 0) {
    best_event[b] = be;
    best_score[b] = bs;
  }
}

}  // namespace

DT_EXPORT int dt_banded_fill_lean(
    const float* events, const float* mu, const int* n_events,
    const int* n_kmers, const float* lp_stay, const float* lp_step, int B,
    int E, int K, int W, int n_steps, float lp_skip, float lp_trim, float h_c,
    uint8_t* trace, uint8_t* rights, int* best_event, float* best_score,
    void* stream) {
  if (W < 2 || W > kMaxW || B < 1) return (int)cudaErrorInvalidValue;
  banded_fill_kernel<false><<<B, kMaxW, 0, (cudaStream_t)stream>>>(
      events, mu, nullptr, nullptr, n_events, n_kmers, lp_stay, lp_step, B, E,
      K, W, n_steps, lp_skip, lp_trim, h_c, trace, rights, best_event,
      best_score);
  return (int)cudaGetLastError();
}

DT_EXPORT int dt_banded_fill_general(
    const float* events, const float* cA, const float* cB, const float* cC,
    const int* n_events, const int* n_kmers, const float* lp_stay,
    const float* lp_step, int B, int E, int K, int W, int n_steps,
    float lp_skip, float lp_trim, uint8_t* trace, uint8_t* rights,
    int* best_event, float* best_score, void* stream) {
  if (W < 2 || W > kMaxW || B < 1) return (int)cudaErrorInvalidValue;
  banded_fill_kernel<true><<<B, kMaxW, 0, (cudaStream_t)stream>>>(
      events, cA, cB, cC, n_events, n_kmers, lp_stay, lp_step, B, E, K, W,
      n_steps, lp_skip, lp_trim, 0.0f, trace, rights, best_event, best_score);
  return (int)cudaGetLastError();
}
