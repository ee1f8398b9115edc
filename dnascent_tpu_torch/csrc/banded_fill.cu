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
// read is a chain of ~E+K dependent steps of W=100 cells.  The latency of
// one band, not bytes (one event, one mu or three coefficients and one trace
// byte a cell) or FLOPs, sets the time.  Design, to shorten that latency:
//  - one block per read, one thread per band cell, the last three bands in
//    shared memory (a ring of three, so one barrier a band suffices); the
//    band's work is spread over four warps, so the four schedulers of an SM
//    issue it side by side.  Bands are padded with -inf cells, so a thread
//    reads its neighbours and writes its cell without bounds tests or
//    branches;
//  - no global load on the chain: the read's events and coefficients stream
//    through shared-memory rings of 4 x 128 values, refilled 128 values at a
//    time from registers loaded 128 moves ahead.  A cell keeps its own event
//    and coefficients in registers; the inputs of both possible successors
//    (event e0+1-o after a down move, k-mer k0+1+o after a right move) are
//    read from the rings before the Suzuki decision is known;
//  - for A, both successor cells are scored before the decision, leaving a
//    shared-memory read of the band's two end cells, a compare and a select
//    on the chain; for E, whose emission costs four more operations a
//    candidate, scoring only the chosen cell after the decision measured
//    faster on the H100;
//  - the trim cell and the final-k-mer search run only in the bands that
//    can hold them (uniform branches).
// What remains per band is a barrier, a shared-memory round trip and the
// cells' arithmetic: ~140 ns a band on an H100 80GB HBM3 at 700 W (PERF.md,
// PR 3), against ~280 ns for the PR 2 design.
// Reads of a launch take one SM each (32 of 132 at the main path's batch).
// The TPU general kernel's sliding windows, permutation-matmul reversal and
// per-row refill DMAs were Mosaic workarounds and are gone.
#include "common.cuh"

namespace {

constexpr int kMaxW = 128;        // threads a block: one per band cell
constexpr int kBlk = 128;         // ring refill granule (one value a thread)
constexpr int kRing = 4 * kBlk;   // ring slots: index i lives at i & (kRing-1)

__device__ __forceinline__ float load_or0(const float* p, int i, int n) {
  return (i >= 0 && i < n) ? __ldg(p + i) : 0.0f;
}

// One cell of a successor band: score and trace code from its three
// predecessors and its emission inputs; every operation is the plain
// twin's, in its order.
template <bool PerKmerStdv>
__device__ __forceinline__ void score_cell(
    float diag, float up, float left, float xv, float cA, float cB, float cC,
    float lstep, float lstay, float lp_skip, float h_c, float& val,
    unsigned& frm) {
  float sd, su;
  if constexpr (PerKmerStdv) {
    const float em = (cA + cB * xv) + (cC * xv) * xv;
    sd = (diag + lstep) + em;
    su = (up + lstay) + em;
  } else {
    const float t = xv - cA;
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

// c0 is the mu plane (A) or cA (E); c1, c2 are cB, cC (E only)
template <bool PerKmerStdv>
__global__ void __launch_bounds__(kMaxW) banded_fill_kernel(
    const float* __restrict__ events, const float* __restrict__ c0,
    const float* __restrict__ c1, const float* __restrict__ c2,
    const int* __restrict__ n_events, const int* __restrict__ n_kmers,
    const float* __restrict__ lp_stay, const float* __restrict__ lp_step,
    int B, int E, int K, int W, int n_steps,
    float lp_skip, float lp_trim, float h_c,
    uint8_t* __restrict__ trace, uint8_t* __restrict__ rights,
    int* __restrict__ best_event, float* __restrict__ best_score) {
  constexpr int NP = PerKmerStdv ? 3 : 1;
  constexpr bool kSpeculate = !PerKmerStdv;
  // bands hold cell o at [o + 1]; [0] and every cell >= W stay -inf, so a
  // neighbour read needs no bounds test and no thread branches around it
  __shared__ float bands[3][kMaxW + 2];
  __shared__ float ev_ring[kRing];
  __shared__ float c_ring[NP][kRing];
  const int b = blockIdx.x;
  const int o = threadIdx.x;
  const int half = W / 2;
  const bool pad_ok = o < W;
  const int ne = n_events[b];
  const int nk = n_kmers[b];
  const float lstay = lp_stay[b];
  const float lstep = lp_step[b];
  const float* ev = events + (size_t)b * E;
  const float* plane[NP];
  plane[0] = c0 + (size_t)b * K;
  if constexpr (PerKmerStdv) {
    plane[1] = c1 + (size_t)b * K;
    plane[2] = c2 + (size_t)b * K;
  }

  // bands 0 and 1 (event_handling.cpp:212-228)
  float* p2 = bands[0];
  float* p1 = bands[1];
  float* out = bands[2];
  p2[o + 1] = (o == half) ? 0.0f : DT_NEG;
  p1[o + 1] = (o == half) ? lp_trim : DT_NEG;
  out[o + 1] = DT_NEG;
  if (o < 2) {
#pragma unroll
    for (int r = 0; r < 3; ++r) bands[r][o * (kMaxW + 1)] = DT_NEG;
  }
  int e0 = half, k0 = -1 - half, rp = 0;
  // the cell's own event ev[e0-o] and coefficients plane[k0+o] (0 out of
  // range: such a cell is never valid)
  float x = load_or0(ev, e0 - o, E);
  float m[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) m[p] = load_or0(plane[p], k0 + o, K);
  // rings: the next band reads events up to e0+1 and k-mers up to k0+W;
  // with that index in granule g, granules g-2..g+1 are resident and g+2
  // waits in a register
  int ge = (e0 + 1) / kBlk, gk = (k0 + W) / kBlk;
#pragma unroll
  for (int q = -2; q < 2; ++q) {
    const int ie = (ge + q) * kBlk + o, ik = (gk + q) * kBlk + o;
    ev_ring[ie & (kRing - 1)] = load_or0(ev, ie, E);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      c_ring[p][ik & (kRing - 1)] = load_or0(plane[p], ik, K);
  }
  int e_edge = (ge + 1) * kBlk, k_edge = (gk + 1) * kBlk;
  float ev_next = load_or0(ev, (ge + 2) * kBlk + o, E);
  float c_next[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p)
    c_next[p] = load_or0(plane[p], (gk + 2) * kBlk + o, K);
  float bs = DT_NEG;
  int be = 0;
  __syncthreads();
  // band n-2's three cells around o stay in registers: a band earlier they
  // were read from shared memory as band n-1's
  float p2dn = p2[o], p2o = p2[o + 1], p2up = p2[o + 2];

  for (int step = 0; step < n_steps; ++step) {
    unsigned acc = 0, racc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int band = step * 4 + j + 2;
      // the two successors' inputs: after a down move the cell's event is
      // ev[e0+1-o], after a right move its k-mer is k0+1+o
      const float xd = ev_ring[(e0 + 1 - o) & (kRing - 1)];
      float mr[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        mr[p] = c_ring[p][(k0 + 1 + o) & (kRing - 1)];
      const float ll = p1[1], ur = p1[W];
      const float p1dn = p1[o], p1o = p1[o + 1], p1up = p1[o + 2];
      // diag: dd = right + rp selects p2[o-1], p2[o] or p2[o+1]
      const float diag_d = rp ? p2o : p2dn;   // down: dd = rp
      const float diag_r = rp ? p2up : p2o;   // right: dd = rp + 1
      float v_d = 0.0f, v_r = 0.0f;
      unsigned f_d = 0u, f_r = 0u;
      if constexpr (kSpeculate) {
        score_cell<PerKmerStdv>(diag_d, p1o, p1dn, xd, m[0], m[1 % NP],
                                m[2 % NP], lstep, lstay, lp_skip, h_c, v_d,
                                f_d);
        score_cell<PerKmerStdv>(diag_r, p1up, p1o, x, mr[0], mr[1 % NP],
                                mr[2 % NP], lstep, lstay, lp_skip, h_c, v_r,
                                f_r);
      }
      // Suzuki placement rule (event_handling.cpp:234-253)
      const int right = (ll == DT_NEG && ur == DT_NEG) ? (j & 1)  // band & 1
                                                       : (ll < ur ? 1 : 0);
      e0 += 1 - right;
      k0 += right;
      rp = right;
      x = right ? x : xd;
#pragma unroll
      for (int p = 0; p < NP; ++p) m[p] = right ? mr[p] : m[p];
      float val = right ? v_r : v_d;
      unsigned frm = right ? f_r : f_d;
      if constexpr (!kSpeculate)
        score_cell<PerKmerStdv>(right ? diag_r : diag_d, right ? p1up : p1o,
                                right ? p1o : p1dn, x, m[0], m[1 % NP],
                                m[2 % NP], lstep, lstay, lp_skip, h_c, val,
                                frm);
      // valid cells: e = e0-o in [0, ne), k = k0+o in [0, nk), o < W
      if (!(pad_ok && (unsigned)(e0 - o) < (unsigned)ne &&
            (unsigned)(k0 + o) < (unsigned)nk)) {
        val = DT_NEG;
        frm = 0u;
      }
      // trim state (event_handling.cpp:255-265), in the band only while
      // k0 < 0
      if (k0 < 0) {
        const int ot = -1 - k0;
        const int et = e0 - ot;
        if (o == ot && et >= 0 && et < ne) {
          val = lp_trim * ((float)et + 1.0f);
          frm = 1u;
        }
      }
      out[o + 1] = val;  // -inf on every cell >= W
      acc |= frm << (2 * j);
      racc |= (unsigned)right << j;
      // ring refills: entering a new granule stores the one waiting in a
      // register (read no earlier than the next barrier) over the oldest
      if (e0 + 1 == e_edge) {
        e_edge += kBlk;
        ev_ring[(e_edge + o) & (kRing - 1)] = ev_next;
        ev_next = load_or0(ev, e_edge + kBlk + o, E);
      }
      if (k0 + W == k_edge) {
        k_edge += kBlk;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          c_ring[p][(k_edge + o) & (kRing - 1)] = c_next[p];
          c_next[p] = load_or0(plane[p], k_edge + kBlk + o, K);
        }
      }
      __syncthreads();
      // final-k-mer start-cell search (event_handling.cpp:324-340), run by
      // every thread on the band just written so the copies stay identical
      if (k0 >= nk - W && k0 < nk) {  // 0 <= o_fin < W
        const int o_fin = nk - 1 - k0;
        const int e_fin = e0 - o_fin;
        if (e_fin >= 0 && e_fin < ne) {
          const float cand = out[o_fin + 1] + (float)(ne - e_fin) * lp_trim;
          if (cand > bs) {
            bs = cand;
            be = e_fin;
          }
        }
      }
      p2dn = p1dn;
      p2o = p1o;
      p2up = p1up;
      float* const oldest = p2;
      p2 = p1;
      p1 = out;
      out = oldest;
    }
    if (o < W) trace[((size_t)step * B + b) * W + o] = (uint8_t)acc;
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
