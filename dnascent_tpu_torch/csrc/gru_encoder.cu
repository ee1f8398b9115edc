// Kernel F: the reference CNN's signal encoder, two stacked Keras-v2 GRU(16)
// cells with reset_after over each position's window of u8-quantised raw
// samples.
//
// Replaces dnascent_tpu/models/reference_cnn.py:_gru_pallas_kernel (wrapper
// _gru_scan_pallas).  Same contract: rows are independent; step t dequantises
// x = (q - 1) / SIG_QUANT_SCALE + SIG_QUANT_LO in f32 and is live when
// q != 0 and x != 0.0; a dead step carries both states through; the output is
// the second cell's final state, (N, 16) f32.  The division is IEEE (the
// library is never built with fast math) and -fmad=false keeps the
// "+ SIG_QUANT_LO" rounded on its own, so the live-step decisions equal the
// plain twin's, including the code q=128 whose value lands next to 0.0.
//
// What bounds it on this card: arithmetic and shared-memory reads.  A live
// step costs three 16x48 matrix-vector products (about 2.3k multiply-adds)
// plus 32 sigmoids and 32 tanhs per row, against 20 bytes of input and 64
// bytes of output per row.  Design: one thread per row with both 16-wide
// states in registers; the packed weights (2544 floats, 9.9 KB, matrices
// stored transposed so each gate's 16 weights are contiguous) are copied into
// shared memory once per block, and every thread of a warp reads the same
// float4 at the same time (a broadcast: four multiply-adds per load, no bank
// conflicts).  An opaque zero offset, renewed every step, keeps the compiler
// from hoisting all 2544 weights into registers across the step loop (which
// spills them to local memory).  The TPU's transposed (T, N) layout, row-block
// padding and weight-plane stacking were Mosaic workarounds and are gone.
// The dot products use explicit fmaf in the twin's summation order (they are
// held to the twin within a tolerance, not bitwise); the gate sums and the
// state update are separate roundings, as in the twin.
#include "common.cuh"

namespace {

constexpr int kU = 16;
constexpr int kG = 3 * kU;
// packed layout (ops/gru.py): k0, b0x, b0h, b1x, b1h rows of 48, then U0,
// W1, U1 transposed to (48, 16)
constexpr int kK0 = 0, kB0x = kG, kB0h = 2 * kG, kB1x = 3 * kG, kB1h = 4 * kG;
constexpr int kU0 = 5 * kG, kW1 = kU0 + kG * kU, kU1 = kW1 + kG * kU;
constexpr int kPacked = kU1 + kG * kU;
constexpr int kThreads = 128;
static_assert(kU0 % 4 == 0 && kW1 % 4 == 0 && kU1 % 4 == 0,
              "matrices must be float4-aligned");

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// v . w for 16 contiguous weights, summed in order 0..15
__device__ __forceinline__ float dot16(const float (&v)[kU],
                                       const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float a = 0.0f;
#pragma unroll
  for (int q = 0; q < kU / 4; ++q) {
    const float4 c = w4[q];
    a = fmaf(v[4 * q + 0], c.x, a);
    a = fmaf(v[4 * q + 1], c.y, a);
    a = fmaf(v[4 * q + 2], c.z, a);
    a = fmaf(v[4 * q + 3], c.w, a);
  }
  return a;
}

// One cell: new state from the input-side gates gx_at(j) (already biased),
// the transposed recurrent matrix UT (48, 16) and its bias bh.
template <typename GX>
__device__ __forceinline__ void cell(const float* UT, const float* bh,
                                     const float (&h)[kU], GX gx_at,
                                     float (&out)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const float z = sigmoid(gx_at(u) + (dot16(h, UT + u * kU) + bh[u]));
    const float r =
        sigmoid(gx_at(kU + u) + (dot16(h, UT + (kU + u) * kU) + bh[kU + u]));
    const float hh = tanhf(gx_at(2 * kU + u) +
                           r * (dot16(h, UT + (2 * kU + u) * kU) +
                                bh[2 * kU + u]));
    out[u] = z * h[u] + (1.0f - z) * hh;
  }
}

__global__ void __launch_bounds__(kThreads) gru_encoder_kernel(
    const uint8_t* __restrict__ xq, const float* __restrict__ w, int N, int T,
    float scale, float lo, float* __restrict__ out) {
  __shared__ __align__(16) float sw[kPacked];
  for (int i = threadIdx.x; i < kPacked; i += blockDim.x) sw[i] = w[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const uint8_t* xr = xq + (size_t)row * T;
  float h0[kU], h1[kU], n0[kU], n1[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) h0[u] = h1[u] = 0.0f;

  int zero = 0;
  for (int t = 0; t < T; ++t) {
    const unsigned q = xr[t];
    const float x = ((float)q - 1.0f) / scale + lo;
    if (q == 0u || x == 0.0f) continue;  // masked step: state carried through
    asm volatile("" : "+r"(zero));       // weights: re-read, never hoisted
    const float* W = sw + zero;
    // cell 0: input side is x * k0 + b0x (one rounded product, as the twin's
    // (N, 1) x (1, 48) matmul)
    cell(W + kU0, W + kB0h, h0,
         [&](int j) { return x * W[kK0 + j] + W[kB0x + j]; }, n0);
    // cell 1: input side is n0 . W1 + b1x
    cell(W + kU1, W + kB1h, h1,
         [&](int j) { return dot16(n0, W + kW1 + j * kU) + W[kB1x + j]; },
         n1);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h0[u] = n0[u];
      h1[u] = n1[u];
    }
  }
  float* o = out + (size_t)row * kU;
#pragma unroll
  for (int u = 0; u < kU; ++u) o[u] = h1[u];
}

}  // namespace

DT_EXPORT int dt_gru_encoder(const uint8_t* xq, const float* w, int N, int T,
                             float scale, float lo, float* out, void* stream) {
  if (N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kThreads - 1) / kThreads;
  gru_encoder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xq, w, N, T, scale, lo, out);
  return (int)cudaGetLastError();
}
