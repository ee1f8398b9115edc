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
// What bounds it on this card: the three 16x48 matrix products of a live
// step (2352 multiply-adds a row), against 20 bytes of input and 64 bytes of
// output per row.  With one thread per row on the f32 pipes, every lane
// needs every weight, so shared memory's 128 bytes a cycle, not the FMA
// rate, set the pace.  Design:
//   - a dead step carries the state, which is the same as skipping it, so
//     rows walk only their live steps (a 32-step live mask, popped with
//     __ffs);
//   - a block ranks its 256 rows by live count (a counting sort in shared
//     memory) and a warp takes them 16 at a time in rank order, so the 16
//     rows of a tile need near-equal numbers of steps; a tile runs as many
//     steps as its longest row, and a row past its last live step is
//     masked.  Outputs go back to each row's own index;
//   - each product is a 16-row tile times a (16, 48) matrix on the tensor
//     cores: mma.sync m16n8k8 in TF32, three products a term (big x big +
//     big x small + small x big, each operand split into a TF32 "big" part
//     and the TF32 rounding of its remainder), which keeps the f32 products'
//     error (a few 1e-7, against the 2e-5 contract).  The weight fragments
//     are split once per block into shared memory;
//   - the k index of each product is permuted (k = t <-> unit 8j + 2t,
//     k = t + 4 <-> unit 8j + 2t + 1), so the accumulator fragment that
//     holds a new state is the next product's input fragment as it stands:
//     the states never leave registers and no shuffle relays them;
//   - the gate math runs on the accumulator fragments: lane (g, t) owns
//     units 2t, 2t+1, 8+2t, 8+2t+1 of rows g and g+8, and z, r and n of a
//     unit sit in the same lane; sigmoid is __fdividef(1, 1 + __expf(-v))
//     and tanh(v) = 2 sigmoid(2v) - 1.
// The gate sums and the state update are separate roundings, as in the twin.
#include "common.cuh"

namespace {

constexpr int kU = 16;
constexpr int kG = 3 * kU;
// packed layout (ops/gru.py): k0, b0x, b0h, b1x, b1h rows of 48, then U0,
// W1, U1, each (48, 16): element [out][in] of the (16 in, 48 out) matrix
constexpr int kVec = 5;
constexpr int kMat0 = kVec * kG;
constexpr int kMats = 3;  // U0, W1, U1
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;  // rows a block ranks
constexpr int kTile = 16;   // rows of an mma tile
constexpr int kBins = 33;   // live counts 0..31, and 32 or more
constexpr int kNT = kG / 8;  // n-tiles of a product: z 0-1, r 2-3, n 4-5
constexpr unsigned kFull = 0xffffffffu;
enum { kK0, kB0x, kB0h, kB1x, kB1h };  // vector rows of the packed layout
enum { kU0, kW1, kU1 };                // matrices

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float tanh_fast(float v) {
  return 2.0f * sigmoid(2.0f * v) - 1.0f;
}

// the TF32 big and small parts of a state fragment h[j][e] as the A
// fragment of k-step j: a0 (row g, k t) = e0, a1 (row g+8, k t) = e2,
// a2 (row g, k t+4) = e1, a3 (row g+8, k t+4) = e3
__device__ __forceinline__ void split(const float (&h)[2][4],
                                      uint32_t (&big)[2][4],
                                      uint32_t (&small)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = h[j][(a == 1) ? 2 : (a == 2) ? 1 : a];
      big[j][a] = to_tf32(v);
      small[j][a] = to_tf32(v - __uint_as_float(big[j][a]));
    }
}

// acc[nt] = state (16 rows x 16) . matrix m, all six n-tiles
__device__ __forceinline__ void product(const float4 (*fb)[2][kNT][32], int m,
                                        int lane, const uint32_t (&big)[2][4],
                                        const uint32_t (&small)[2][4],
                                        float (&acc)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float4 b = fb[m][ks][nt][lane];
      const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
      mma_tf32(acc[nt], small[ks], bb0, bb1);
      mma_tf32(acc[nt], big[ks], __float_as_uint(b.z),
               __float_as_uint(b.w));
      mma_tf32(acc[nt], big[ks], bb0, bb1);
    }
  }
}

// one cell's gates and masked update on the fragments: gx(nt, e) is the
// input side (already biased), gh[nt][e] + bh the recurrent side
template <typename GX>
__device__ __forceinline__ void gates(const float2 (*sv)[kNT][4], int bh,
                                      int t, GX gx, const float (&gh)[kNT][4],
                                      const bool (&live)[2], float (&h)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 hz = sv[bh][j][t], hr = sv[bh][2 + j][t],
                 hn = sv[bh][4 + j][t];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      const float z = sigmoid(gx(j, e) + (gh[j][e] + (c ? hz.y : hz.x)));
      const float r =
          sigmoid(gx(2 + j, e) + (gh[2 + j][e] + (c ? hr.y : hr.x)));
      const float n = tanh_fast(gx(4 + j, e) +
                                r * (gh[4 + j][e] + (c ? hn.y : hn.x)));
      const float hnew = z * h[j][e] + (1.0f - z) * n;
      h[j][e] = live[e >> 1] ? hnew : h[j][e];
    }
  }
}

__device__ __forceinline__ float dequant(unsigned q, float scale, float lo) {
  return ((float)q - 1.0f) / scale + lo;
}

// bit j set where step t0 + j of the row is live (t0 + j < T, j < 32)
__device__ __forceinline__ unsigned live_mask(const uint8_t* xr, int t0, int T,
                                              float scale, float lo) {
  unsigned m = 0u;
  const int n = min(32, T - t0);
  for (int j = 0; j < n; ++j) {
    const unsigned q = xr[t0 + j];
    if (q != 0u && dequant(q, scale, lo) != 0.0f) m |= 1u << j;
  }
  return m;
}

// four blocks an SM: 128 registers a thread, no spill (ptxas); the
// unbounded build took 138 and ran 6 % slower
__global__ void __launch_bounds__(kThreads, 4) gru_encoder_kernel(
    const uint8_t* __restrict__ xq, const float* __restrict__ w, int N, int T,
    float scale, float lo, float* __restrict__ out) {
  // weight fragments: [matrix][k-step][n-tile][lane] = (b0, b1) big, then
  // small; b0 = M[in 8ks + 2t][out 8nt + g], b1 = M[in 8ks + 2t + 1][...]
  __shared__ float4 fb[kMats][2][kNT][32];
  // vector rows by fragment column: [row][n-tile][t] = cols 8nt + 2t, +1
  __shared__ float2 sv[kVec][kNT][4];
  __shared__ int bin_count[kBins], bin_start[kBins];
  __shared__ int order[kRows];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kRows;
  for (int i = tid; i < kMats * 2 * kNT * 32; i += kThreads) {
    const int lane = i % 32, nt = (i / 32) % kNT, ks = (i / (32 * kNT)) % 2,
              m = i / (32 * kNT * 2);
    const int col = 8 * nt + lane / 4, in0 = 8 * ks + 2 * (lane % 4);
    const float* M = w + kMat0 + m * kG * kU + col * kU;
    const float v0 = M[in0], v1 = M[in0 + 1];
    const uint32_t g0 = to_tf32(v0), g1 = to_tf32(v1);
    fb[m][ks][nt][lane] = make_float4(
        __uint_as_float(g0), __uint_as_float(g1),
        __uint_as_float(to_tf32(v0 - __uint_as_float(g0))),
        __uint_as_float(to_tf32(v1 - __uint_as_float(g1))));
  }
  for (int i = tid; i < kVec * kNT * 4; i += kThreads) {
    const int t = i % 4, nt = (i / 4) % kNT, v = i / (4 * kNT);
    const float* row = w + v * kG + 8 * nt + 2 * t;
    sv[v][nt][t] = make_float2(row[0], row[1]);
  }
  for (int i = tid; i < kBins; i += kThreads) bin_count[i] = 0;
  __syncthreads();

  // rank the block's rows by live count
  constexpr int kPer = kRows / kThreads;
  int bin[kPer], slot[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int row = base + tid + r * kThreads;
    int n = 0;
    if (row < N) {
      for (int t0 = 0; t0 < T; t0 += 32)
        n += __popc(live_mask(xq + (size_t)row * T, t0, T, scale, lo));
    }
    bin[r] = min(n, kBins - 1);
    slot[r] = atomicAdd(&bin_count[bin[r]], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int b = 0; b < kBins; ++b) {
      bin_start[b] = s;
      s += bin_count[b];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    order[bin_start[bin[r]] + slot[r]] = tid + r * kThreads;
  __syncthreads();

  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  for (int tile = tid / 32; tile < kRows / kTile; tile += kWarps) {
    // this lane's rows: g and g + 8 of the tile
    int row[2];
    const uint8_t* xr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = base + order[tile * kTile + g + 8 * i];
      xr[i] = xq + (size_t)(row[i] < N ? row[i] : 0) * T;
    }
    // states as accumulator fragments: h[j][e] = unit 8j + 2t + (e & 1) of
    // row g + 8 (e >> 1)
    float h0[2][4], h1[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h0[j][e] = h1[j][e] = 0.0f;
    for (int t0 = 0; t0 < T; t0 += 32) {
      unsigned m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[i] = row[i] < N ? live_mask(xr[i], t0, T, scale, lo) : 0u;
      const int steps = __reduce_max_sync(
          kFull, (unsigned)max(__popc(m[0]), __popc(m[1])));
      for (int s = 0; s < steps; ++s) {
        bool live[2];
        float x[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          live[i] = m[i] != 0u;
          const int ti = live[i] ? t0 + __ffs(m[i]) - 1 : t0;
          x[i] = live[i] ? dequant(xr[i][ti], scale, lo) : 0.0f;
          m[i] &= m[i] - 1u;
        }
        uint32_t big[2][4], small[2][4];
        float acc[kNT][4], acc1[kNT][4];
        // cell 0: input side x * k0 + b0x (one rounded product, as the
        // twin's (N, 1) x (1, 48) matmul)
        split(h0, big, small);
        product(fb, kU0, lane, big, small, acc);
        gates(sv, kB0h, t,
              [&](int nt, int e) {
                const float2 k = sv[kK0][nt][t], b = sv[kB0x][nt][t];
                return x[e >> 1] * ((e & 1) ? k.y : k.x) +
                       ((e & 1) ? b.y : b.x);
              },
              acc, live, h0);
        // cell 1: input side n0 . W1 + b1x (a row without a live step feeds
        // its old h0 here, and its result is dropped)
        split(h0, big, small);
        product(fb, kW1, lane, big, small, acc1);
        split(h1, big, small);
        product(fb, kU1, lane, big, small, acc);
        gates(sv, kB1h, t,
              [&](int nt, int e) {
                const float2 b = sv[kB1x][nt][t];
                return acc1[nt][e] + ((e & 1) ? b.y : b.x);
              },
              acc, live, h1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= N) continue;
      float* o = out + (size_t)row[i] * kU + 2 * t;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(h1[j][2 * i], h1[j][2 * i + 1]);
    }
  }
}

}  // namespace

DT_EXPORT int dt_gru_encoder(const uint8_t* xq, const float* w, int N, int T,
                             float scale, float lo, float* out, void* stream) {
  if (N < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kRows - 1) / kRows;
  gru_encoder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xq, w, N, T, scale, lo, out);
  return (int)cudaGetLastError();
}
