// The reference CNN trunk's epilogue: what follows each convolution of the
// trunk, in one pass over the conv result.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA, which
// fuses it into the convolutions' neighbours.  The port's eager module chain
// (models/reference_cnn.py) ran it as separate PyTorch ops, each a full f32
// pass over a (B, C, L) activation: the bias add after the conv result's
// cast to f32, BatchNorm's subtract, multiply, multiply and add, the
// residual add, the ReLU and the next conv's cast back to the conv dtype.
// This kernel does the same operations in the same order, each rounded on
// its own (-fmad=false), so its output equals the chain's bit for bit:
//   v = float(y) + bias
//   v = ((v - mean) * inv) * gamma + beta          (with BatchNorm)
//   v = v + (the second operand's v)               (a block's join)
//   v = isnan(v) ? v : fmaxf(v, 0)                 (torch.relu on CUDA)
//   out = round to the output dtype (__float2bfloat16, as c10::BFloat16)
// A table of (5, C) f32 rows [bias, mean, inv, gamma, beta] (or one row,
// [bias], without BatchNorm) gives each channel's constants; inv is
// rsqrt(var + eps) as the module computes it.
//
// What bounds it on this card: bytes.  Each element is read once per
// operand and written once, with a handful of f32 operations between, so
// the design is a grid-stride loop of 16-byte loads and stores along L (8
// elements a step) over contiguous (B, C, L) tensors, the channel taken
// from the row index; the tables are a few KB and stay in L1.  An L that
// is not a multiple of 8, or an unaligned pointer, takes the one-element
// variant of the same loop.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
enum { kBias, kMean, kInv, kGamma, kBeta };

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kV consecutive elements at p (16-byte aligned when kV is 8)
template <int kV>
__device__ __forceinline__ void load(const float* p, float (&v)[kV]) {
  if constexpr (kV == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) v[j] = load1(p + j);
  }
}

template <int kV>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[kV]) {
  if constexpr (kV == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) v[j] = load1(p + j);
  }
}

template <int kV>
__device__ __forceinline__ void store(float* p, const float (&v)[kV]) {
  if constexpr (kV == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) store1(p + j, v[j]);
  }
}

template <int kV>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[kV]) {
  if constexpr (kV == 8) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) store1(p + j, v[j]);
  }
}

// bias (and BatchNorm) of channel c on the kV elements of a step
template <bool kBN, int kV>
__device__ __forceinline__ void affine(const float* __restrict__ t, int C,
                                       int c, float (&v)[kV]) {
  const float bias = __ldg(t + kBias * C + c);
  float mean = 0.0f, inv = 0.0f, gamma = 0.0f, beta = 0.0f;
  if constexpr (kBN) {
    mean = __ldg(t + kMean * C + c);
    inv = __ldg(t + kInv * C + c);
    gamma = __ldg(t + kGamma * C + c);
    beta = __ldg(t + kBeta * C + c);
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    float x = v[j] + bias;
    if constexpr (kBN) {
      x = x - mean;
      x = x * inv;
      x = x * gamma;
      x = x + beta;
    }
    v[j] = x;
  }
}

// B * C rows of L; a step is kV elements of a row
template <typename TIn, typename TOut, bool kBN, bool kTwo, int kV>
__global__ void __launch_bounds__(kThreads) trunk_epilogue_kernel(
    const TIn* __restrict__ y0, const float* __restrict__ t0,
    const TIn* __restrict__ y1, const float* __restrict__ t1, int C, int L,
    unsigned steps_per_row, unsigned n_steps, TOut* __restrict__ out) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n_steps;
       i += gridDim.x * kThreads) {
    const unsigned row = i / steps_per_row;
    const unsigned col = (i - row * steps_per_row) * kV;
    const int c = (int)(row % (unsigned)C);
    const size_t off = (size_t)row * L + col;
    float v[kV];
    load<kV>(y0 + off, v);
    affine<kBN, kV>(t0, C, c, v);
    if constexpr (kTwo) {
      float w[kV];
      load<kV>(y1 + off, w);
      affine<true, kV>(t1, C, c, w);
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = v[j] + w[j];
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) v[j] = isnan(v[j]) ? v[j] : fmaxf(v[j], 0.0f);
    store<kV>(out + off, v);
  }
}

template <typename TIn, typename TOut, bool kBN, bool kTwo, int kV>
int launch(const void* y0, const float* t0, const void* y1, const float* t1,
           int B, int C, int L, void* out, cudaStream_t stream) {
  const unsigned steps_per_row = (unsigned)(L / kV);
  const unsigned n_steps = (unsigned)B * (unsigned)C * steps_per_row;
  const unsigned want = (n_steps + kThreads - 1) / kThreads;
  const unsigned blocks = want < kMaxBlocks ? want : kMaxBlocks;
  trunk_epilogue_kernel<TIn, TOut, kBN, kTwo, kV>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const TIn*>(y0), t0, static_cast<const TIn*>(y1), t1,
          C, L, steps_per_row, n_steps, static_cast<TOut*>(out));
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, bool kBN, bool kTwo>
int by_width(const void* y0, const float* t0, const void* y1,
             const float* t1, int B, int C, int L, bool vec, void* out,
             cudaStream_t stream) {
  return vec ? launch<TIn, TOut, kBN, kTwo, 8>(y0, t0, y1, t1, B, C, L, out,
                                               stream)
             : launch<TIn, TOut, kBN, kTwo, 1>(y0, t0, y1, t1, B, C, L, out,
                                               stream);
}

template <typename TIn, typename TOut>
int by_form(const void* y0, const float* t0, const void* y1, const float* t1,
            int B, int C, int L, bool has_bn, bool vec, void* out,
            cudaStream_t stream) {
  if (y1 != nullptr)
    return by_width<TIn, TOut, true, true>(y0, t0, y1, t1, B, C, L, vec, out,
                                           stream);
  if (has_bn)
    return by_width<TIn, TOut, true, false>(y0, t0, y1, t1, B, C, L, vec,
                                            out, stream);
  return by_width<TIn, TOut, false, false>(y0, t0, y1, t1, B, C, L, vec, out,
                                           stream);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// y0, y1: contiguous (B, C, L) conv results (y1 null: one operand); t0,
// t1: their (5, C) tables, or t0 (1, C) with has_bn 0 (one operand only);
// in_bf16: the results are bf16, else f32; out_bf16: write bf16 (only from
// bf16), else f32.  Every element count must fit 32 bits.
DT_EXPORT int dt_trunk_epilogue(const void* y0, const float* t0,
                                const void* y1, const float* t1, int B, int C,
                                int L, int has_bn, int in_bf16, int out_bf16,
                                void* out, void* stream) {
  if (B < 1 || C < 1 || L < 1 || (y1 != nullptr && (!has_bn || !t1)) ||
      (out_bf16 && !in_bf16) || (long long)B * C * L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec = L % 8 == 0 && aligned16(y0) && aligned16(y1) &&
                   aligned16(out);
  auto s = (cudaStream_t)stream;
  if (!in_bf16)
    return by_form<float, float>(y0, t0, y1, t1, B, C, L, has_bn, vec, out,
                                 s);
  if (out_bf16)
    return by_form<__nv_bfloat16, __nv_bfloat16>(y0, t0, y1, t1, B, C, L,
                                                 has_bn, vec, out, s);
  return by_form<__nv_bfloat16, float>(y0, t0, y1, t1, B, C, L, has_bn, vec,
                                       out, s);
}
