// Kernel D: Viterbi termination and backtrace in one launch.
//
// Replaces dnascent_tpu/ops/viterbi_pallas.py:_bt_kernel and the
// termination before it (ops/viterbi.terminate, reference
// alignment.cpp:445-476).  Inputs: kernel C's codes (T, N, W) u8 (I in bits
// 0-1, M in bits 2-4, D in bit 5; windows fastest, at a window stride Wc
// that is a multiple of 16, as viterbi_fill_codes lays them out) and final
// I/M/D columns (N, W) f32, n_obs, n_states (W,) i32, eM2MorD (W,) f32 and
// eI2M.  Outputs: path (W, s_pad) u8, row w holding the walk's codes
// ``kind | delta << 2`` in forward order, left-aligned, with PAD (3) only as
// a tail, and path_len (W,) i32.  A row's PAD-filtered codes and its length
// are those of the JAX kernel's PAD-gapped countdown over s = column +
// position (a walk runs only from s <= s_pad - 1), so that contract holds
// as it stands; both outputs are bitwise equal to
// viterbi_terminate_backtrace_plain.
//
// What bounds it on this card.  Bytes: the walk needs one code byte a step
// (about n_obs + n_states a window), the three finals, eM2MorD, the two
// counts, and writes path and path_len: ~0.25 us at 2048 windows, T=192,
// N=48 (3.35 TB/s).  The chain: each step's byte address depends on the
// previous step's decode, so a window is a chain of up to n_obs + n_states
// dependent steps; even from shared memory a step costs tens of cycles, so
// ~240 steps take several microseconds.  The chain, not the bytes, is the
// floor.  A thread per window with every step a dependent load from device
// memory took ~94 us at that shape (PERF.md).
//
// Design:
//   - a block is one warp and owns kGroup = 16 consecutive windows (one
//     TMA box is at least 16 bytes wide; 32 ran slower), lane l walking
//     window w0 + l.  While its first chunks
//     load, the prologue gathers the finals at n_states - 1 and picks the
//     termination kind from [D, M + eM2MorD, I + eI2M], first wins on ties,
//     as terminate;
//   - codes[t0 : t0 + 16, 0 : N, w0 : w0 + G] (16 columns) arrive by one
//     TMA tensor copy a chunk, backwards in t, into a ring of three
//     shared-memory buffers (two chunks in flight ahead of the walk), each
//     completing on its own mbarrier.  The walk reads code bytes from
//     shared memory only, and no thread spends an instruction on a copy:
//     copies issued by threads (cp.async, 16 bytes each) held the walk's
//     shared-memory loads back by ~45 % (PERF.md).  The TMA needs a global
//     stride that is a multiple of 16, hence kernel C's padded window
//     stride;
//   - a walk's column never rises: each lane walks until the byte it needs
//     lies below the chunk, then waits at the chunk's warp barrier, and
//     every fetched row is used by all G lanes.  A step is one basic block:
//     the byte's load is predicated, the three cells it can move to are
//     located while it loads, and the decode is table lookups in registers,
//     not branches on the kind;
//   - each lane stores its codes back to front, four to a word, into a
//     shared-memory row; when every walk has ended the block writes its
//     rows, which are contiguous in path, forward and left-aligned with the
//     PAD tail, eight bytes a lane (two funnel shifts of staged words), so
//     a warp's stores cover 256 contiguous bytes; then path_len.
#include "common.cuh"

#include <cuda.h>          // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

namespace {

constexpr int KIND_D = 0, KIND_M = 1, KIND_I = 2, KIND_PAD = 3;
constexpr int kGroup = 16;  // windows a block walks, one a lane
constexpr int kChunk = 16;  // code columns a TMA copy brings
constexpr int kBufs = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Copy box {G windows, N states, kChunk columns} at (w0, 0, t0) of the
// codes into shared memory at dst (zeros past W and T), completing on bar.
__device__ __forceinline__ void tma_chunk(unsigned dst, const CUtensorMap* map,
                                          int w0, int t0, unsigned bar,
                                          unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(w0), "r"(0), "r"(t0),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0u;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a byte of shared memory at a 32-bit shared address, or 0 when !pred; no
// branch, so the walk's step stays one basic block
__device__ __forceinline__ unsigned lds_u8_if(unsigned addr, bool pred) {
  unsigned v = 0u;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
      "@p ld.shared.u8 %0, [%1];\n\t}\n"
      : "+r"(v)
      : "r"(addr), "r"((unsigned)pred));
  return v;
}

__device__ __forceinline__ void sts_u32(unsigned addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__global__ void __launch_bounds__(32) viterbi_terminate_backtrace_kernel(
    const __grid_constant__ CUtensorMap codes_map,
    const float* __restrict__ I_fin, const float* __restrict__ M_fin,
    const float* __restrict__ D_fin, const int* __restrict__ n_obs,
    const int* __restrict__ n_states, const float* __restrict__ eM2MorD,
    float eI2M, int T, int N, int W, int s_pad,
    uint8_t* __restrict__ path_code, int* __restrict__ path_len) {
  constexpr int G = kGroup;
  // [kBufs][kChunk][N][G] chunk ring, [G][s_pad + 4] staged rows (an odd
  // word stride: lanes on their own banks), [G] lengths, [kBufs] mbarriers
  extern __shared__ __align__(128) uint8_t smem[];
  const int chunk_bytes = kChunk * N * G;
  const int stage_stride = s_pad + 4;
  const int stage_off = kBufs * chunk_bytes;
  int* sh_len = reinterpret_cast<int*>(smem + stage_off + G * stage_stride);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned bar0 =
      (unsigned)__cvta_generic_to_shared(sh_len + G);  // 8-byte aligned

  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * G;
  const int nv = min(G, W - w0);
  const bool walker = lane < nv;
  const int w = w0 + lane;
  const int stage_row = stage_off + lane * stage_stride;

  if (lane == 0) {
    for (int b = 0; b < kBufs; ++b) mbar_init(bar0 + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // walk state; a window with no step has live = false
  int kind = 0, pos = 0, col = 0, n = 0;
  unsigned acc = 0u;  // the last n % 4 codes, newest in the low byte
  bool live = false;
  int tneed = -1;
  if (walker) {
    pos = n_states[w] - 1;
    col = n_obs[w];
    const int s0 = col + pos;
    live = col >= 0 && s0 >= 0 && s0 <= s_pad - 1;
    if (live) {
      const int t = s0 - 1 - min(max(pos, 0), N - 1);
      tneed = t < T ? t : T - 1;
    }
  }
  const int top = max(__reduce_max_sync(kFull, tneed), 0) / kChunk;
  __syncwarp();  // the mbarriers are initialised

  // chunks top .. top - (kBufs - 2) in flight; chunk c lands in buffer
  // c % kBufs, whose ((top - c) / kBufs)-th fill it is
  if (lane == 0)
    for (int k = 0; k < kBufs - 1 && top - k >= 0; ++k) {
      const int ck = top - k;
      tma_chunk(sbase + (ck % kBufs) * chunk_bytes, &codes_map, w0,
                ck * kChunk, bar0 + 8 * (ck % kBufs), chunk_bytes);
    }
  if (walker) {
    // termination (alignment.cpp:445-476), while the first chunks load:
    // first of D, M, I wins ties; a NaN candidate makes torch's max NaN,
    // which equals none: I
    const size_t li = (size_t)min(max(pos, 0), N - 1) * W + w;
    const float c0 = D_fin[li];
    const float c1 = M_fin[li] + eM2MorD[w];
    const float c2 = I_fin[li] + eI2M;
    if (isnan(c0) || isnan(c1) || isnan(c2))
      kind = KIND_I;
    else
      kind = (c0 >= c1 && c0 >= c2) ? KIND_D : (c1 >= c2 ? KIND_M : KIND_I);
  }
  const unsigned stage_word = sbase + stage_row + s_pad - 4;
  for (int c = top; c >= 0; --c) {
    const int ahead = c - (kBufs - 1);  // into the buffer chunk c + 1 left
    if (lane == 0 && ahead >= 0)
      tma_chunk(sbase + (ahead % kBufs) * chunk_bytes, &codes_map, w0,
                ahead * kChunk, bar0 + 8 * (ahead % kBufs), chunk_bytes);
    mbar_wait(bar0 + 8 * (c % kBufs), ((top - c) / kBufs) & 1);
    const int t0 = c * kChunk;
    const unsigned cur = sbase + (c % kBufs) * chunk_bytes + lane;
    int t = col + pos - 1 - min(max(pos, 0), N - 1);  // s - 1 - clamped pos
    unsigned idx = cur + ((t - t0) * N + min(max(pos, 0), N - 1)) * G;
    while (live) {
      const bool need = (unsigned)t < (unsigned)T;
      if (need && t < t0) break;  // below this chunk: wait for the next
      const unsigned byte = lds_u8_if(idx, need);
      // the cells a step can move to, located while the byte loads: D
      // (col, pos - 1), K (col - 1, pos: I, or M keeping its position) and
      // M (col - 1, pos - 1), each at column s - 1 - clamped position
      const int pc0 = min(max(pos, 0), N - 1);
      const int pc1 = min(max(pos - 1, 0), N - 1);
      const int tD = col + pos - 2 - pc1;
      const int tK = col + pos - 2 - pc0;
      const unsigned iD = cur + ((tD - t0) * N + pc1) * G;
      const unsigned iK = cur + ((tK - t0) * N + pc0) * G;
      const bool isD = kind == KIND_D, isM = kind == KIND_M;
      const unsigned iX = isD ? iD : iD - N * G;  // D, or M at column - 1
      const int tX = isD ? tD : tD - 1;
      // the kind's field of the byte (D bit 5, M bits 2-4, I bits 0-1)
      // and, per field value, keep (the position stays), the next kind
      // (2 bits) and fin (the start is reached):
      //   D: same column, position - 1; the init column chains to start;
      //   M: column - 1, position - 1 unless cM is 2 or the start (4);
      //   I: column - 1, same position; cI == 2 is the start
      const bool at_init = col == 0;
      const unsigned sh = isD ? 5u : (isM ? 2u : 0u);
      const unsigned msk = isD ? 1u : (isM ? 7u : 3u);
      const unsigned keepT = isD ? 0x0u : (isM ? 0xF4u : 0xFu);
      const unsigned nkT =
          isD ? (at_init ? 0x0u : 0x1u) : (isM ? 0x5516u : 0x56u);
      const unsigned finT =
          isD ? ((at_init && pos == 0) ? 0x3u : 0x0u) : (isM ? 0x10u : 0x4u);
      const unsigned f = (byte >> sh) & msk;
      const bool keep = (keepT >> f) & 1u;
      const int nk = (int)((nkT >> (2u * f)) & 3u);
      const bool fin = (finT >> f) & 1u;
      // codes go back to front, four to a word: the word of this step's
      // group is stored every step and is right once the group is full
      // (the last, partial group is stored bytewise after the walk)
      acc = (acc << 8) | (unsigned)(kind | (keep ? 0 : 4));
      sts_u32(stage_word - (n & ~3), acc);
      ++n;
      kind = nk;
      idx = keep ? iK : iX;
      t = keep ? tK : tX;
      pos = keep ? pos : pos - 1;
      col = isD ? col : col - 1;
      live = !fin && col + pos >= 0;
    }
    __syncwarp();  // every lane is done with buffer c % kBufs
  }
  if (walker) {
    for (int b = 0; b < (n & 3); ++b)  // the codes not yet stored
      smem[stage_row + s_pad - n + b] = (uint8_t)(acc >> (8 * b));
    sh_len[lane] = n;
  }
  __syncwarp();

  // the block's rows are contiguous in path: write them forward,
  // left-aligned, PAD-tailed, 8 bytes a lane and 16-byte runs a lane pair
  // (s_pad % 8 == 0, so 8 bytes never straddle two rows).  Row r's codes
  // sit at [s_pad - len, s_pad) of its staged row: eight of them are two
  // funnel shifts of three aligned words
  const int total = nv * s_pad;
  uint8_t* dst = path_code + (size_t)w0 * s_pad;
  const unsigned long long kPad8 = 0x0303030303030303ull;
  for (int e0 = lane * 8; e0 < total; e0 += 32 * 8) {
    const int r = e0 / s_pad;
    const int j = e0 - r * s_pad;
    const int len = sh_len[r];
    unsigned long long v = kPad8;
    if (j < len) {
      const int src = stage_off + r * stage_stride + (s_pad - len) + j;
      const uint32_t* wp =
          reinterpret_cast<const uint32_t*>(smem + (src & ~3));
      const unsigned sh = 8u * (src & 3);
      const unsigned lo = __funnelshift_r(wp[0], wp[1], sh);
      const unsigned hi = __funnelshift_r(wp[1], wp[2], sh);
      v = ((unsigned long long)hi << 32) | lo;
      if (len - j < 8) {  // the PAD tail starts inside these eight
        const unsigned long long pad = ~0ull << (8 * (len - j));
        v = (v & ~pad) | (kPad8 & pad);
      }
    }
    *reinterpret_cast<unsigned long long*>(dst + e0) = v;
  }
  if (walker) path_len[w] = n;
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

}  // namespace

DT_EXPORT int dt_viterbi_terminate_backtrace(
    const uint8_t* codes, const float* I_fin, const float* M_fin,
    const float* D_fin, const int* n_obs, const int* n_states,
    const float* eM2MorD, float eI2M, int T, int N, int W, int Wc, int s_pad,
    uint8_t* path_code, int* path_len, void* stream) {
  constexpr int G = kGroup;
  // the TMA needs a 16-byte aligned base and window stride, and a box of
  // at most 256 states; the 16-byte path stores an aligned base
  if (W < 1 || T < 1 || N < 1 || N > 256 || Wc < W || Wc % 16 != 0 ||
      s_pad < 8 || s_pad % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) ||
      (reinterpret_cast<uintptr_t>(path_code) & 15))
    return (int)cudaErrorInvalidValue;
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)N, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)Wc, (cuuint64_t)N * Wc};
  const cuuint32_t box[3] = {(cuuint32_t)G, (cuuint32_t)N,
                             (cuuint32_t)kChunk};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             const_cast<uint8_t*>(codes), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kBufs * kChunk * N * G +
                      (size_t)G * (s_pad + 4) + 4 * G + 8 * kBufs;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = viterbi_terminate_backtrace_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(W + G - 1) / G, 32, smem, (cudaStream_t)stream>>>(
      map, I_fin, M_fin, D_fin, n_obs, n_states, eM2MorD, eI2M, T, N, W,
      s_pad, path_code, path_len);
  return (int)cudaGetLastError();
}
