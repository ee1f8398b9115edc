// Shared definitions for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError(), so the Python wrappers
// (loaded with ctypes) can raise on a refused launch.  The library is built
// with -fmad=false: the dynamic programs compare scores for equality (ties
// pick the first candidate), so each multiply and add must round exactly as
// the plain PyTorch twin's separate ops do.  Never build with fast math: the
// fills rely on +-inf arithmetic (mu = +inf marks an undefined k-mer, -inf an
// unreachable cell).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DT_NEG (-__int_as_float(0x7f800000))
#define DT_EXPORT extern "C" __attribute__((visibility("default")))
