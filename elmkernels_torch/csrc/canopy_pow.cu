// double pow for K2 (canopy_stability.cu), compiled on its own with
// contracted multiply-adds (--fmad=true) and linked into K2's library as
// relocatable device code.
//
// PyTorch's own elementwise kernels are built with contraction on, and the
// CUDA math library's double pow, inlined from its headers, rounds some
// inputs differently when its body is compiled without it (a few in a
// million for x ** 4.0 at leaf temperatures; exp, log, atan, sqrt and the
// float pow are the same either way, so K2 compiles float pow inline).
// K2's own arithmetic stays uncontracted (--fmad=false), as the plain
// loop's operations are separate kernels; only double x ** p goes through
// here, so that it is PyTorch's pow_tensor_scalar bit for bit.

#include <math.h>

__device__ double canopy_pow(double x, double p) { return pow(x, p); }
