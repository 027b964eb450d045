// log10 for K3 (snow_snicar.cu), compiled on its own with contracted
// multiply-adds (--fmad=true) and linked into K3's library as relocatable
// device code.
//
// PyTorch's own elementwise kernels are built with contraction on, and a
// CUDA math library function whose body is compiled without it may round
// some inputs differently (K2's and K5's float64 pow did).  K3's own
// arithmetic stays uncontracted (--fmad=false), as the plain sweep's
// operations are separate kernels; its log10, in both types, comes from
// here, so that it is PyTorch's torch.log10 bit for bit.  exp and sqrt are
// inline (exp rounds alike either way, chip_smoke.py:k5_math_rounding and
// the K3 phase; sqrt is correctly rounded).

#include <math.h>

__device__ float snicar_log10(float x) { return log10f(x); }
__device__ double snicar_log10(double x) { return log10(x); }
