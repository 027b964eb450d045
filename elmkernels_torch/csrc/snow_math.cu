// pow, acos and exp for K5 (snow_hydrology.cu), compiled on their own with
// contracted multiply-adds (--fmad=true) and linked into K5's library as
// relocatable device code.
//
// PyTorch's own elementwise kernels are built with contraction on, and a
// CUDA math function inlined from its headers may round some inputs
// differently when its body is compiled without it (K2's double pow does:
// canopy_pow.cu).  K5's own arithmetic stays uncontracted (--fmad=false),
// as the plain block's operations are separate kernels; its
// transcendental functions come from here, so that each is PyTorch's
// torch.pow (of two tensors), torch.acos and torch.exp bit for bit.

#include <math.h>

__device__ double snow_pow(double x, double p) { return pow(x, p); }
__device__ float snow_pow(float x, float p) { return powf(x, p); }
__device__ double snow_acos(double x) { return acos(x); }
__device__ float snow_acos(float x) { return acosf(x); }
__device__ double snow_exp(double x) { return exp(x); }
__device__ float snow_exp(float x) { return expf(x); }
