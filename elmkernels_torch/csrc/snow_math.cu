// float64 pow for K5 (snow_hydrology.cu) and K7 (soil_temperature.cu),
// compiled on its own with contracted multiply-adds (--fmad=true) and
// linked into each one's library as relocatable device code.
//
// PyTorch's own elementwise kernels are built with contraction on, and the
// CUDA math library's float64 pow rounds some inputs differently when its
// body is compiled without it (9,675 of 268 M inputs in K5's ranges on the
// card; K2's canopy_pow.cu found the same).  K5's own arithmetic stays
// uncontracted (--fmad=false), as the plain block's operations are separate
// kernels; its float64 tensor power comes from here, so that it is
// PyTorch's torch.pow of two tensors bit for bit (K7's x ** 4.0 too, which
// PyTorch computes as pow).  acos, exp and float32
// pow round alike either way, and K5 compiles them inline.

#include <math.h>

__device__ double snow_pow(double x, double p) { return pow(x, p); }
