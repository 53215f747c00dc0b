// csrc/ilqr_generic.cu's native problems in float64 alone: the two
// real types build as two libraries, one nvcc each side by side, which
// halves the longest build of the kernels (optim/ilqr_generic.py loads the
// one of a solve's dtype).
#define ILQR_GENERIC_F64_ONLY
#include "ilqr_generic.cu"
