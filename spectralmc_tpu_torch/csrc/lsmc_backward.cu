// The single-state LSMC backward (backward version 3): basis x^a of the
// price alone, for GBM, Merton and the geometric basket. The kernels, their
// design and what bounds them: lsmc_backward.cuh.

#include "lsmc_backward.cuh"

LSMC_ENTRY_POINTS(false)
