// The two-state LSMC backward (backward version 4): basis x^a plus [v, v·x,
// v²] of a second state row set, for Heston (max(v, 0)) and the arithmetic
// basket (its log dispersion). It computes the JAX package's
// ops/american.py::_lsmc_backward with extra_rows, which runs there on XLA.
// The kernels, their design and what bounds them: lsmc_backward.cuh.

#include "lsmc_backward.cuh"

LSMC_ENTRY_POINTS(true)
