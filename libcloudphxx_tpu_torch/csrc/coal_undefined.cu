// Kernel E with the terminal velocity undefined (vt = 0): coal.cuh's
// kernels, instantiated in a source of their own so that nvcc compiles
// them beside the other formulas' (coal.cu holds the entry points).

#include "coal.cuh"

template int lcp::coal_launch<lcp::kVtUndefined>(
    int, const lcp::CoalArgs&, cudaStream_t);
