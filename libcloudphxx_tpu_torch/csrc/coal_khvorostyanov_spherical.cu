// Kernel E under the khvorostyanov_spherical terminal velocity: coal.cuh's
// kernels, instantiated in a source of their own so that nvcc compiles
// them beside the other formulas' (coal.cu holds the entry points).

#include "coal.cuh"

template int lcp::coal_launch<lcp::kVtKhvorostyanovSpherical>(
    int, const lcp::CoalArgs&, cudaStream_t);
