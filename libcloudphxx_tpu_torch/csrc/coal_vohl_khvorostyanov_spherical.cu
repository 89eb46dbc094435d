// Kernel E's wide-table form (vohl_davis_no_waals) under Khvorostyanov's
// spherical terminal velocity: coal.cuh's kernels, instantiated in a source of
// their own so that nvcc compiles them beside the other forms (coal.cu holds
// the entry points).

#include "coal.cuh"

template int lcp::coal_launch_wide<lcp::kVtKhvorostyanovSpherical>(
    int, const lcp::CoalArgs&, cudaStream_t);
