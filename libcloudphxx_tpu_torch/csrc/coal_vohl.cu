// Kernel E's wide-table form (vohl_davis_no_waals) under the beard77 formulas
// (the main path's): coal.cuh's kernels, instantiated in a source of their own
// so that nvcc compiles them beside the other forms (coal.cu holds the entry
// points).

#include "coal.cuh"

template int lcp::coal_launch_wide<lcp::kVtBeard77>(
    int, const lcp::CoalArgs&, cudaStream_t);
