// Kernel E's y and onishi forms (the 3-D grid's y plane riding, the
// turbulent kernels at dissipation rate 0) under the beard76 terminal
// velocity: coal_y.cuh's kernels, a row over one warp or several,
// instantiated in a source of their own so that nvcc compiles them beside
// the other forms (coal.cu holds the entry points).

#include "coal_y.cuh"

template int lcp::coal_launch_y<lcp::kVtBeard76>(
    int, const lcp::CoalArgs&, int*, cudaStream_t);
template int lcp::coal_y_attrs<lcp::kVtBeard76>(
    int, int, int, int*);
