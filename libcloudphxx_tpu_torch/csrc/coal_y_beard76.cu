// Kernel E's y and onishi forms (the 3-D grid's y plane riding, the
// turbulent kernels at dissipation rate 0) under the beard76 terminal
// velocity: coal.cuh's kernels with the rows' type YRows, instantiated in a
// source of their own so that nvcc compiles them beside the other forms
// (coal.cu holds the entry points, onishi.cuh the onishi kernels' value).

#include "onishi.cuh"

template int lcp::coal_launch_y<lcp::kVtBeard76>(
    int, const lcp::CoalArgs&, cudaStream_t);
