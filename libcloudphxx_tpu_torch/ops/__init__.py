"""Device operations (libcloudphxx_tpu/ops): the root finder, stream
compaction and the wrappers of the step kernels."""
