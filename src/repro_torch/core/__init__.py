"""Public GEMM entry points of the port."""
