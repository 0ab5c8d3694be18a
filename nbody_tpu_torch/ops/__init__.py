"""Force operators: the plain torch oracle and the CUDA brute-force kernels."""
