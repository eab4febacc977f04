"""Device kernels: CUDA C++ wrappers beside their plain torch versions."""
