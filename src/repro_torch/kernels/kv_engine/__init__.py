"""Register-store read and dirty-append kernels (CUDA, ``csrc/``)."""
