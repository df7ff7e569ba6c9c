"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (gather_kernel.py, mfcc_kernel.py, gmm_kernel.py).  The CUDA sources
are under csrc/; they are built at first use on a CUDA tensor (_build.py),
never at import."""
