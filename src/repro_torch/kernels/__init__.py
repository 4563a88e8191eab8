"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package compiles nothing (see ``_build``)."""
