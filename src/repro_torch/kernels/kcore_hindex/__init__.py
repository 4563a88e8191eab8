"""Rowwise clipped h-index over ELL tiles (the port of
``repro.kernels.kcore_hindex``): ``ops`` holds the wrapper and its launch
counter, ``ref`` the plain version, ``csrc`` the CUDA source."""
