"""Segment sum of int32 values over CSR rows (the port of
``repro.kernels.segment_sum``): ``ops`` holds the wrapper and its launch
counter, ``ref`` the plain version, ``csrc`` the CUDA source."""
