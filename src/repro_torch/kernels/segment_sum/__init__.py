"""Segment sums (the port of ``repro.kernels.segment_sum``): of int32 values
over CSR rows for the k-core path, and of float32 or bf16 rows through a
``SegmentLayout`` for the GNNs. ``ops`` holds the wrappers and their launch
counters, ``ref`` the plain versions, ``csrc`` the CUDA source."""
