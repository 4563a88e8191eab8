"""Sum-bag of embedding rows (the port of ``repro.kernels.embedding_bag``):
``ops`` holds the wrapper and its launch counter, ``ref`` the plain version,
``csrc`` the CUDA source."""
