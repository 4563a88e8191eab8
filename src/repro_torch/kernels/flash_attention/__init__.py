"""Blockwise online-softmax attention (the port of
``repro.kernels.flash_attention``): ``ops`` holds the wrapper and its launch
counter, ``ref`` the plain version, ``csrc`` the CUDA source."""
