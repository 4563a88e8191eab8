"""Decoder-only transformer of the port: ``model`` (init, the training
passes, prefill, decode), ``steps`` (the train step and the ``build_*``
functions) and ``convert`` (weights and AdamW state carried across from the
JAX reference)."""
