"""Decoder-only transformer of the port: ``model`` (init, prefill, decode)
and ``convert`` (weights carried across from the JAX reference)."""
