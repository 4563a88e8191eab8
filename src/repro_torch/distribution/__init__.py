"""Meshes and collectives of the sharded k-core engines (``compat``)."""
