"""Meshes and collectives (``compat``), and sharding specs on them (``sharding``)."""
