"""Graph-network helpers of the port (the counterpart of ``repro.models.gnn``);
so far only the MLP of ``common``, which DIN uses."""
