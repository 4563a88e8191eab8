"""Model stacks of the port (the counterparts of ``repro.models``)."""
