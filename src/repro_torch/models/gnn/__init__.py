"""The GNN family of the port (the counterpart of ``repro.models.gnn``):
SchNet, EGNN, MACE and GraphCast (generic and weather modes), forward paths
on the float segment-sum kernel; ``common`` holds the substrate (scatter,
MLPs, radial bases, batch builders), ``steps`` the registry, node logits and
batch specs, ``convert`` the weight carrier from the reference."""
