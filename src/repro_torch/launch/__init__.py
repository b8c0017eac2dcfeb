"""Launch drivers of the port: :mod:`repro_torch.launch.serve`,
:mod:`repro_torch.launch.train` and :mod:`repro_torch.launch.dryrun` (each
(arch, shape, mesh) cell counted on the meta device as one rank of the
production mesh: whether its shardings divide, its FLOPs, bytes, memory
and collective bytes, and its roofline)."""
