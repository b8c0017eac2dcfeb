"""Launch drivers of the port: :mod:`repro_torch.launch.serve` and
:mod:`repro_torch.launch.train`."""
