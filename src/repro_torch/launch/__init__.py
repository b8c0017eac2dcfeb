"""Launch drivers of the port: :mod:`repro_torch.launch.serve`."""
