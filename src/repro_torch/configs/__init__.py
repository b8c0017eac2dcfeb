"""Model configurations of the port: copies of :mod:`repro.configs`."""
