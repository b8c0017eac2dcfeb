"""``repro_torch.roofline`` — the roofline model of one NVIDIA H100.

:mod:`repro_torch.roofline.model` ports :mod:`repro.roofline.model`: the
analytic parameter and model-FLOP counts, and a three-term roofline with
the H100's peaks in place of the TPU v5e's.

Not here, with no PyTorch counterpart: :mod:`repro.roofline.hlo_parse`
reads collective bytes out of compiled XLA HLO text, and
:mod:`repro.roofline.report` aggregates the JSON cells that
``repro.launch.dryrun`` writes from XLA's cost analysis.
"""
