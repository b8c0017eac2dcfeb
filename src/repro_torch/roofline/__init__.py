"""``repro_torch.roofline`` — the roofline model of one NVIDIA H100.

:mod:`repro_torch.roofline.model` ports :mod:`repro.roofline.model`: the
analytic parameter and model-FLOP counts, and a three-term roofline with
the H100's peaks in place of the TPU v5e's.
:mod:`repro_torch.roofline.report` ports :mod:`repro.roofline.report`:
the roofline tables of the records that
:mod:`repro_torch.launch.dryrun` writes.

Not here, with no PyTorch counterpart: :mod:`repro.roofline.hlo_parse`
reads FLOPs, bytes and collective bytes out of compiled XLA HLO text.
The port has no such text; its dry-run counts the same things at the
source instead: a dispatch mode adds each aten op's FLOPs and bytes, and
a recording mesh records each collective the port issues
(:class:`repro_torch.launch.dryrun.CostCounter`,
:class:`repro_torch.launch.dryrun.RecordingMesh`).
"""
