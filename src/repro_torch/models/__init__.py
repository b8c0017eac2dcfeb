"""The decoder LM of the port: layers, attention and the transformer.

Port of :mod:`repro.models` for the dense family (``"attn"`` blocks, no
MoE, MLA or frontend), on one device.  Parameters live in ``nn.Module``s
whose names mirror the reference's parameter tree (``blocks.{i}.attn.wq``
and so on), with the reference's (d_in, d_out) weight orientation used as
``x @ W``.
"""
