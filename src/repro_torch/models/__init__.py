"""The decoder LM of the port: layers, attention, the model families and
the transformer.

Port of :mod:`repro.models` for all ten architectures (dense GQA, MoE,
MLA, local attention, RG-LRU, xLSTM and the stub frontends), on one
device or, for the expert-parallel MoE, over a mesh's ``model`` axis.
Parameters live in ``nn.Module``s whose names mirror the reference's
parameter tree (``blocks.{i}.attn.wq`` and so on), with the reference's
(d_in, d_out) weight orientation used as ``x @ W``.
"""
