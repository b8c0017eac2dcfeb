"""Carry state across from the JAX package as numpy arrays.

A table's planes (codes, meta, care) are its state; an HDC model's are its
projection and class hypervectors.  The reference hands them over as numpy
arrays (``np.asarray(table.codes)``, ``np.asarray(model.projection)`` and so
on), so this module needs neither JAX nor the reference package.
"""

from __future__ import annotations

import torch

from repro_torch.core import am, hdc
from repro_torch.device import resolve_device


def am_table_from_numpy(codes, *, bits: int, distance: str, meta=None,
                        care=None, device=None) -> am.AMTable:
    """An :class:`~repro_torch.core.am.AMTable` from a table's numpy planes.

    ``codes`` (N, D), ``meta`` (N, ...) and ``care`` (N, D) are the planes of
    a reference ``AMTable``; ``bits`` and ``distance`` its static fields.
    ``device=None`` puts the table on the GPU.
    """
    return am.make_table(codes, bits=bits, distance=distance, meta=meta,
                         care_mask=care, device=device)


def hdc_model_from_numpy(config: hdc.HDCConfig, projection, class_hvs,
                         device=None) -> hdc.HDCModel:
    """An :class:`~repro_torch.core.hdc.HDCModel` from a reference model's
    (n, D) projection and (K, D) class hypervectors, as float32 copies on
    ``device`` (default the GPU).  ``config`` is the port's
    :class:`~repro_torch.core.hdc.HDCConfig` with the reference's fields.
    """
    dev = resolve_device(device)
    proj = torch.tensor(projection, dtype=torch.float32, device=dev)
    chv = torch.tensor(class_hvs, dtype=torch.float32, device=dev)
    if tuple(proj.shape) != (config.n_features, config.dim):
        raise ValueError(f"projection shape {tuple(proj.shape)} != "
                         f"({config.n_features}, {config.dim})")
    if tuple(chv.shape) != (config.n_classes, config.dim):
        raise ValueError(f"class_hvs shape {tuple(chv.shape)} != "
                         f"({config.n_classes}, {config.dim})")
    return hdc.HDCModel(config, proj, chv)
