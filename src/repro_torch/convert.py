"""Carry state across from the JAX package as numpy arrays.

A table's planes (codes, meta, care) are its state; an HDC model's are its
projection and class hypervectors; an LM's are its parameter tree, and a
training run's its ``TrainState``.  The reference hands them over as numpy
arrays (``np.asarray(table.codes)``, ``np.asarray(model.projection)``,
``jax.tree.map(np.asarray, params)`` and so on), so this module needs
neither JAX nor the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core import am, hdc
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.train import optimizer, train_step


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


def _tensor(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor, bfloat16 carried bit for bit.

    ``torch.from_numpy`` rejects the ``bfloat16`` numpy dtype of
    ``ml_dtypes`` (which the reference's ``np.asarray`` gives), so such a
    leaf is viewed as uint16 and then as ``torch.bfloat16``.  The dtype is
    recognised by its name: ``ml_dtypes`` is not imported.
    """
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def lm_params_from_numpy(cfg: ModelCfg, params_np, device=None,
                         dtype=None) -> transformer.LM:
    """A :class:`~repro_torch.models.transformer.LM` from the reference's
    parameter tree with numpy leaves, on ``device`` (default the GPU).

    The leading L axis of a scanned uniform stack (``params["blocks"]`` a
    dict of (L, ...) leaves) is unstacked into ``blocks.{i}``; a list of
    per-layer dicts maps one to one.  Every leaf keeps its dtype and values
    bit for bit; names and shapes must match the port's modules exactly,
    and dtypes the LM's of ``dtype`` (default the config's).
    """
    dev = resolve_device(device)
    model = transformer.LM(cfg, dev, dtype)
    flat = dict(_flatten({k: v for k, v in params_np.items()
                          if k != "blocks"}))
    blocks = params_np["blocks"]
    if isinstance(blocks, dict):                # scanned: (L, ...) leaves
        for name, leaf in _flatten(blocks):
            leaf = np.asarray(leaf)
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(f"blocks.{name}: leading axis "
                                 f"{leaf.shape[0]} != {cfg.n_layers} layers")
            for i in range(cfg.n_layers):
                flat[f"blocks.{i}.{name}"] = leaf[i]
    else:
        flat.update(_flatten({"blocks": list(blocks)}))
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(own))}")
    for name, leaf in flat.items():
        t = _tensor(leaf)
        if t.dtype != own[name].dtype or t.shape != own[name].shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} != "
                             f"{own[name].dtype} {tuple(own[name].shape)}")
        own[name].copy_(t)
    return model


def train_state_from_numpy(cfg: ModelCfg, state_np,
                           device=None) -> train_step.TrainState:
    """A :class:`~repro_torch.train.train_step.TrainState` from the
    reference's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``), on ``device`` (default the GPU).

    The weights (with gradients on), the float32 master weights, both
    moments, the count, the step and the EF buffers (when the state has
    them) are carried bit for bit, each parameter tree unstacked as
    :func:`lm_params_from_numpy` unstacks one.
    """
    dev = resolve_device(device)

    def f32_tree(tree):
        return lm_params_from_numpy(cfg, tree, dev, torch.float32)

    def scalar(x):
        return torch.from_numpy(np.array(x, np.int32)).to(dev)

    params = lm_params_from_numpy(cfg, state_np.params, dev)
    params.requires_grad_(True)
    o = state_np.opt
    return train_step.TrainState(
        params=params,
        opt=optimizer.OptState(master=f32_tree(o.master), m=f32_tree(o.m),
                               v=f32_tree(o.v), count=scalar(o.count)),
        step=scalar(state_np.step),
        ef=None if state_np.ef is None else f32_tree(state_np.ef))
