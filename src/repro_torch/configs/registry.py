"""Architecture registry: the 10 assigned archs + the paper's own HDC config.

A copy of :mod:`repro.configs.registry` over the port's own config modules.
Each ``repro_torch/configs/<id>.py`` exports ``CONFIG`` (the exact published
geometry) and ``SMOKE`` (a reduced same-family config for CPU smoke tests).
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "granite_moe_1b_a400m",
    "deepseek_v2_lite_16b",
    "granite_20b",
    "minitron_4b",
    "yi_6b",
    "internlm2_20b",
    "recurrentgemma_2b",
    "musicgen_medium",
    "xlstm_125m",
    "pixtral_12b",
)

#: CLI-friendly aliases (dashes, as in the assignment table)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str, smoke: bool = False):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS}
