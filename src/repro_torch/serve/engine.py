"""Batched serving engine: one decode step, per-slot positions.

Port of :mod:`repro.serve.engine` on one device.  Each slot carries its own
position and an active flag, so the :class:`ContinuousBatcher`
(serve/scheduler.py) can admit/retire requests mid-flight — inactive slots
neither write KV nor advance.  Positions live on the host, as in the
reference; logits come back to the host as float32, sliced to the vocab.

The paper's CAM fronts this engine as a serving-side exact-match response
cache through :class:`repro_torch.serve.am_service.AMService` — see the
``--am-cache`` path in :mod:`repro_torch.launch.serve`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass
class Engine:
    cfg: ModelCfg
    params: transformer.LM
    device: torch.device
    max_len: int
    batch: int
    cache: Any = None                 # either structure of init_cache
    pos: np.ndarray = None            # (B,) per-slot positions (host-side)
    mesh: Any = None

    @classmethod
    def create(cls, cfg: ModelCfg, params: transformer.LM, *, batch: int = 4,
               max_len: int = 256, device=None, mesh=None) -> "Engine":
        """An engine of ``batch`` slots over ``params`` on ``device``
        (default the GPU), where the parameters must already live.
        ``mesh`` is passed to every decode step: an ``ep`` config's MoE
        layers decode expert-parallel over its ``model`` axis, as the
        reference's engine decodes on its mesh."""
        dev = resolve_device(device)
        if params.device.type != dev.type or (
                dev.index is not None and params.device != dev):
            raise ValueError(f"params are on {params.device}, engine on {dev}")
        cache = transformer.init_cache(cfg, batch, max_len,
                                       device=params.device)
        return cls(cfg=cfg, params=params, device=params.device,
                   max_len=max_len, batch=batch, cache=cache,
                   pos=np.zeros((batch,), np.int32), mesh=mesh)

    # -- core step -------------------------------------------------------------

    def step_logits(self, tokens: np.ndarray,
                    active: np.ndarray | None = None) -> np.ndarray:
        """Feed one token per slot -> (B, vocab) next-token logits.

        Inactive slots don't write cache and don't advance their position.
        """
        if active is None:
            active = np.ones((self.batch,), bool)
        tok = torch.as_tensor(np.asarray(tokens), device=self.device)[:, None]
        logits, self.cache = transformer.decode_step(
            self.params, self.cfg, self.cache, tok,
            torch.as_tensor(self.pos, device=self.device),
            torch.as_tensor(np.asarray(active), device=self.device),
            self.mesh)
        self.pos = self.pos + np.asarray(active).astype(np.int32)
        return logits[:, 0, :self.cfg.vocab_size].float().cpu().numpy()

    # -- convenience (uniform batch) --------------------------------------------

    def prefill(self, prompts) -> torch.Tensor:
        """Feed (B, S0) prompts token-by-token; returns last logits (B, V)
        as a float32 CPU tensor."""
        prompts = np.asarray(prompts)
        logits = None
        for i in range(prompts.shape[1]):
            logits = self.step_logits(prompts[:, i])
        return torch.from_numpy(logits)

    def step(self, tokens, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One decode step for (B, 1) tokens -> (B,) int32 next token ids.

        Greedy at ``temperature <= 0``; else sampled from
        softmax(logits / temperature) with ``generator`` (a CPU generator;
        without one, a generator seeded by slot 0's position, as the
        reference keys its draw).
        """
        logits = torch.from_numpy(self.step_logits(np.asarray(tokens)[:, 0]))
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        if generator is None:
            generator = torch.Generator().manual_seed(int(self.pos[0]))
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    def generate(self, prompts, num_tokens: int,
                 temperature: float = 0.0) -> torch.Tensor:
        """Greedy/temperature generation; returns (B, num_tokens) int32."""
        logits = self.prefill(prompts)
        tok = logits.argmax(dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(num_tokens - 1):
            tok = self.step(tok[:, None], temperature)
            out.append(tok)
        return torch.stack(out, dim=1)
