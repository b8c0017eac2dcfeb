"""Serving with a SEE-MCAM associative response cache (an AMService client).

Port of ``examples/serve_am_cache.py``.  The paper's CAM is an associative
memory for ML inference; here it fronts an LM serving engine as an
exact-match semantic cache: prompts are HDC-encoded and Z-score-quantized
into 3-bit codes (the paper's quantized-HDC scheme); a CAM exact-match hit
returns the cached generation and skips the model.

The cache itself is a thin client of :class:`repro_torch.serve.AMService`,
which owns table lifecycle, batching, eviction and the single-readback
response path, searched on the CUDA kernels on the card.  Weights are
random, drawn from a seed; prompts come from numpy.

  PYTHONPATH=src python torch_examples/serve_am_cache.py              # GPU
  PYTHONPATH=src python torch_examples/serve_am_cache.py --device cpu
  PYTHONPATH=src python torch_examples/serve_am_cache.py --full       # yi-6b

``--arch`` picks the model (its smoke size unless ``--full``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ALIASES, get_config
from repro_torch.core import hdc
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve import AMService
from repro_torch.serve.engine import Engine

DIM = 256          # hypervector width of the cache key
BITS = 3
CAPACITY = 64      # LRU-bounded: old generations age out under load


class AMCache:
    """Exact-match response cache: a thin client of :class:`AMService`.

    One named LRU table keyed by quantized HDC codes; generations ride along
    as row payloads and come back on exact hits in the service's single
    per-batch readback (no per-query host syncs).
    """

    def __init__(self, vocab: int, device):
        self.proj = hdc.token_key_projection(vocab, DIM, device=device)
        self.svc = AMService(device=device)
        self.svc.create_table("responses", width=DIM, bits=BITS,
                              capacity=CAPACITY, policy="lru",
                              backend="pallas")

    def _encode(self, prompt: np.ndarray) -> np.ndarray:
        # bag-of-tokens HDC encoding of the prompt, Z-score quantized
        return hdc.prompt_key(self.proj, prompt, BITS).cpu().numpy()

    def lookup(self, prompt: np.ndarray):
        resp = self.svc.lookup("responses", self._encode(prompt))
        return resp.value if resp.hit else None

    def insert(self, prompt: np.ndarray, generation: np.ndarray):
        self.svc.append("responses", self._encode(prompt),
                        values=[generation])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--full", action="store_true",
                    help="the model at its published size (default: smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch), smoke=not args.full)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    cache = AMCache(cfg.vocab_size, dev)

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 6))
    workload = [prompts[0], prompts[1], prompts[0], prompts[2], prompts[1],
                prompts[0]]

    hits = 0
    for i, prompt in enumerate(workload):
        t0 = time.time()
        cached = cache.lookup(prompt)
        if cached is not None:
            hits += 1
            print(f"req{i}: CAM HIT  {1e3 * (time.time() - t0):7.1f} ms "
                  f"-> {cached[:8]}")
            continue
        eng = Engine.create(cfg, params, batch=1, max_len=64, device=dev)
        gen = eng.generate(prompt[None].astype(np.int32),
                           num_tokens=8).cpu().numpy()[0]
        cache.insert(prompt, gen)
        print(f"req{i}: MISS     {1e3 * (time.time() - t0):7.1f} ms "
              f"-> {gen[:8]}")

    stats = cache.svc.stats("responses")
    print(f"\n{hits}/{len(workload)} requests served from the SEE-MCAM cache "
          f"({stats['rows']}/{stats['capacity']} rows, "
          f"{stats['evicted']} evicted) on {dev.type}")
    assert hits == 3
    assert stats["hits"] == 3 and stats["lookups"] == len(workload)


if __name__ == "__main__":
    main()
