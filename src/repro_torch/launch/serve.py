"""Batched serving on the port: prefill, then token-by-token decode — the
counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --prompt-len 4096 --gen 32

Without ``--device cpu`` it runs on the card and raises if there is none.
The prompt's attention goes through the flash-attention kernel, the
RG-LRU and RWKV6 recurrences through their scan kernels (prefill and
every decode step). Randomness comes from one seeded ``torch.Generator``
per stream — init, prompt, sampling — spawned from ``--seed``; it does
not repeat JAX's numbers.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import configs, device as device_mod
from repro_torch.models import transformer


def _generators(seed: int, dev: torch.device):
    """Independent (init, prompt, sampling) generators on ``dev``."""
    seeds = np.random.SeedSequence(seed).generate_state(3)
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]


def run(arch: str, *, smoke: bool = False, batch: int = 4, prompt_len: int = 64,
        gen: int = 32, temperature: float = 0.0, seed: int = 0,
        device: str | torch.device = "cuda", params: Optional[Dict[str, Any]] = None,
        prompt: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill a (batch, prompt_len) prompt, then decode ``gen`` tokens.

    Returns {"tokens" (B, gen + 1) — the prefill's token then one per decode
    step, "prompt", "prefill_logits", "logits" (the last step's), "cache",
    "params", "cfg", "prefill_s", "decode_s"}. ``params`` (the port's
    layout, e.g. bridged) replaces the seeded init; ``prompt`` (B, P)
    replaces the seeded prompt. Every time synchronises the card.
    """
    dev = device_mod.resolve(device)
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    g_init, g_prompt, g_sample = _generators(seed, dev)
    if params is None:
        params = transformer.init_params(cfg, g_init, dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g_prompt,
                               device=dev)
    prompt = prompt.to(dev)
    B, P = prompt.shape
    cache_len = P + gen

    (logits, cache), t_prefill = device_mod.timed(
        transformer.prefill, params, {"tokens": prompt}, cfg, cache_len)
    print(f"prefill {B}x{P}: {t_prefill:.2f}s ({B * P / t_prefill:.0f} tok/s)")
    prefill_logits = logits

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=g_sample)
        return logits.argmax(-1, keepdim=True)

    def decode():
        nonlocal logits, cache
        tok = pick(logits)
        out = [tok]
        for i in range(gen):
            step = {"tokens": tok, "pos": torch.full((B, 1), P + i, dtype=torch.int32,
                                                     device=dev)}
            logits, cache = transformer.decode_step(params, step, cache, cfg)
            tok = pick(logits)
            out.append(tok)
        return torch.cat(out, dim=1)

    toks, t_decode = device_mod.timed(decode)
    if gen:
        print(f"decode {gen} steps: {t_decode:.2f}s ({B * gen / t_decode:.1f} tok/s, "
              f"{t_decode / gen * 1e3:.1f} ms/step)")
    print("sample token ids[0]:", toks[0, :16].tolist())
    return {"tokens": toks.cpu(), "prompt": prompt, "prefill_logits": prefill_logits,
            "logits": logits, "cache": cache, "params": params, "cfg": cfg,
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, temperature=args.temperature, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
