"""Batched serving on the port: prefill, then token-by-token decode — the
counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --prompt-len 4096 --gen 32

Without ``--device cpu`` it runs on the card and raises if there is none.
The prompt's attention goes through the flash-attention kernel, the
RG-LRU and RWKV6 recurrences through their scan kernels (prefill and
every decode step). A frame-frontend model (musicgen-large) takes random
frame embeddings as its prompt and a fresh frame at every decode step
(``decode_frames``); a patch-frontend model (llama-3.2-vision-90b) takes
random patch embeddings beside its token prompt, and every decode step
attends to them again. Randomness comes from one seeded
``torch.Generator`` per stream — init, prompt (and media), decode
frames, sampling — spawned from ``--seed``; it does not repeat JAX's
numbers.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import configs, device as device_mod
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _streams(seed: int):
    """Independent seeds of the (init, prompt, sampling, decode frames)
    streams."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(4)]


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def decode_frames(seed: int, step: int, batch: int, d_model: int,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """The frame embeddings fed at decode step ``step``, (batch, 1, d_model)
    bf16: a generator seeded from (seed, step), so every step sees frames
    of its own and the same step the same frames again."""
    dev = torch.device(device)
    g = _generator(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]), dev)
    return torch.randn((batch, 1, d_model), generator=g, device=dev).to(torch.bfloat16)


def run(arch: Union[str, ModelConfig], *, smoke: bool = False, batch: int = 4,
        prompt_len: int = 64, gen: int = 32, temperature: float = 0.0, seed: int = 0,
        device: str | torch.device = "cuda", params: Optional[Dict[str, Any]] = None,
        prompt: Optional[torch.Tensor] = None, frames: Optional[torch.Tensor] = None,
        media: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill a (batch, prompt_len) prompt, then decode ``gen`` positions.

    ``arch`` is a config name or a ``ModelConfig`` (a named config cut to
    size, taken as it is: ``smoke`` does not apply). Returns {"tokens" (B,
    gen + 1) — the prefill's token then one per decode step, "prompt" (the
    token prompt; None for frames), "frames" (the frame prompt, or None),
    "media" (the patch embeddings, or None), "prefill_logits", "logits"
    (the last step's), "cache", "params", "cfg", "prefill_s", "decode_s"}.
    ``params`` (the port's layout, e.g. bridged) replaces the seeded init;
    ``prompt`` (B, P) tokens, ``frames`` (B, P, d) and ``media`` (B, T, d)
    replace the seeded inputs. Every time synchronises the card.
    """
    dev = device_mod.resolve(device)
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    s_init, s_prompt, s_sample, s_decode = _streams(seed)
    g_prompt, g_sample = _generator(s_prompt, dev), _generator(s_sample, dev)
    if params is None:
        params = transformer.init_params(cfg, _generator(s_init, dev), dev)
    d = cfg.d_model
    if cfg.frontend == "frames":
        if frames is None:
            frames = torch.randn((batch, prompt_len, d), generator=g_prompt,
                                 device=dev).to(torch.bfloat16)
        frames = frames.to(dev)
        B, P = frames.shape[:2]
        inputs = {"frames": frames, "labels": torch.zeros((B, P), dtype=torch.int32,
                                                          device=dev)}
        prompt = None
    else:
        if prompt is None:
            prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=g_prompt, device=dev)
        prompt = prompt.to(dev)
        B, P = prompt.shape
        inputs = {"tokens": prompt}
    if cfg.frontend == "patches":
        if media is None:
            media = torch.randn((B, cfg.n_frontend_tokens, d), generator=g_prompt,
                                device=dev).to(torch.bfloat16)
        media = media.to(dev)
        inputs["patches"] = media
    cache_len = P + gen

    (logits, cache), t_prefill = device_mod.timed(
        transformer.prefill, params, inputs, cfg, cache_len)
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
            step = {"pos": torch.full((B, 1), P + i, dtype=torch.int32, device=dev)}
            if cfg.frontend == "frames":
                step["frames"] = decode_frames(s_decode, i, B, d, dev)
            else:
                step["tokens"] = tok
            if media is not None:
                step["media"] = media
            logits, cache = transformer.decode_step(params, step, cache, cfg)
            tok = pick(logits)
            out.append(tok)
        return torch.cat(out, dim=1)

    toks, t_decode = device_mod.timed(decode)
    if gen:
        print(f"decode {gen} steps: {t_decode:.2f}s ({B * gen / t_decode:.1f} tok/s, "
              f"{t_decode / gen * 1e3:.1f} ms/step)")
    print("sample token ids[0]:", toks[0, :16].tolist())
    return {"tokens": toks.cpu(), "prompt": prompt, "frames": frames, "media": media,
            "prefill_logits": prefill_logits, "logits": logits, "cache": cache,
            "params": params, "cfg": cfg, "prefill_s": t_prefill, "decode_s": t_decode}


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
