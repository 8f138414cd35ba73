"""Warm LM train steps of one checkout of the port, for comparing two
checkouts on one card in turns.

    git archive <commit> | tar -x -C build/parent     # build/ is gitignored
    for r in "build/parent parent" ". change" ". change" "build/parent parent"; do
        python3 tools/ab_train_steps.py $r [runs]
    done

Runs ``launch.train.run`` from the checkout at ``root`` (its ``src/`` and
its ``chip_smoke.py``, whose TRAIN settings it uses: batch 8 × 2048, lr
3e-4), random weights from seed 0, for these runs:

- ``qwen2-0.5b`` and ``qwen2-0.5b-micro2``: qwen2-0.5b at ``--micro`` 1
  and 2, 5 steps, adamw (``launch.train.run``'s default);
- ``olmo-1b``: 4 steps, adamw;
- ``rwkv6-3b``: full width and depth, 4 steps, sgdm (chip_smoke's phase 13
  setting: AdamW's two moment trees would not fit beside the weights);
- ``recurrentgemma-9b``: full width, depth cut to 5 layers as chip_smoke's
  phase 13 cuts it (one (rglru, rglru, attn) unit and the (rglru, rglru)
  tail), 4 steps, sgdm.

``runs`` is a comma-separated list of those names (all of them if
omitted). Per run it prints one ``RESULT`` line (the median of the warm
steps' ``dt``, tokens/s, every step) and a torch.profiler breakdown of one
more warm step (device ms by kernel, busy share). The card's name and
power limit come first. Needs one card.
"""
import dataclasses
import os
import statistics
import subprocess
import sys


# name: (config, its depth cut, micro-batches, steps, optimizer)
RUNS = {"qwen2-0.5b": ("qwen2-0.5b", {}, 1, 5, "adamw"),
        "qwen2-0.5b-micro2": ("qwen2-0.5b", {}, 2, 5, "adamw"),
        "olmo-1b": ("olmo-1b", {}, 1, 4, "adamw"),
        "rwkv6-3b": ("rwkv6-3b", {}, 1, 4, "sgdm"),
        "recurrentgemma-9b": ("recurrentgemma-9b", {"n_layers": 5}, 1, 4, "sgdm")}


def main(root: str, label: str, runs: str = ",".join(RUNS)) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch import device as device_mod
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import build
    from repro_torch.launch import train

    if not (cs.__file__.startswith(root) and build.__file__.startswith(root)):
        raise SystemExit(f"imported another checkout than {root}")
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip(), flush=True)
    device_mod.resolve("cuda")
    build.build_all()
    batch_size, seq = cs.TRAIN["batch"], cs.TRAIN["seq"]
    for name in runs.split(","):
        arch, cut, micro, steps, opt = RUNS[name]
        torch.cuda.empty_cache()
        model = arch if not cut else dataclasses.replace(configs.get(arch), **cut)
        res = train.run(model, smoke=False, steps=steps, micro=micro, seed=0, log_every=steps,
                        ckpt="", ckpt_every=2, device="cuda", opt=opt, **cs.TRAIN)
        dts = [r["dt"] for r in res["history"]]
        warm = statistics.median(dts[1:])
        print(f"RESULT {label} {name} ({arch}{' ' + str(cut) if cut else ''}, {opt}, micro "
              f"{micro}): warm {warm:.4f} s ({batch_size * seq / warm:.0f} tokens/s); steps "
              f"{[round(d, 4) for d in dts]}", flush=True)
        backend, cfg = res["backend"], res["cfg"]
        toks = next(lm_data.lm_batches(99, 1, batch_size, seq, cfg.vocab_size))["tokens"]
        batch = {"tokens": torch.from_numpy(toks).cuda(),
                 "client_weight": torch.ones(batch_size).cuda()}

        def step():
            backend.params, backend.opt_state, _ = backend.train_step(
                backend.params, backend.opt_state, batch)
        try:
            cs._device_profile(f"{label} {name} warm step", step, cs._lm_kernels(), top=20)
        except SystemExit as e:   # a profiler session that missed launches: say so, go on
            print(f"profile {label} {name}: {e}", flush=True)
        del res, backend


if __name__ == "__main__":
    main(*sys.argv[1:4])
