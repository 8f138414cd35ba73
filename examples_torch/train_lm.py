"""End-to-end LM training on the port: train a ~100M-parameter LM
(olmo-100m) for a few hundred steps with the SFL gradient regime (client
weighting and deadline masks from the PON simulator folded into every
step), checkpointing along the way. The counterpart of
``examples/train_lm.py``: it forwards the same arguments to
``repro_torch.launch.train``, on the card, or on the CPU with
``--device cpu``.

    python examples_torch/train_lm.py --steps 300
    python examples_torch/train_lm.py --steps 3 --batch 2 --seq 32 --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def forwarded_argv(argv=None) -> list:
    """The argument list this example hands ``launch.train.main``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return ["--arch", "olmo-100m", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt", args.ckpt, "--log-every", "10", "--device", args.device]


def main(argv=None) -> dict:
    """Print the model line, then train; return ``launch.train.run``'s dict
    (History, backend, config)."""
    forwarded = forwarded_argv(argv)
    from repro_torch import configs
    cfg = configs.get("olmo-100m")
    print(f"model: {cfg.name}, {cfg.param_count/1e6:.0f}M params")

    from repro_torch.launch import train
    return train.main(forwarded)


if __name__ == "__main__":
    main()
