"""Batched serving on the port: prefill a prompt batch, decode with KV
caches / recurrent states (every family, RWKV6 and RecurrentGemma's
ring-buffer local attention included). The counterpart of
``examples/serve_lm.py``: it forwards the same arguments to
``repro_torch.launch.serve`` (a reduced ``--smoke`` config), on the card,
or on the CPU with ``--device cpu``.

    python examples_torch/serve_lm.py --arch recurrentgemma-9b
    python examples_torch/serve_lm.py --arch rwkv6-3b --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def forwarded_argv(argv=None) -> list:
    """The argument list this example hands ``launch.serve.main``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return ["--arch", args.arch, "--smoke",
            "--batch", str(args.batch), "--prompt-len", str(args.prompt_len),
            "--gen", str(args.gen), "--device", args.device]


def main(argv=None) -> dict:
    """Serve; return ``launch.serve.run``'s dict (tokens, logits, times)."""
    from repro_torch.launch import serve
    return serve.main(forwarded_argv(argv))


if __name__ == "__main__":
    main()
