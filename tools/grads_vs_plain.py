"""One LM train step's parameter gradients at full width on the card, with
the RWKV6 scan's backward kernel against its plain version in the kernel's
place, for one checkout of the port.

    python3 tools/grads_vs_plain.py <checkout> <label> <file>

Builds rwkv6-3b (bf16, random weights from seed 0) from the checkout at
``checkout``, takes one batch of 8 × 2048 tokens of the synthetic stream,
and computes the gradient of ``launch.specs.weighted_loss_fn`` with the
kernel. Where ``file`` does not exist yet it then computes the same
gradient with ``rwkv6_scan_bwd_plain`` (f32) in the backward kernel's
place and saves it there, so a second checkout is held against the same
plain gradient. Prints the loss, each gradient's global norm, the
kernel's global L2 distance from the plain gradient and the leaves
farthest from it (relative L2). The card's name and power limit first.
Needs one card and about 40 GB of it.
"""
import importlib
import os
import subprocess
import sys
import time


def main(checkout: str, label: str, plain_file: str) -> None:
    root = os.path.abspath(checkout)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch import configs
    from repro_torch import device as device_mod
    from repro_torch.data import lm as lm_data
    from repro_torch.launch import specs
    from repro_torch.models import transformer

    rw = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    if not rw.__file__.startswith(root):
        raise SystemExit(f"imported another checkout than {root}")
    print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip(), flush=True)
    device_mod.resolve("cuda")
    cfg = configs.get("rwkv6-3b")
    params = transformer.init_params(cfg, device="cuda")
    toks = next(lm_data.lm_batches(99, 1, 8, 2048, cfg.vocab_size))["tokens"]
    batch = {"tokens": torch.from_numpy(toks).cuda(), "client_weight": torch.ones(8).cuda()}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}/{k}")
        else:
            yield prefix, tree
    names, leaves = zip(*walk(params))

    def grads():
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = specs.weighted_loss_fn(params, batch, cfg)
        g = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x.float()) for x in g])))
        return float(loss.detach()), norm, g

    t0 = time.perf_counter()
    loss, norm, g_kernel = grads()
    print(f"{label} kernel: loss {loss:.6f}, gradient norm {norm:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not os.path.exists(plain_file):
        def plain_backward(r, k, v, logw, u, s_out, scratch, do, ds_final, chunk):
            return rw.rwkv6_scan_bwd_plain(r, k, v, logw, u, do, chunk=chunk, ds_final=ds_final)
        rw._backward = plain_backward      # the train path starts every scan from state 0
        loss, norm, g_plain = grads()
        print(f"plain backward: loss {loss:.6f}, gradient norm {norm:.6f}", flush=True)
        torch.save([x.cpu() for x in g_plain], plain_file)
    else:
        g_plain = [x.cuda() for x in torch.load(plain_file)]
    rows, total = [], 0.0
    for name, a, b in zip(names, g_kernel, g_plain):
        diff = float(torch.linalg.vector_norm(a.float() - b.float()))
        ref = float(torch.linalg.vector_norm(b.float()))
        total += diff * diff
        rows.append((diff / max(ref, 1e-30), name, ref))
    rows.sort(reverse=True)
    print(f"{label}: kernel against plain, global L2 distance {total ** 0.5:.6e}; median "
          f"leaf relative L2 {sorted(r for r, _, _ in rows)[len(rows) // 2]:.3e}")
    for rel, name, ref in rows[:8]:
        print(f"  {label} {name}: relative L2 {rel:.3e} (plain norm {ref:.4e})")


if __name__ == "__main__":
    main(*sys.argv[1:4])
