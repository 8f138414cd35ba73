#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught to carry on):

1. card    — name and power limit, as nvidia-smi reports them.
2. build   — every CUDA kernel of the port, compiled from ``csrc/`` with
             one nvcc per source, all started together.
3. kernels — each kernel against its plain PyTorch version on the card at
             the shapes the main path gives it; kernel, plain-version and
             library-call times (CUDA events, median of 20 after warm-up)
             beside the bound (bytes moved at 3.35 TB/s, f32 flops at
             67 TFLOP/s; the H100 SXM data-sheet peaks).
   conv    — one vmapped SGD step of 16 full-width clients with the
             port's convolution (unfold + f32 matmul) and with cuDNN's
             ``F.conv2d``: gradient error against float64 on the CPU, times.
4. slice   — the port's main path through its user entry point,
             ``repro_torch.launch.femnist.run``: the paper topology
             (16 ONUs × 20 clients, N = 128, 8 local steps) on the
             full-width FEMNIST CNN, 3 rounds each of sfl_two_step and
             classical. Kernel launch counts are zeroed just before and
             read just after; the upstream accounting is checked.
5. parity  — one round on the card and on the CPU, at reduced width and
             at full width: the same involvement, parameters within
             atol 1e-4 after 1 local step (the gap after 8 is printed).

The last lines are the ``kernels`` JSON object and then
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device-memory rate
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# f32 sums in another order: the error scales with Σ|w·x| of each output,
# not with the (possibly cancelled) sum itself; one dropped or doubled row
# of 128 would be ~1e-2 of it
RTOL_OF_ABS_SUM, ATOL = 1e-4, 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def agg_bound(C: int, N: int, n_seg: int, itemsize: int):
    """Least time for out = per-segment Σ wm·x: read x, wm and the CSR once,
    write θ once; 2·C·N f32 flops."""
    nbytes = C * N * itemsize + n_seg * N * 4 + C * 4 + (C + n_seg + 1) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * C * N / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = out.splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {sorted(build.SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"(into {build.BUILD_DIR.relative_to(ROOT)})")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_kernels():
    """agg_reduce against its plain version; returns the main case's row."""
    from repro_torch.kernels.agg_reduce import (segment_agg_reduce,
                                                segment_agg_reduce_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_fc1 = 3136 * 2048                      # fc1_w of the full-width CNN
    # On the main path SFL aggregates ~126 involved clients padded to 128
    # rows (client_chunk = 16) over 16 ONUs; classical ~8 involved clients
    # padded to 16 rows, one segment. The last three cases are off the path.
    cases = [  # (what, C, N, n_seg, dtype)
        ("fc1_w, SFL step 1 (16 ONUs)", 128, n_fc1, 16, torch.float32),
        ("fc2_b, SFL step 1, scalar path", 128, 62, 16, torch.float32),
        ("fc1_w, classical (16 rows, 1 segment)", 16, n_fc1, 1, torch.float32),
        ("fc2_b, classical, scalar path", 16, 62, 1, torch.float32),
        ("off path: fc1_w, 128 rows, 1 segment", 128, n_fc1, 1, torch.float32),
        ("off path: fc1_w, bf16 input", 128, n_fc1, 16, torch.bfloat16),
        ("off path: odd N, scalar path", 128, 100_003, 16, torch.float32),
    ]
    main = None
    for what, C, N, n_seg, dtype in cases:
        x = torch.randn((C, N), generator=gen, device="cuda", dtype=dtype)
        keep = (torch.rand(C, generator=gen, device="cuda") > 0.2).float()
        wm = (torch.rand(C, generator=gen, device="cuda") * 400 * keep).contiguous()
        seg = np.random.default_rng(C + N).integers(0, n_seg, C)   # unsorted
        got = segment_agg_reduce(x, wm, seg, n_seg)
        want = segment_agg_reduce_plain(x, wm, seg, n_seg)
        abs_sum = segment_agg_reduce_plain(x.abs(), wm.abs(), seg, n_seg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL_OF_ABS_SUM * abs_sum).all())
        del abs_sum
        ms = time_ms(lambda: segment_agg_reduce(x, wm, seg, n_seg))
        plain_ms = time_ms(lambda: segment_agg_reduce_plain(x, wm, seg, n_seg))
        library_ms = None
        if dtype == torch.float32:
            if n_seg == 1:
                library_ms = time_ms(lambda: torch.mv(x.t(), wm))
            else:
                S = torch.zeros((n_seg, C), device="cuda")
                S[torch.as_tensor(seg, device="cuda"), torch.arange(C, device="cuda")] = wm
                library_ms = time_ms(lambda: torch.mm(S, x))
        bound_ms, bound_by = agg_bound(C, N, n_seg, x.element_size())
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel agg_reduce [{what}] C={C} N={N} n_seg={n_seg} "
              f"{str(dtype).split('.')[-1]}: max_abs_err {err:.3e} "
              f"(<= {ATOL} + {RTOL_OF_ABS_SUM}·Σ|w·x|) {'ok' if ok else 'FAIL'}; "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib} "
              f"bound_ms {bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
        check(ok, f"agg_reduce disagrees with its plain version [{what}]: {err}")
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=library_ms)
        del x, got, want
        torch.cuda.empty_cache()
    for C, N in ((0, 1000), (128, 0)):        # the zero-length guards
        before = segment_agg_reduce.launches
        z = segment_agg_reduce(torch.zeros((C, N), device="cuda"),
                               torch.ones(C, device="cuda"), np.zeros(C, np.int64), 16)
        check(z.shape == (16, N) and not z.any()
              and segment_agg_reduce.launches == before,
              f"zero-length guard C={C} N={N}")
        print(f"kernel agg_reduce [guard] C={C} N={N}: zeros, no launch ok")
    return main


def phase_conv() -> None:
    """The CNN's convolutions as the path runs them, 16 clients under
    ``vmap``: the port's unfold + matmul form against cuDNN's ``F.conv2d``.
    Each layer alone on random inputs (no pooling, whose ties would route
    a gradient differently in f32 and f64): input and weight gradients
    against float64 on the CPU. Then one SGD step of the full-width CNN
    with each form, timed."""
    import torch.nn.functional as F
    from torch.func import grad, vmap

    from repro_torch import configs
    from repro_torch.data import femnist
    from repro_torch.models import femnist_cnn

    def cudnn_conv(x, w, b):
        return F.conv2d(x, w, b, padding=2)

    def conv_grads(conv, x, w, b, gy):
        return vmap(grad(lambda xi, wi, bi, gi: (conv(xi, wi, bi) * gi).sum(),
                         argnums=(0, 1)))(x, w, b, gy)

    def rel(a, ref):
        return float((a.double().cpu() - ref).abs().max()) / float(ref.abs().max())

    port_conv = femnist_cnn.conv5_same
    forms = (("unfold + matmul (the port)", port_conv), ("cuDNN F.conv2d", cudnn_conv))
    gen = torch.Generator().manual_seed(1)
    for layer, c_in, hw, c_out in (("conv1", 1, 28, 32), ("conv2", 32, 14, 64)):
        ts = (torch.randn((16, 10, c_in, hw, hw), generator=gen),
              0.4 * torch.randn((16, c_out, c_in, 5, 5), generator=gen),
              torch.zeros((16, c_out)),
              torch.randn((16, 10, c_out, hw, hw), generator=gen))
        ref_x, ref_w = conv_grads(cudnn_conv, *(t.double() for t in ts))
        for name, conv in forms:
            gx, gw = conv_grads(conv, *(t.cuda() for t in ts))
            ex, ew = rel(gx, ref_x), rel(gw, ref_w)
            print(f"conv [{name}] {layer} x16 clients: max error of the input "
                  f"gradient {ex:.3e}, of the weight gradient {ew:.3e} "
                  f"(of the largest entry; f64 reference)")
            if conv is port_conv:
                check(max(ex, ew) <= 1e-5,
                      f"the port's {layer} gradient errs by {max(ex, ew)}")

    cfg = configs.get("femnist_cnn")
    pc = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    clients, _ = femnist.generate(femnist.FemnistConfig(n_clients=16, seed=7))
    rng = np.random.default_rng(0)
    mbs = [femnist.client_minibatches(rng, c, 1, 10) for c in clients]
    bc = {k: torch.from_numpy(np.stack([b[k][0] for b in mbs])).cuda() for k in mbs[0]}

    def step():
        return vmap(lambda bi: grad(lambda q: femnist_cnn.loss_fn(q, bi)[0])(pc))(bc)

    for name, conv in forms:
        femnist_cnn.conv5_same = conv
        try:
            ms = time_ms(step)
        finally:
            femnist_cnn.conv5_same = port_conv
        print(f"conv [{name}]: one SGD step of 16 full-width clients, ms {ms:.4f}")


def phase_slice():
    from repro_torch.kernels.agg_reduce import segment_agg_reduce
    from repro_torch.launch import femnist as launch
    from repro_torch.pon import MODEL_UPDATE_MBITS, PonConfig

    modes = ("sfl_two_step", "classical")
    n_sel, n_onus = 128, 16
    torch.cuda.reset_peak_memory_stats()
    segment_agg_reduce.launches = 0
    t0 = time.perf_counter()
    res = launch.run(n_rounds=3, n_selected=n_sel, full=True, seed=0, modes=modes,
                     pon=PonConfig(n_onus=n_onus, clients_per_onu=20),
                     device="cuda")
    wall = time.perf_counter() - t0
    launches = segment_agg_reduce.launches
    trained = 0
    for mode in modes:
        loop = res[mode]["loop"]
        for r in loop.history:
            print(f"slice {mode} round {r['round']}: involved {r['involved']:.0f}/"
                  f"{r['n_selected']} upstream_mbits {r['upstream_mbits']:.3f} "
                  f"uplink_models {r.get('uplink_models', 0):.0f} "
                  f"acc {r['acc']:.4f} eval_loss {r.get('eval_loss', float('nan')):.4f} "
                  f"wall_s {r['wall_s']:.3f} train_s {r.get('train_s', 0):.3f} "
                  f"aggregate_s {r.get('aggregate_s', 0):.4f}")
            check(0.0 <= r["acc"] <= 1.0, f"{mode} acc {r['acc']}")
            if r["involved"] == 0:
                continue
            trained += 1
            check(math.isfinite(r["eval_loss"]), f"{mode} eval_loss {r['eval_loss']}")
            if mode == "sfl_two_step":
                # one θ per active ONU crosses the PON, whatever N is
                check(r["upstream_mbits"] == r["uplink_models"] * MODEL_UPDATE_MBITS
                      and r["uplink_models"] <= n_onus,
                      f"SFL upstream {r['upstream_mbits']} vs "
                      f"{r['uplink_models']} active ONUs")
            else:
                # every selected client's model rides the slice
                check(r["upstream_mbits"] == n_sel * MODEL_UPDATE_MBITS
                      and r["uplink_models"] == r["involved"],
                      f"classical upstream {r['upstream_mbits']}")
        params = loop.backend.params
        check(all(bool(torch.isfinite(v).all()) for v in params.values()),
              f"{mode} params not finite")
        check(tuple(params["fc1_w"].shape) == (3136, 2048), "not the full-width CNN")
    print(f"slice: {trained} trained rounds, {launches} agg_reduce launches "
          f"(8 leaves per trained round), wall {wall:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches > 0 and launches == 8 * trained,
          f"agg_reduce launched {launches} times for {trained} trained rounds")
    return launches


def phase_parity() -> None:
    """One round on the card and on the CPU from the same initial
    parameters: at reduced width with N = 10, and at full width with N = 4
    (padded to 16 rows), where the CPU side stays a few seconds long.

    Held to atol 1e-4 after H = 1 local step. With the paper's H = 8 the
    gap is printed and not held: from this init the first step overshoots
    (loss ~80), and from the second step on some clients' trajectories
    amplify f32 rounding, up to past 1e-3 on any device, the CPU against
    float64 included."""
    from repro_torch import configs
    from repro_torch.bridge import params_to_jax
    from repro_torch.launch import femnist as launch
    from repro_torch.models import femnist_cnn
    from repro_torch.pon import PonConfig

    for width, full, n_sel in (("reduced", False, 10), ("full-width", True, 4)):
        cfg = configs.get("femnist_cnn")
        cfg = cfg if full else cfg.reduced()
        p0 = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        for steps in (1, 8):
            kw = dict(n_rounds=1, n_selected=n_sel, full=full, seed=0,
                      modes=("sfl_two_step",), local_steps=steps,
                      pon=PonConfig(n_onus=4, clients_per_onu=5), params=p0)
            card = launch.run(**kw, device="cuda")["sfl_two_step"]["loop"]
            cpu = launch.run(**kw, device="cpu")["sfl_two_step"]["loop"]
            check(card.history.column("involved") == cpu.history.column("involved"),
                  f"{width}: involvement differs between card and CPU")
            a = params_to_jax(card.backend.params)
            b = params_to_jax(cpu.backend.params)
            check(a["fc1_w"].shape == p0["fc1_w"].shape, f"{width}: fc1_w shape")
            diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
            held = steps == 1
            print(f"parity: {width} round, H={steps}, card vs CPU: involved "
                  f"{card.history.column('involved')} equal, params max |diff| "
                  f"{diff:.3e} ({'atol 1e-4' if held else 'not held'}), eval_loss "
                  f"{card.history.last()['eval_loss']:.6f} vs "
                  f"{cpu.history.last()['eval_loss']:.6f}")
            if held:
                check(diff <= 1e-4, f"{width}: card and CPU params differ by {diff}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    from repro_torch import device as device_mod
    device_mod.resolve("cuda")                 # f32 numerics, as the port runs
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    main_case = phase_kernels()
    phase_conv()
    launches = phase_slice()
    phase_parity()
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "agg_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/agg_reduce.cu",
        "replaces": "src/repro/kernels/agg_reduce.py:60",
        "launches": launches, **main_case}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
