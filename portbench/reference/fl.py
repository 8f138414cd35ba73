"""The federated round in plain PyTorch: the LEAF FEMNIST CNN, each
involved client's H local SGD steps, the two-step (SFL) or k-step (θ/Φ/Ψ,
int8 at every tier) aggregation and FedAvg's server step, replayed round
by round from the run's seed.

The CNN (Caldas et al., LEAF, arXiv:1812.01097): two SAME 5×5 convolutions
with ReLU and 2×2 max pooling, a dense layer with ReLU and a 62-way
classifier, on NHWC images; the convolutions are written as products over
unfolded patches, every client's weights batched along a leading axis.
f32 throughout with TF32 off. The control (``set_tf32(True)``) computes
every product in TF32 instead: both operands and the gradient arriving at
the product rounded to TF32's 10-bit mantissa, the sums in f32, as the
card's tensor cores do; it is emulated, so it reads the same on any
device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.inputs import noise as noise_mod
from portbench.reference import pon

Tree = Dict[str, torch.Tensor]
CHUNK = 64          # clients trained at once (bounds the reference's memory)


_TF32 = {"on": False}


def set_tf32(on: bool) -> None:
    _TF32["on"] = on


def _to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32 value (13 low mantissa bits dropped)."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _TF32["on"]:
        return torch.einsum(eq, a, b)
    a = a + (_to_tf32(a) - a.detach())
    b = b + (_to_tf32(b) - b.detach())
    z = torch.einsum(eq, a, b)
    if z.requires_grad:
        z.register_hook(_to_tf32)
    return z


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, C: int) -> torch.Tensor:
    """x (C·B, cin, h, w), per-client w (C, O, cin, k, k), b (C, O)."""
    n, cin, h, wd = x.shape
    k = w.shape[-1]
    cols = F.unfold(x, k, padding=k // 2).reshape(C, n // C, cin * k * k, h * wd)
    y = _mm("cok,cbkp->cbop", w.reshape(C, w.shape[1], -1), cols)
    y = (y + b[:, None, :, None]).reshape(n, w.shape[1], h, wd)
    return F.max_pool2d(F.relu(y), 2)


def cnn_nll(P: Tree, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-client mean cross entropy: P's leaves carry a client axis C,
    images (C, B, 28, 28, 1), labels (C, B) -> (C,)."""
    C, B = labels.shape
    x = images.reshape((C * B,) + tuple(images.shape[2:])).permute(0, 3, 1, 2)
    x = _conv_relu_pool(x, P["conv1_w"], P["conv1_b"], C)
    x = _conv_relu_pool(x, P["conv2_w"], P["conv2_b"], C)
    x = x.permute(0, 2, 3, 1).reshape(C, B, -1)
    x = F.relu(_mm("cbf,cfo->cbo", x, P["fc1_w"]) + P["fc1_b"][:, None])
    logits = _mm("cbf,cfo->cbo", x, P["fc2_w"]) + P["fc2_b"][:, None]
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean(-1)


def local_deltas(p0: Tree, images: torch.Tensor, labels: torch.Tensor, lr: float,
                 steps: int) -> Tree:
    """C clients' H SGD steps from the global model: images (C, H, B, ...),
    labels (C, H, B) -> each client's weight delta (C, ...)."""
    C = labels.shape[0]
    P = {k: v.expand((C,) + tuple(v.shape)).clone() for k, v in p0.items()}
    for t in range(steps):
        for v in P.values():
            v.requires_grad_(True)
        loss = cnn_nll(P, images[:, t], labels[:, t]).sum()
        grads = torch.autograd.grad(loss, list(P.values()))
        P = {k: (v - lr * g).detach() for (k, v), g in zip(P.items(), grads)}
    return {k: P[k] - p0[k] for k in p0}


def int8_roundtrip(rows: Tree, noise: List[torch.Tensor], row_mask: Optional[torch.Tensor]
                   ) -> Tree:
    """Each row of each leaf (names sorted) at its own scale max|x|/127,
    stochastically rounded with the noise u: round(x/s + u − ½) clipped to
    ±127, then back to f32 and times the row mask."""
    out = {}
    for name, u in zip(sorted(rows), noise):
        x = rows[name]
        flat = x.reshape(x.shape[0], -1)
        s = flat.abs().amax(1).clamp_min(1e-12) / 127.0
        q = torch.clamp(torch.round(flat / s[:, None] + (u.reshape(flat.shape) - 0.5)),
                        -127.0, 127.0)
        y = q * s[:, None]
        if row_mask is not None:
            y = y * row_mask[:, None]
        out[name] = y.reshape(x.shape)
    return out


def theta_add(theta: Tree, d: Tree, w: torch.Tensor, seg: torch.Tensor,
              exact: bool = False) -> None:
    """θ_o += Σ_{c ∈ o} w_c δ_c for a chunk of client rows, as one product
    with the clients' ONU one-hot (deterministic, unlike an atomic
    scatter-add); ``exact`` keeps it in f32 whatever :func:`set_tf32` says."""
    n_tot = next(iter(theta.values())).shape[0]
    onehot = F.one_hot(seg, n_tot).to(torch.float32) * w[:, None]
    for k, v in d.items():
        rows = v.reshape(len(w), -1)
        z = (torch.einsum("co,cn->on", onehot, rows) if exact
             else _mm("co,cn->on", onehot, rows))
        theta[k] += z.reshape(theta[k].shape)


def tiers(theta: Tree, onu_act: torch.Tensor, K: torch.Tensor, n_pons: int, int8: bool,
          noise_seed: int, call: int):
    """θ (n_pons·n_onus, ...) to the server's mean update: uncompressed,
    Σ_o θ_o / K; with int8, θ, Φ = Σ_{o ∈ p} θ̂_o and Ψ = Σ_p Φ̂_p each
    rounded at its tier with noise calls ``call`` + 1, + 2, + 3, then Ψ̂ / K.
    Returns (the update, the last tier's step s_Ψ / K a leaf or None, the
    last noise call used)."""
    K = K.clamp_min(1e-9)
    if not int8:
        return {k: v.sum(0) / K for k, v in theta.items()}, None, call
    dev = onu_act.device
    n_onus = len(onu_act) // n_pons

    def shapes(n):
        return [(n,) + tuple(theta[k].shape[1:]) for k in sorted(theta)]

    theta = int8_roundtrip(theta, noise_mod.uniform(noise_seed, call + 1, shapes(len(onu_act)),
                                                    dev), onu_act)
    phi = {k: v.reshape((n_pons, n_onus) + tuple(v.shape[1:])).sum(1) for k, v in theta.items()}
    pon_act = (onu_act.reshape(n_pons, n_onus).sum(1) > 0).float()
    phi = int8_roundtrip(phi, noise_mod.uniform(noise_seed, call + 2, shapes(n_pons), dev),
                         pon_act)
    psi = {k: v.sum(0, keepdim=True) for k, v in phi.items()}
    steps = {k: float(v.abs().amax().clamp_min(1e-12) / 127.0 / K) for k, v in psi.items()}
    psi = int8_roundtrip(psi, noise_mod.uniform(noise_seed, call + 3, shapes(1), dev), None)
    return {k: v[0] / K for k, v in psi.items()}, steps, call + 3


def judge(rows, traffic: Dict, noise_seed: int, call: int, dev) -> Dict:
    """The reference's aggregation of client rows it did not make (the
    program's, or a variant's in the control): ``rows`` yields chunks of
    (δ rows a leaf, weights w, global ONU ids), the involved clients'. Gives
    their weighted mean Σ w δ / Σ w (what local training handed over), the
    server's update from them through the traffic's tiers with the noise
    calls after ``call``, and the last tier's step a leaf."""
    fl = traffic["fl"]
    n_tot = fl["n_pons"] * fl["n_onus"]
    theta, K = None, torch.zeros((), device=dev)
    onu_act = torch.zeros(n_tot, device=dev)
    for d, w, seg in rows:
        d = {k: v.to(dev) for k, v in d.items()}
        w, seg = w.to(dev), torch.as_tensor(seg, device=dev)
        if theta is None:
            theta = {k: torch.zeros((n_tot,) + tuple(v.shape[1:]), device=dev)
                     for k, v in d.items()}
        theta_add(theta, d, w, seg, exact=True)
        K = K + w.sum()
        onu_act[seg] = 1.0
    mean = {k: v.sum(0) / K.clamp_min(1e-9) for k, v in theta.items()}
    agg, steps, _ = tiers(theta, onu_act, K, fl["n_pons"], fl["compress"] == "int8",
                          noise_seed, call)
    return {"mean": mean, "agg": agg, "steps": steps}


def eval_loss(p: Tree, eval_set: Dict[str, torch.Tensor]) -> float:
    with torch.no_grad():
        P = {k: v[None] for k, v in p.items()}
        return float(cnn_nll(P, eval_set["images"][None], eval_set["labels"][None])[0])


def replay(p0: Tree, clients: List[Dict[str, np.ndarray]], eval_set: Dict[str, np.ndarray],
           traffic: Dict, loop_seed: int, noise_seed: int, rounds: int,
           fault: Optional[str] = None) -> Dict:
    """The first ``rounds`` rounds from ``p0``: per round the selection,
    the involvement mask and upstream Mbits, the eval loss after the
    server step; the parameters after each round; and of the first round
    what :func:`judge` makes of the rows this replay trained (``first``)
    and the update it applied itself (``first_agg``).

    ``fault`` plants a fault in the reference put in the program's place:
    ``"half_batch"`` trains every involved client and aggregates the first
    half of them alone (their mean), ``"alter_answer"`` negates one
    client's update where it is made.
    """
    fl, pcfg = traffic["fl"], traffic["pon"]
    dev = next(iter(p0.values())).device
    counts = np.array([len(c["labels"]) for c in clients], np.float32)
    n_pons, n_onus = fl["n_pons"], fl["n_onus"]
    n_clients = n_pons * n_onus * fl["clients_per_onu"]
    n_tot = n_pons * n_onus
    onu_ids = np.arange(n_clients) // fl["clients_per_onu"]
    int8 = fl["compress"] == "int8"
    model_mbits = pon.MODEL_MBITS * (8 / 32 if int8 else 1.0)
    ev = {k: torch.from_numpy(v).to(dev) for k, v in eval_set.items()}
    rng = np.random.default_rng(loop_seed)
    p = {k: v.clone() for k, v in p0.items()}
    out = {"selected": [], "mask": [], "upstream_mbits": [], "eval_loss": [], "params": []}
    call = 0
    for rnd in range(rounds):
        sel = pon.select(rng, n_clients, fl["n_selected"])
        if n_pons == 1:
            mask, up = pon.one_pon_sfl(rng, sel, onu_ids, counts, n_onus,
                                       pcfg["sync_threshold_s"], model_mbits)
        else:
            mask, up = pon.forest_hier(rng, sel, onu_ids, counts, n_pons, n_onus,
                                       pcfg["sync_threshold_s"], model_mbits,
                                       pcfg["metro_rate_mbps"], pcfg["metro_latency_ms"])
        out["selected"].append(sel)
        out["mask"].append(mask)
        out["upstream_mbits"].append(up)
        active = sel[mask > 0]
        if len(active):
            pad = (-len(active)) % fl["client_chunk"]
            padded = np.concatenate([active, np.full(pad, active[0])])
            idx = [rng.integers(0, len(clients[c]["labels"]), size=(fl["local_steps"],
                                                                      fl["local_batch"]))
                   for c in padded]
            kept = len(active) if fault != "half_batch" else max(1, len(active) // 2)
            w = torch.from_numpy(counts[active]).to(dev)
            zeros = lambda: {k: torch.zeros((n_tot,) + tuple(v.shape), device=dev)  # noqa: E731
                             for k, v in p.items()}
            theta = zeros()
            # the judge's θ over every row as trained, where this replay's
            # own differs from it (a variant's first round)
            own_differs = rnd == 0 and (_TF32["on"] or fault == "half_batch")
            theta_j = zeros() if own_differs else theta
            for lo in range(0, len(active), CHUNK):
                part = list(range(lo, min(lo + CHUNK, len(active))))
                imgs = np.stack([clients[active[i]]["images"][idx[i]] for i in part])
                labs = np.stack([clients[active[i]]["labels"][idx[i]] for i in part])
                d = local_deltas(p, torch.from_numpy(imgs).to(dev), torch.from_numpy(labs).to(dev),
                                 fl["local_lr"], fl["local_steps"])
                if fault == "alter_answer" and lo == 0:
                    d = {k: torch.cat([-v[:1], v[1:]]) for k, v in d.items()}
                seg = torch.from_numpy(onu_ids[active[part]]).to(dev)
                wk = w[lo:lo + len(part)] * torch.from_numpy(
                    (np.array(part) < kept).astype(np.float32)).to(dev)
                theta_add(theta, d, wk, seg)
                if own_differs:
                    theta_add(theta_j, d, w[lo:lo + len(part)], seg, exact=True)
            onu_act = torch.zeros(n_tot, device=dev)
            onu_act[torch.from_numpy(onu_ids[active[:kept]]).to(dev)] = 1.0
            if rnd == 0:
                onu_all = torch.zeros(n_tot, device=dev)
                onu_all[torch.from_numpy(onu_ids[active]).to(dev)] = 1.0
                agg_j, steps, _ = tiers(theta_j, onu_all, w.sum(), n_pons, int8, noise_seed, call)
                out["first"] = {"mean": {k: v.sum(0) / w.sum() for k, v in theta_j.items()},
                                "agg": agg_j, "steps": steps}
            if rnd == 0 and not own_differs:
                agg, call = agg_j, call + 3 * int8
            else:
                agg, _, call = tiers(theta, onu_act, w[:kept].sum(), n_pons, int8, noise_seed,
                                     call)
            if rnd == 0:
                out["first_agg"] = agg
            p = {k: p[k] + agg[k] for k in p}
            out["eval_loss"].append(eval_loss(p, ev))
        else:
            out["eval_loss"].append(out["eval_loss"][-1] if out["eval_loss"] else 0.0)
        out["params"].append({k: v.clone() for k, v in p.items()})
    return out
