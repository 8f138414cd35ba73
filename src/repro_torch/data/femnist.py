"""Synthetic FEMNIST-like federated dataset (offline stand-in for LEAF).

The real FEMNIST is not bundled in this environment, so we generate a
class-conditional 28x28 dataset with 62 classes and *per-writer style
shift* — each client (writer) has its own affine style (stroke weight,
translation, elastic tilt) and a non-IID label histogram, which is the
property FedAvg experiments actually exercise. Sample counts per client are
log-normal like LEAF's (tens to hundreds). Accuracy numbers are therefore
relative (documented in DESIGN.md §8): we validate the paper's *claims*
(SFL ≥ classical under the same deadline), not absolute FEMNIST accuracy.

Verbatim copy of ``repro.data.femnist`` (numpy/scipy only): the port draws
the same data from the same seeds, pinned array for array by
``tests/test_torch_transport.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FemnistConfig:
    n_clients: int = 320
    n_classes: int = 62
    img: int = 28
    mean_samples: float = 120.0
    dirichlet_alpha: float = 0.25   # label non-IIDness (lower = harder)
    noise: float = 0.8              # pixel noise (higher = harder)
    proto_rank: int = 16            # classes are mixtures of a small basis
                                    # => confusable, like real handwriting
    eval_per_class: int = 8
    seed: int = 7


def _class_prototypes(rng: np.random.Generator, cfg: FemnistConfig) -> np.ndarray:
    """Class prototypes as sparse mixtures of a low-rank smooth basis —
    classes share strokes (confusable), so accuracy is gated by how much
    data the global model aggregates per round (the paper's mechanism)."""
    basis = rng.normal(0, 1, size=(cfg.proto_rank, cfg.img, cfg.img))
    k = np.outer(np.hanning(7), np.hanning(7))
    k /= k.sum()
    from scipy.signal import convolve2d
    basis = np.stack([convolve2d(b, k, mode="same") for b in basis])
    coef = rng.normal(0, 1, size=(cfg.n_classes, cfg.proto_rank))
    coef *= (rng.random((cfg.n_classes, cfg.proto_rank)) < 0.4)
    protos = np.einsum("cr,rxy->cxy", coef, basis)
    protos /= protos.std(axis=(1, 2), keepdims=True) + 1e-9
    return protos.astype(np.float32)


def _writer_style(rng: np.random.Generator, img: np.ndarray, shift, gain) -> np.ndarray:
    out = np.roll(img, shift=shift, axis=(0, 1)) * gain
    return out


def generate(cfg: FemnistConfig):
    """Returns (client_data, eval_set).

    client_data: list of dicts {'images': (k,28,28,1), 'labels': (k,)}
    eval_set: {'images': (E,28,28,1), 'labels': (E,)} (global test set)
    """
    rng = np.random.default_rng(cfg.seed)
    protos = _class_prototypes(rng, cfg)

    counts = np.maximum(
        20, rng.lognormal(np.log(cfg.mean_samples), 0.4, cfg.n_clients).astype(int))
    clients = []
    for c in range(cfg.n_clients):
        k = int(counts[c])
        label_p = rng.dirichlet(np.full(cfg.n_classes, cfg.dirichlet_alpha))
        labels = rng.choice(cfg.n_classes, size=k, p=label_p)
        shift = (int(rng.integers(-2, 3)), int(rng.integers(-2, 3)))
        gain = float(rng.uniform(0.8, 1.2))
        imgs = protos[labels]
        imgs = np.stack([_writer_style(rng, im, shift, gain) for im in imgs])
        imgs = imgs + rng.normal(0, cfg.noise, imgs.shape)
        clients.append({
            "images": imgs[..., None].astype(np.float32),
            "labels": labels.astype(np.int32),
        })

    el, ei = [], []
    for cls in range(cfg.n_classes):
        k = cfg.eval_per_class
        imgs = protos[np.full(k, cls)] + rng.normal(0, cfg.noise, (k, cfg.img, cfg.img))
        el.append(np.full(k, cls))
        ei.append(imgs)
    eval_set = {
        "images": np.concatenate(ei)[..., None].astype(np.float32),
        "labels": np.concatenate(el).astype(np.int32),
    }
    return clients, eval_set


def sample_counts(clients) -> np.ndarray:
    return np.array([len(c["labels"]) for c in clients], np.float32)


def client_minibatches(rng: np.random.Generator, client, steps: int, batch: int):
    """(steps, batch, ...) minibatch stack for one client's local epoch."""
    k = len(client["labels"])
    idx = rng.integers(0, k, size=(steps, batch))
    return {
        "images": client["images"][idx],
        "labels": client["labels"][idx],
    }
