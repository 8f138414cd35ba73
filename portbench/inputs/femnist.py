"""The federated clients: synthetic FEMNIST-like writers (LEAF's data is not
in the repository).

A frozen copy of ``repro_torch.data.femnist.generate`` as it stood when
the benchmark was made: the clients are the benchmark's inputs, so they
stay fixed when the program's generator changes, and
``portbench/tests/test_portbench_reference.py`` holds the copy to the
stream it drew then. It draws the same numbers in the same order as the
original and returns the same arrays to float rounding: each writer's
style shift is applied to its whole image stack in one ``np.roll``
instead of image by image, and the prototypes' smoothing is a NumPy
convolution in place of SciPy's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def _smooth(basis: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Each image convolved with the symmetric kernel ``k``, zero-padded to
    the same size (``scipy.signal.convolve2d(..., mode="same")``)."""
    r = k.shape[0] // 2
    padded = np.pad(basis, ((0, 0), (r, r), (r, r)))
    return np.einsum("nijab,ab->nij", sliding_window_view(padded, k.shape, axis=(1, 2)), k)


def _class_prototypes(rng: np.random.Generator, n_classes: int, img: int,
                      proto_rank: int) -> np.ndarray:
    basis = rng.normal(0, 1, size=(proto_rank, img, img))
    k = np.outer(np.hanning(7), np.hanning(7))
    k /= k.sum()
    basis = _smooth(basis, k)
    coef = rng.normal(0, 1, size=(n_classes, proto_rank))
    coef *= (rng.random((n_classes, proto_rank)) < 0.4)
    protos = np.einsum("cr,rxy->cxy", coef, basis)
    protos /= protos.std(axis=(1, 2), keepdims=True) + 1e-9
    return protos.astype(np.float32)


def generate(n_clients: int, seed: int, n_classes: int = 62, img: int = 28,
             mean_samples: float = 120.0, dirichlet_alpha: float = 0.25,
             noise: float = 0.8, proto_rank: int = 16, eval_per_class: int = 8
             ) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, np.ndarray]]:
    """(clients, eval set): each client {'images': (k, 28, 28, 1) f32,
    'labels': (k,) int32}; the eval set one array pair of
    ``eval_per_class`` images a class."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, n_classes, img, proto_rank)
    counts = np.maximum(20, rng.lognormal(np.log(mean_samples), 0.4, n_clients).astype(int))
    clients = []
    for c in range(n_clients):
        k = int(counts[c])
        label_p = rng.dirichlet(np.full(n_classes, dirichlet_alpha))
        labels = rng.choice(n_classes, size=k, p=label_p)
        shift = (int(rng.integers(-2, 3)), int(rng.integers(-2, 3)))
        gain = float(rng.uniform(0.8, 1.2))
        imgs = np.roll(protos[labels], shift=shift, axis=(1, 2)) * gain
        imgs = imgs + rng.normal(0, noise, imgs.shape)
        clients.append({"images": imgs[..., None].astype(np.float32),
                        "labels": labels.astype(np.int32)})
    el, ei = [], []
    for cls in range(n_classes):
        imgs = protos[np.full(eval_per_class, cls)] + rng.normal(
            0, noise, (eval_per_class, img, img))
        el.append(np.full(eval_per_class, cls))
        ei.append(imgs)
    eval_set = {"images": np.concatenate(ei)[..., None].astype(np.float32),
                "labels": np.concatenate(el).astype(np.int32)}
    return clients, eval_set


def sample_counts(clients) -> np.ndarray:
    return np.array([len(c["labels"]) for c in clients], np.float32)
