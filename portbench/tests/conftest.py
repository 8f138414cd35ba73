"""The benchmark's tests: CPU tests of its arithmetic, its isolation from
the JAX package, its harness and its reference; card tests carry the
``cuda`` marker and skip without a card.

    python -m pytest -q portbench/tests              # on any machine
    python -m pytest -q -m cuda portbench/tests      # on the card
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _card_only(request):
    """A ``cuda`` test runs only where a card is; decided per test, never
    while the module is imported."""
    if request.node.get_closest_marker("cuda"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA CUDA card")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_fl_cell(name):
    """An FL cell cut to a CPU test's size: a narrow CNN, 4 ONUs of 5
    clients a PON (2 PONs for a forest), 12 selected a PON, chunks of 4;
    the cell's own limits."""
    from portbench.harness import cells

    c = cells.load(name)
    c.config = dict(c.config, conv_channels=[8, 16], fc_width=128)
    f = dict(c.traffic["fl"], n_onus=4, clients_per_onu=5, client_chunk=4)
    f["n_pons"] = min(f["n_pons"], 2)
    f["n_selected"] = 12 * f["n_pons"]
    c.traffic = dict(c.traffic, fl=f)
    return c
