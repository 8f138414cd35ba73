"""What decides ``correct`` has to fail when it should. The control (the
reference in the program's place, in TF32: the precision below the
configuration's f32) fails a limit at a test's size; and a run driven
with the timed path broken underneath comes out not correct, once for
each fault the cells can have (one card, so no exchange between cards to
leave out)."""
import math
import time

import pytest
import torch

from portbench.drivers import fl_round
from portbench.harness import cells, checks
from repro_torch.core import fedavg
from repro_torch.fl import backends

from conftest import tiny_fl_cell

CELLS = ["fl_sfl_n128", "fl_hier_int8_n512"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    """At the cell's widths, 8 clients a PON (fewer clients average less,
    so the control reads no lower than at the cell's size)."""
    c = tiny_fl_cell(cell)
    c.config = cells.load(cell).config
    c.traffic["fl"]["n_selected"] = 8 * c.traffic["fl"]["n_pons"]
    for variant, numbers in fl_round.readings(c, 1, torch.device("cpu")).items():
        limited = [x for x in numbers if math.isfinite(x[2])]
        assert not checks.passed(limited), (variant, numbers)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(fedavg, "server_apply", lambda params, agg, server_lr=1.0: params)


def _half_batch(monkeypatch):
    orig = backends.ClientStackedBackend._apply_and_eval

    def half(self, rnd, stacked, weights, mask, onu_ids, client_ids):
        weights, mask = weights.copy(), mask.copy()
        keep = max(1, int(mask.sum()) // 2)
        weights[keep:], mask[keep:] = 0.0, 0.0
        return orig(self, rnd, stacked, weights, mask, onu_ids, client_ids)

    monkeypatch.setattr(backends.ClientStackedBackend, "_apply_and_eval", half)


def _alter_answer(monkeypatch):
    orig = fedavg.train_selected_clients

    def altered(*args, **kwargs):
        deltas, losses = orig(*args, **kwargs)
        return {k: torch.cat([-v[:1], v[1:]]) for k, v in deltas.items()}, losses

    monkeypatch.setattr(fedavg, "train_selected_clients", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_batch, _alter_answer])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    out = fl_round.run(tiny_fl_cell(cell), 4242, 0.3, False, "cpu", time.perf_counter())
    assert checks.passed(out.checks) is (fault is None), out.checks
