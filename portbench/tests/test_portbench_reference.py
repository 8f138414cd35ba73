"""The plain reference against the program on the CPU, at reduced width: it
imports nothing of the program, so each piece is held against the
program's own here (a test may import both)."""
import hashlib
import time

import numpy as np
import pytest
import torch

from portbench.harness import cells, checks
from portbench.inputs import femnist
from portbench.reference import pon

from conftest import tiny_fl_cell


def test_the_client_generator_draws_its_frozen_stream():
    """The clients are the benchmark's own inputs and do not move when the
    program changes: the labels bit for bit and the images to float
    rounding, as drawn when the copy was taken from
    ``repro_torch.data.femnist.generate`` (24 clients, seed 987)."""
    clients, ev = femnist.generate(24, 987)
    labels = b"".join(c["labels"].astype("<i4").tobytes() for c in clients)
    assert hashlib.sha256(labels).hexdigest() == (
        "660b0b1bcc88d64693130f3b34753b062517e68d0ea43903b47ccf4cf0f265d0")
    assert [len(c["labels"]) for c in clients][:6] == [218, 98, 181, 156, 161, 177]
    images = [np.float64(c["images"]) for c in clients]
    assert sum(x.sum() for x in images) == pytest.approx(7177.772034442841, rel=1e-9)
    assert sum(np.abs(x).sum() for x in images) == pytest.approx(2667967.604876172, rel=1e-9)
    assert float(np.float64(ev["images"]).sum()) == pytest.approx(1101.987296200893, rel=1e-9)
    assert float(clients[5]["images"][3, 10, 11, 0]) == pytest.approx(-1.108538269996643, abs=1e-6)


@pytest.mark.parametrize("n_pons, compress", [(1, "none"), (1, "int8"), (4, "int8"), (2, "none")])
def test_the_transports_closed_form_is_the_simulators(n_pons, compress):
    """Involvement and upstream Mbits equal the program's event simulator's
    exactly, round after round, and the two draw the same numbers."""
    from repro_torch.core.fedavg import FLConfig, round_transport
    from repro_torch.pon import PonConfig

    n_onus, per = 16, 20
    fl = FLConfig(n_onus=n_onus, clients_per_onu=per, n_pons=n_pons, pon=PonConfig())
    counts = np.random.default_rng(3).integers(20, 400, fl.n_clients).astype(np.float32)
    onu_ids = np.arange(fl.n_clients) // per
    scale = 0.25 if compress == "int8" else None
    mbits = pon.MODEL_MBITS * (scale or 1.0)
    for seed in range(6):
        rp, rr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            sel = pon.select(rr, fl.n_clients, 128 * n_pons)
            assert np.array_equal(sel, rp.choice(fl.n_clients, size=len(sel), replace=False))
            rt = round_transport(fl, rp, sel, counts, onu_ids,
                                 mode="hier" if n_pons > 1 else "sfl", wire_scale=scale)
            if n_pons == 1:
                mask, up = pon.one_pon_sfl(rr, sel, onu_ids, counts, n_onus, 25.0, mbits)
            else:
                mask, up = pon.forest_hier(rr, sel, onu_ids, counts, n_pons, n_onus, 25.0,
                                           mbits, 1000.0, 0.5)
            np.testing.assert_array_equal(mask, rt["involved"])
            assert up == rt["upstream_mbits"]
            assert 0 < mask.sum() < len(sel) or n_pons == 1
        assert rp.random() == rr.random()


@pytest.mark.parametrize("cell", ["fl_sfl_n128", "fl_hier_int8_n512"])
def test_a_cpu_run_of_the_fl_cell_is_correct(cell):
    """The whole run but the card: set-up, window, comparison."""
    c = tiny_fl_cell(cell)
    out = cells.driver("fl_round").run(c, 2**31 + 77, 0.5, False, "cpu", time.perf_counter())
    assert checks.passed(out.checks), out.checks
    assert out.failed == 0 and out.attempted >= 1
    gaps = {n: v for n, v, _ in out.checks}
    assert gaps["transport_mismatches"] == 0 and gaps["change_worst_gap"] < 1e-5


def test_the_flip_share_counts_codes_rounded_otherwise():
    """A quarter of the last tier's step or more counts, and so does a value
    that is not finite; f32 rounding does not."""
    ref = {"a": torch.arange(8, dtype=torch.float32) * 0.5, "b": torch.ones(2)}
    steps = {"a": 0.5, "b": 0.01}
    assert checks.flip_share(dict(ref), ref, steps) == 0.0
    near = {k: v * (1 + 1e-7) for k, v in ref.items()}
    assert checks.flip_share(near, ref, steps) == 0.0
    off = {"a": ref["a"].clone(), "b": ref["b"].clone()}
    off["a"][3] += 0.5
    off["b"][1] = float("nan")
    assert checks.flip_share(off, ref, steps) == 2 / 10
