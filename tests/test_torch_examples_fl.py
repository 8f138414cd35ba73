"""The FEMNIST examples of the port (``examples_torch/``) against the
reference's (``examples/``), and ``launch.femnist.run``'s failure knobs
against ``benchmarks/bench_accuracy.run``.

Each reference example runs through its ``main`` with ``sys.argv`` set and
its output captured; the port's through ``main(argv)`` with ``--device
cpu`` at the same small size. The port's CNN starts from the reference's
initial parameters (``femnist_cnn.init_params`` is replaced by the
reference's init of the same seed, carried across with
``repro_torch.bridge``), so the runs train the same model. Transport
columns (involved, upstream Mb, θ uploads, an update's simulated time and
staleness) must be equal. What training moves is held as
``tests/test_torch_fl.py::test_slice_matches_reference_round_loop`` holds
it: each round's (or update's) accuracy within ACC_ABS and eval loss within
LOSS_REL, the trained parameters within PARAM_ATOL of the reference's; and
the parameters must have moved from the init by more than 100 × PARAM_ATOL,
so that an example which trained nothing, or trained with another step
size, step count or strategy, fails. At these sizes the accuracy sits near
chance (1/62) on both sides, so it alone would hold nothing.
"""
import importlib.util
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.launch import femnist as launch  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402
from repro_torch.pon import PonConfig  # noqa: E402
from test_torch_compression import _jax_noise  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ACC_ABS, LOSS_REL, PARAM_ATOL = 0.02, 1e-3, 1e-4
SMALL = ["--onus", "2", "--clients-per-onu", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(directory: str, name: str):
    """An example script as a module (a fresh one each call)."""
    path = os.path.join(ROOT, directory, name + ".py")
    spec = importlib.util.spec_from_file_location(f"_{directory}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, argv, monkeypatch, capsys) -> str:
    """The reference example's stdout for ``argv``."""
    mod = _load("examples", name)
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _port(name, argv, capsys):
    """(the port example's return value, its stdout) on the CPU."""
    mod = _load("examples_torch", name)
    capsys.readouterr()
    out = mod.main([*argv, "--device", "cpu"])
    return out, capsys.readouterr().out


@pytest.fixture
def bridged_init(monkeypatch):
    """The port's CNN init replaced by the reference's of the same seed
    (the generator's), width and device; yields the last init made (the
    reference's layout, numpy)."""
    made = {}

    def init(cfg, generator=None, device="cuda"):
        seed = 0 if generator is None else generator.initial_seed()
        jcfg = jconfigs.get("femnist_cnn")
        jcfg = jcfg if cfg.cnn_fc == jcfg.cnn_fc else jcfg.reduced()
        params, _ = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
        made.update({k: np.asarray(v) for k, v in params.items()})
        return {k: v.to(device) for k, v in params_from_jax(made).items()}
    monkeypatch.setattr(femnist_cnn, "init_params", init)
    return made


@pytest.fixture
def drivers(monkeypatch):
    """Every RoundLoop and Orchestrator the examples make, by package:
    ``{"ref": [...], "port": [...]}`` in the order made."""
    import repro.fl
    import repro.runtime
    import repro_torch.fl
    import repro_torch.runtime
    made = {"ref": [], "port": []}
    for side, mod, name in (("ref", repro.fl, "RoundLoop"),
                            ("ref", repro.runtime, "Orchestrator"),
                            ("port", repro_torch.fl, "RoundLoop"),
                            ("port", repro_torch.runtime, "Orchestrator")):
        cls = getattr(mod, name)
        recorded = type(name, (cls,), {"__init__": _recording(cls, made[side])})
        monkeypatch.setattr(mod, name, recorded)
    return made


def _recording(cls, into: list):
    def __init__(self, *args, **kwargs):
        cls.__init__(self, *args, **kwargs)
        into.append(self)
    return __init__


@pytest.fixture
def wire_levels(monkeypatch):
    """Compressed runs: the port's stochastic rounding draws the reference's
    noise (``test_torch_compression._jax_noise``), and every scale it
    dequantizes is kept (``wire_levels["max"]``: the coarsest level)."""
    from repro_torch.core import compression as tc
    levels = {"max": 0.0}
    real = tc._dequantize_kernel

    def uniform_noise(self, call, shapes):
        return [u.to(self.device) for u in _jax_noise(call, shapes, self.seed)]

    def dequantize(q, s, mask=None):
        levels["max"] = max(levels["max"], float(s.abs().max()))
        return real(q, s, mask)
    monkeypatch.setattr(tc.CompressionState, "uniform_noise", uniform_noise)
    monkeypatch.setattr(tc, "_dequantize_kernel", dequantize)
    return levels


def _same_params(got: dict, want: dict, init: dict, where: str, level: float = 0.0) -> None:
    """The port's parameters (its layout) within PARAM_ATOL of the
    reference's, and moved from the init by more than 100 × PARAM_ATOL.

    Under int8 on the wire (``level`` > 0: its coarsest quantization level)
    a row is summed in another order than the reference's, so an element
    within an ulp of a rounding boundary may land one level over: at most
    0.1% of a leaf (at least one element) may then be off by more than
    PARAM_ATOL, and by no more than ``level`` + PARAM_ATOL, as
    ``test_torch_compression`` holds a compressed round."""
    got = params_to_jax(got)
    assert set(got) == set(want) == set(init), where
    for k, v in want.items():
        diff = np.abs(got[k] - np.asarray(v))
        off = int((diff > PARAM_ATOL).sum())
        allowed = max(1, int(1e-3 * diff.size)) if level else 0
        assert off <= allowed and diff.max() <= level + PARAM_ATOL, (
            f"{k} ({where}): {off} elements off by up to {diff.max()}, level {level}")
    moved = max(float(np.abs(np.asarray(want[k]) - init[k]).max()) for k in want)
    assert moved > 100 * PARAM_ATOL, f"{where}: parameters moved {moved} from the init"


def _same_training(drivers: dict, init: dict, level: float = 0.0) -> None:
    """Each driver the port made against the reference's in turn: every
    History row's accuracy and eval loss, and the final parameters
    (``_same_params``)."""
    assert len(drivers["port"]) == len(drivers["ref"]) > 0
    for i, (got, want) in enumerate(zip(drivers["port"], drivers["ref"])):
        rows, jrows = list(got.history), list(want.history)
        assert len(rows) == len(jrows) > 0
        losses = [(r["eval_loss"], j["eval_loss"]) for r, j in zip(rows, jrows)
                  if "eval_loss" in j]
        assert losses and len(losses) == sum("eval_loss" in r for r in rows)
        for r, j in zip(rows, jrows):
            assert r.get("acc", 0.0) == pytest.approx(j.get("acc", 0.0), abs=ACC_ABS)
        for a, b in losses:
            assert a == pytest.approx(b, rel=LOSS_REL), (i, losses)
        _same_params(got.backend.params, want.backend.params, init,
                     f"driver {i} ({want.cfg.strategy})", level)


def _csv(out: str):
    """(header, rows) of a comparison example's CSV, and its final line."""
    lines = [ln for ln in out.splitlines() if ln]
    start = next(i for i, ln in enumerate(lines) if ln.startswith("round,"))
    header = lines[start].split(",")
    rows = [dict(zip(header, ln.split(","))) for ln in lines[start + 1:]
            if re.match(r"^\d+,", ln)]
    return header, rows, lines[-1]


def _same_comparison(rows, ref_out, port_out):
    """The port's returned rows and printed CSV against the reference's CSV:
    columns, involvement exact, accuracy within ACC_ABS."""
    header, want, want_final = _csv(ref_out)
    got_header, printed, got_final = _csv(port_out)
    assert got_header == header
    assert len(rows) == len(want) == len(printed) > 0
    for r, p, w in zip(rows, printed, want):
        for col in header:
            if col.endswith("_involved") or col == "round":
                assert p[col] == w[col], (col, p[col], w[col])
                assert f"{r[col]:.0f}" == w[col]
            else:
                assert r[col] == pytest.approx(float(w[col]), abs=ACC_ABS), col
    assert got_final.split(":")[0] == want_final.split(":")[0]


@pytest.mark.parametrize("argv", [
    ["--rounds", "2", "--n-selected", "16"],
    ["--rounds", "1", "--n-selected", "16", "--p-transient", "0.3", "--overselect", "0.25"],
    ["--rounds", "1", "--n-selected", "8", "--compress", "int8"] + SMALL,
], ids=["sfl", "failures", "int8"])
def test_train_femnist_sfl_matches_reference(argv, bridged_init, drivers, wire_levels,
                                             monkeypatch, capsys):
    """The paper's PON (16 ONUs × 20 clients) at N = 16, and a small one."""
    ref = _reference("train_femnist_sfl", argv, monkeypatch, capsys)
    rows, out = _port("train_femnist_sfl", argv, capsys)
    _same_comparison(rows, ref, out)
    assert (wire_levels["max"] > 0) == ("--compress" in argv)
    _same_training(drivers, bridged_init, wire_levels["max"])


def test_train_femnist_hier_matches_reference(bridged_init, drivers, monkeypatch, capsys):
    argv = ["--rounds", "2", "--n-pons", "2", "--per-pon-selected", "4"] + SMALL
    ref = _reference("train_femnist_hier", argv, monkeypatch, capsys)
    rows, out = _port("train_femnist_hier", argv, capsys)
    _same_comparison(rows, ref, out)
    _same_training(drivers, bridged_init)
    assert "hier_sfl_acc" in rows[0] and "(2 PONs, N=8)" in out


_QUICK = re.compile(r"\[(\w+)\s*\] selected (\d+), involved (\d+), upstream (\d+) Mb \(([\d.]+) MB\)")
_TRAINED = re.compile(r"trained: eval acc ([\d.]+), θ uploads = (\d+) \(constant, vs (\d+) ")


def test_quickstart_matches_reference(bridged_init, monkeypatch, capsys):
    """The reference's trained parameters and eval set are taken from its
    ``fedavg.apply_round`` and ``femnist.generate``, which it prints
    nothing of but the accuracy."""
    from repro.core import fedavg as jfedavg
    from repro.data import femnist as jfemnist
    seen = {}

    def keep(name, fn):
        def kept(*args, **kwargs):
            seen[name] = out = fn(*args, **kwargs)
            return out
        return kept
    monkeypatch.setattr(jfedavg, "apply_round", keep("round", jfedavg.apply_round))
    monkeypatch.setattr(jfemnist, "generate", keep("data", jfemnist.generate))
    ref = _reference("quickstart", [], monkeypatch, capsys)
    got, out = _port("quickstart", [], capsys)
    assert _QUICK.findall(out) == _QUICK.findall(ref)
    assert [m[0] for m in _QUICK.findall(out)] == ["classical", "sfl"]
    (acc, uploads, involved), = _TRAINED.findall(out)
    (ref_acc, ref_uploads, ref_involved), = _TRAINED.findall(ref)
    assert (uploads, involved) == (ref_uploads, ref_involved)
    assert got["sfl"]["acc"] == pytest.approx(float(ref_acc), abs=ACC_ABS)
    assert got["sfl"]["uplink_models"] == int(ref_uploads)
    assert got["classical"]["involved"] < got["sfl"]["involved"]
    want = {k: np.asarray(v) for k, v in seen["round"][0].items()}
    _same_params(got["sfl"]["params"], want, bridged_init, "quickstart")
    eval_batch = {k: jax.numpy.asarray(v) for k, v in seen["data"][1].items()}
    ref_loss = float(jcnn.loss_fn(seen["round"][0], eval_batch)[0])
    assert got["sfl"]["eval_loss"] == pytest.approx(ref_loss, rel=LOSS_REL)


_UPDATE = re.compile(r"t=\s*([\d.]+)s update\s+(\d+) acc ([\d.]+) involved (\d+) "
                     r"staleness ([\d.]+) upstream (\d+) Mb")


@pytest.mark.parametrize("policy", ["fedbuff", "semi_sync"])
def test_train_femnist_async_matches_reference(policy, bridged_init, drivers, monkeypatch,
                                               capsys):
    argv = ["--rounds", "2", "--n-selected", "8", "--policy", policy] + SMALL
    ref = _reference("train_femnist_async", argv, monkeypatch, capsys)
    rows, out = _port("train_femnist_async", argv, capsys)
    want, got = _UPDATE.findall(ref), _UPDATE.findall(out)
    assert len(got) == len(want) == len(rows) > 0
    for g, w, row in zip(got, want, rows):
        # t_s, update, involved, staleness, upstream exact; acc within ACC_ABS
        assert (g[0], g[1], g[3], g[4], g[5]) == (w[0], w[1], w[3], w[4], w[5])
        assert row.get("acc", 0.0) == pytest.approx(float(w[2]), abs=ACC_ABS)
    ref_lines, out_lines = ref.splitlines(), out.splitlines()
    assert out_lines[0] == ref_lines[0]                      # policy / budget line
    assert out_lines[-1].split(";")[0] == ref_lines[-1].split(";")[0]   # updates in budget
    _same_training(drivers, bridged_init)


def test_run_failure_knobs_match_bench_accuracy():
    """``launch.femnist.run(p_transient=...)`` gives ``bench_accuracy.run``'s
    involved column exactly (the failure draws ride the loop's own RNG)."""
    from benchmarks import bench_accuracy
    from repro.pon import PonConfig as JPonConfig
    kw = dict(n_rounds=1, n_selected=8, seed=0, modes=("classical", "sfl"))
    want = bench_accuracy.run(pon=JPonConfig(n_onus=2, clients_per_onu=4),
                              p_transient=0.3, **kw)
    got = launch.run(pon=PonConfig(n_onus=2, clients_per_onu=4), p_transient=0.3,
                     device="cpu", **kw)
    clean = launch.run(pon=PonConfig(n_onus=2, clients_per_onu=4), device="cpu", **kw)
    for mode in kw["modes"]:
        assert got[mode]["involved"] == want[mode]["involved"], mode
        assert got[mode]["loop"].cfg.p_transient == 0.3
    assert got["sfl"]["involved"] != clean["sfl"]["involved"]
