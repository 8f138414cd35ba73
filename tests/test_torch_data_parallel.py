"""The LM train step data parallel on ``torch.distributed`` against one
process and the JAX reference: ``specs.make_train_step`` (``gspmd``, the
sharding-induced schedules) on gloo worlds of 2 and 4 CPU ranks for
qwen2-0.5b, olmo-1b and rwkv6-3b at reduced width in f32, with and without
micro-batching, and ``launch.train.run`` on 2 ranks for the paper's pair
of strategies.

Each rank takes the global batch and keeps its rows; the gradients are
summed by the rules' schedule. The port on one process is the reference
point (it is held against JAX in ``tests/test_torch_train.py``), and JAX's
``make_train_step`` is checked here too, from the same parameters (the
port's init carried across): sgd at lr 0.5, every parameter within 1e-5.
The ranks run as in ``tests/test_torch_collectives.py`` (``_spawn``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.bridge import lm_params_to_jax  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs, train  # noqa: E402
from repro_torch.launch.train import build_rules  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_collectives import _paths, _spawn  # noqa: E402

ARCHS = ("qwen2-0.5b", "olmo-1b", "rwkv6-3b")
CASES = [(arch, micro) for arch in ARCHS for micro in (1, 2)]
BATCH, SEQ, LR = 8, 16, 0.5
RUN = dict(steps=3, batch=4, seq=16, opt="sgd", lr=0.05, p_transient=0.3, log_every=100,
           device="cpu")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return configs.get_smoke(arch, dtype="float32")


def _params(arch):
    return transformer.init_params(_cfg(arch), torch.Generator().manual_seed(5), device="cpu")


def _batch():
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    w = rng.integers(1, 300, BATCH).astype(np.float32)
    w[[2, 5]] = 0.0
    return tokens, w


def _step(arch, micro, mesh=None, rules=None):
    """One sgd step from ``_params(arch)`` on the global batch."""
    tokens, w = _batch()
    step = specs.make_train_step(_cfg(arch), "sgd", LR, micro, mesh=mesh, rules=rules)
    new, _, loss = step(_params(arch), {}, {"tokens": torch.from_numpy(tokens).long(),
                                            "client_weight": torch.from_numpy(w)})
    return lm_params_to_jax(new), float(loss), float(step.grad_norm)


def _ranks(rank, world, with_runs):
    """The gspmd step of every case on this rank of a (world, 1) ("data",
    "model") mesh under the sfl rules; on a (1, world) ("pod", "data") mesh
    for qwen2-0.5b; with ``with_runs``, launch.train.run of both strategies
    and the MoE refusal."""
    mesh = mesh_mod.make_test_mesh((world, 1), ("data", "model"), "cpu")
    out = {"steps": {case: _step(*case, mesh=mesh, rules=build_rules(mesh, "sfl"))
                     for case in CASES}}
    flat = mesh_mod.make_test_mesh((1, world), ("pod", "data"), "cpu")
    out["classical"] = _step("qwen2-0.5b", 1, flat, build_rules(flat, "classical"))
    if with_runs:
        out["runs"] = {s: list(train.run(_cfg("qwen2-0.5b"), strategy=s, **RUN)["history"])
                       for s in ("sfl_two_step", "classical")}
        try:
            specs.make_train_step(configs.get_smoke("qwen3-moe-30b-a3b"), mesh=mesh)
        except NotImplementedError as e:
            out["moe"] = str(e)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world2"), 2, _ranks, True)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("world4"), 4, _ranks, False)


@pytest.fixture(scope="module")
def one_process():
    return {case: _step(*case) for case in CASES}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's make_train_step (no mesh: the global batch on one device) for
    every case, from the port's parameters."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.common.sharding import ShardingRules
    from repro.launch import specs as jspecs
    rules = ShardingRules(batch=None, fsdp=None, tensor=None, expert=None)
    tokens, w = _batch()
    out = {}
    for arch, micro in CASES:
        params = jax.tree.map(jnp.asarray, lm_params_to_jax(_params(arch)))
        step = jax.jit(jspecs.make_train_step(jconfigs.get_smoke(arch, dtype="float32"), rules,
                                              "sgd", LR, micro))
        new, _, loss = step(params, {}, {"tokens": jnp.asarray(tokens),
                                         "client_weight": jnp.asarray(w)})
        out[(arch, micro)] = (jax.tree.map(np.asarray, new), float(loss))
    return out


def _close(got, want, where):
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL, err_msg=f"{where} {k}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch,micro", CASES)
def test_gspmd_step_on_ranks_equals_one_process_and_reference(world2, world4, one_process,
                                                              jax_steps, world, arch, micro):
    """The step on every rank: loss, gradient norm and every updated
    parameter within 1e-5 of the one-process port's and JAX's; ranks
    alike bit for bit."""
    ranks = world2 if world == 2 else world4
    want, want_loss, want_norm = one_process[(arch, micro)]
    jnew, jloss = jax_steps[(arch, micro)]
    first = ranks[0]["steps"][(arch, micro)][0]
    for rank, out in enumerate(ranks):
        new, loss, norm = out["steps"][(arch, micro)]
        assert loss == pytest.approx(want_loss, rel=TOL) == jloss
        assert norm == pytest.approx(want_norm, rel=TOL)
        _close(new, want, f"{arch} micro {micro} rank {rank}/{world}")
        _close(new, jnew, f"{arch} micro {micro} rank {rank}/{world} vs JAX")
        for k, leaf in _paths(new).items():
            np.testing.assert_array_equal(leaf, _paths(first)[k])


@pytest.mark.parametrize("world", [2, 4])
def test_classical_schedule_equals_one_process(world2, world4, one_process, world):
    """The replicated rules' flat all-reduce over ("pod", "data") gives
    the same step."""
    ranks = world2 if world == 2 else world4
    want, want_loss, _ = one_process[("qwen2-0.5b", 1)]
    for out in ranks:
        new, loss, _ = out["classical"]
        assert loss == pytest.approx(want_loss, rel=TOL)
        _close(new, want, f"classical {world}")


@pytest.mark.parametrize("strategy", ["sfl_two_step", "classical"])
def test_train_run_on_two_ranks_equals_one_process(world2, strategy):
    """launch.train.run on 2 gloo ranks (the (2, 1) ("data", "model") mesh,
    the strategy's rules): every rank's History equals the one-process
    run's: transport columns exactly, loss and gradient norm within 1e-5."""
    want = list(train.run(_cfg("qwen2-0.5b"), strategy=strategy, **RUN)["history"])
    for out in world2:
        got = out["runs"][strategy]
        assert len(got) == len(want) == RUN["steps"]
        for g, w in zip(got, want):
            for key in ("round", "n_selected", "involved", "upstream_mbits"):
                assert g[key] == w[key], (strategy, key)
            assert g["loss"] == pytest.approx(w["loss"], rel=TOL)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=TOL)
    assert any(r["involved"] < r["n_selected"] for r in want)     # the mask bit


def test_moe_on_more_than_one_rank_names_the_item(world2):
    assert "ROADMAP.md Queue 1 item 1e" in world2[0]["moe"]
    assert "whole batch" in world2[0]["moe"]


def test_batch_rows_per_rank(monkeypatch):
    """A rank's rows: per micro-batch its share of the global micro-batch
    (gspmd), or its block of the batch (two_step_int8); a batch that does
    not split raises."""
    batch = {"x": torch.arange(16)}
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data"))
    monkeypatch.setattr(specs, "client_index", lambda m, axes: (3, 4))   # rank 3 of 4
    rows = [mb["x"].tolist() for mb in specs._rank_micro_batches(batch, mesh, 2, True)]
    assert rows == [[6, 7], [14, 15]]
    rows = [mb["x"].tolist() for mb in specs._rank_micro_batches(batch, mesh, 2, False)]
    assert rows == [[12, 13], [14, 15]]
    with pytest.raises(ValueError, match="does not split"):
        specs._rank_micro_batches(batch, mesh, 8, True)
