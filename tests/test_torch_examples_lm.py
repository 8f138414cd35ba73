"""The LM examples of the port (``examples_torch/train_lm.py``,
``serve_lm.py``) and ``repro_torch.models``' package API against the
reference's.

The reference's LM init cannot be repeated (it re-draws from
``hash(cfg.name)``; ROADMAP.md Queue 3), so the LM examples are held by
what they forward — each port example hands its driver the reference
example's argument list (plus ``--device``) — and by an end-to-end CPU run
with finite output. ``models.init_params`` and ``loss_fn`` are held
against ``repro.models``' on the reference's parameters, bridged.
"""
import importlib.util
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as jmodels  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.common.sharding import ShardingRules  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.bridge import lm_params_from_jax, params_from_jax  # noqa: E402
from reference_draws import reference_init  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RULES = ShardingRules(batch=None, fsdp=None, tensor=None, expert=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread beside JAX's pool in each test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(directory: str, name: str):
    path = os.path.join(ROOT, directory, name + ".py")
    spec = importlib.util.spec_from_file_location(f"_{directory}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------ the LM examples

def _forwarded(name, driver, argv, monkeypatch, capsys):
    """(reference argv, port argv, reference stdout, port stdout): what each
    example hands its driver's ``main``, the drivers stubbed."""
    import importlib
    ref_driver = importlib.import_module(f"repro.launch.{driver}")
    port_driver = importlib.import_module(f"repro_torch.launch.{driver}")
    seen = {}
    monkeypatch.setattr(ref_driver, "main", lambda: seen.setdefault("ref", list(sys.argv)))
    monkeypatch.setattr(port_driver, "main", lambda a=None: seen.setdefault("port", list(a)))
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    capsys.readouterr()
    _load("examples", name).main()
    ref_out = capsys.readouterr().out
    _load("examples_torch", name).main([*argv, "--device", "cpu"])
    return seen["ref"], seen["port"], ref_out, capsys.readouterr().out


@pytest.mark.parametrize("name,driver,argv", [
    ("train_lm", "train", ["--steps", "7", "--batch", "2", "--seq", "64", "--ckpt", "ck"]),
    ("train_lm", "train", ["--ckpt", "ck"]),
    ("serve_lm", "serve", []),
    ("serve_lm", "serve", ["--arch", "rwkv6-3b", "--batch", "2", "--prompt-len", "8",
                           "--gen", "3"]),
], ids=["train_lm", "train_lm_defaults", "serve_lm_defaults", "serve_lm_rwkv6"])
def test_lm_example_forwards_the_reference_argv(name, driver, argv, monkeypatch, capsys):
    ref, port, ref_out, port_out = _forwarded(name, driver, argv, monkeypatch, capsys)
    assert ref[0] == driver
    assert port == ref[1:] + ["--device", "cpu"]
    assert port_out == ref_out          # train_lm's model line; serve prints nothing first


def test_train_lm_default_checkpoint_is_under_the_temp_dir():
    """The one default that differs from the reference's (a fixed path):
    the port's follows ``tempfile.gettempdir()``."""
    import tempfile
    argv = _load("examples_torch", "train_lm").forwarded_argv([])
    ckpt = argv[argv.index("--ckpt") + 1]
    assert os.path.dirname(ckpt) == tempfile.gettempdir()
    assert argv[:argv.index("--ckpt")] == ["--arch", "olmo-100m", "--steps", "300",
                                           "--batch", "8", "--seq", "256"]


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    """olmo-100m at its full width, 2 steps of a tiny batch: finite losses,
    the final checkpoint written."""
    ckpt = tmp_path / "ck"
    res = _load("examples_torch", "train_lm").main(
        ["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt", str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("model: olmo-100m, ")
    losses = res["history"].column("loss")
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert res["cfg"].name == "olmo-100m" and res["cfg"] == configs.get("olmo-100m")
    assert (ckpt / "step_2").is_dir()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_serve_lm_runs_on_the_cpu(arch, capsys):
    res = _load("examples_torch", "serve_lm").main(
        ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "decode 3 steps" in out
    assert tuple(res["tokens"].shape) == (2, 4)
    assert torch.isfinite(res["logits"].float()).all()
    assert res["cfg"] == configs.get_smoke(arch)


# ------------------------------------------------------------ models' package API

def test_models_reexports_the_reference_names():
    assert set(models.__all__) == set(jmodels.__all__)
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        got, want = getattr(models, name), getattr(jmodels, name)
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (want.name, want.seq_len, want.global_batch, want.kind)
    assert [s.name for s in models.ALL_SHAPES] == [s.name for s in jmodels.ALL_SHAPES]
    assert models.shape_by_name("train_4k") == models.TRAIN_4K
    assert models.ModelConfig is configs.get("qwen2-0.5b").__class__
    assert models.transformer.__name__ == "repro_torch.models.transformer"
    assert models.femnist_cnn.__name__ == "repro_torch.models.femnist_cnn"


def test_models_api_cnn_matches_reference():
    """The reduced and full CNN: the same leaves and shapes; loss and
    accuracy on the reference's parameters, bridged, within 1e-5."""
    for full in (False, True):
        cfg = configs.get("femnist_cnn") if full else configs.get("femnist_cnn").reduced()
        jcfg = jconfigs.get("femnist_cnn") if full else jconfigs.get("femnist_cnn").reduced()
        jparams, _ = jmodels.init_params(jcfg, jax.random.PRNGKey(3))
        bridged = params_from_jax(_np_tree(jparams))
        mine = models.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        meta = models.init_params(cfg, device="meta")
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in bridged.items()} == \
            {k: tuple(v.shape) for k, v in meta.items()}
        assert all(v.device.type == "meta" for v in meta.values())
        rng = np.random.default_rng(1)
        batch = {"images": rng.random((6, 28, 28, 1), np.float32),
                 "labels": rng.integers(0, 62, 6).astype(np.int32),
                 "mask": np.array([1, 1, 0, 1, 1, 1], np.float32)}
        loss, m = models.loss_fn(bridged, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 cfg)
        jloss, jm = jmodels.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jcfg, RULES)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
        assert float(m["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-3b"])
def test_models_api_transformer_matches_reference(arch):
    """A smoke transformer (f32): the loss of the reference's parameters,
    bridged, within 1e-5; the port's init has the reference's leaves and
    shapes, on the CPU and on ``meta``."""
    cfg, jcfg = configs.get_smoke(arch, dtype="float32"), jconfigs.get_smoke(arch, dtype="float32")
    jparams, _ = reference_init(jmodels.transformer, jcfg, jax.random.PRNGKey(0),
                                 init=jmodels.init_params)
    bridged = lm_params_from_jax(_np_tree(jparams))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
                for k, v in tree.items()}

    def devices(tree):
        return {d for v in tree.values()
                for d in (devices(v) if isinstance(v, dict) else {v.device.type})}

    mine = models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    meta = models.init_params(cfg, device="meta")
    assert shapes(mine) == shapes(bridged) == shapes(meta)
    assert devices(mine) == {"cpu"} and devices(meta) == {"meta"}
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    loss, m = models.loss_fn(bridged, {"tokens": torch.from_numpy(toks)}, cfg)
    jloss, jm = jmodels.loss_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, RULES)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-5)
    assert float(m["xent"]) == pytest.approx(float(jm["xent"]), rel=1e-5, abs=1e-5)


def test_models_api_dispatches_on_the_family(monkeypatch):
    """``init_params`` / ``loss_fn`` reach the family's module with the
    caller's generator, device and tp."""
    calls = []
    for mod, fam in ((models.femnist_cnn, "cnn"), (models.transformer, "lm")):
        monkeypatch.setattr(mod, "init_params", lambda *a, _f=fam: calls.append((_f, a)))
        monkeypatch.setattr(mod, "loss_fn", lambda *a, _f=fam: calls.append((_f, len(a))))
    g = torch.Generator()
    cnn, lm = configs.get("femnist_cnn"), configs.get_smoke("olmo-1b")
    models.init_params(cnn, g, "cpu")
    models.init_params(lm, g, "cpu", 4)
    models.loss_fn({}, {}, cnn)
    models.loss_fn({}, {}, lm)
    assert calls == [("cnn", (cnn, g, "cpu")), ("lm", (lm, g, "cpu", 4)), ("cnn", 2), ("lm", 3)]
