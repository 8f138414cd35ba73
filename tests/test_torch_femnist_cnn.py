"""repro_torch's FEMNIST CNN, config copy and parameter bridge against the
JAX reference (repro.models.femnist_cnn), on the reduced CNN and, for the
forward pass and grads, at full width."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import fedavg as jfedavg  # noqa: E402
from repro.data import femnist as jfemnist  # noqa: E402
from repro.models import femnist_cnn as jcnn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.models import femnist_cnn  # noqa: E402


def _jax_params(full=False, seed=0):
    cfg = jconfigs.get("femnist_cnn")
    cfg = cfg if full else cfg.reduced()
    params, _ = jcnn.init_params(cfg, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in params.items()}


def _batch(n, masked):
    clients, _ = jfemnist.generate(jfemnist.FemnistConfig(n_clients=2, seed=11))
    mb = jfemnist.client_minibatches(np.random.default_rng(0), clients[0], 1, n)
    batch = {k: v[0] for k, v in mb.items()}
    if masked:
        batch["mask"] = (np.arange(n) % 3 != 0).astype(np.float32)
    return batch


@pytest.mark.parametrize("full", [False, True])
def test_config_copy_matches_reference(full):
    ref = jconfigs.get("femnist_cnn")
    port = configs.get("femnist_cnn")
    if not full:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_bridge_round_trip_is_exact():
    p = _jax_params()
    t = params_from_jax(p)
    assert tuple(t["conv1_w"].shape) == (4, 1, 5, 5)        # OIHW
    assert tuple(t["conv2_w"].shape) == (8, 4, 5, 5)
    assert tuple(t["fc1_w"].shape) == p["fc1_w"].shape      # (H·W·C, fc) kept
    back = params_to_jax(t)
    assert back.keys() == p.keys()
    for k in p:
        assert back[k].dtype == p[k].dtype and np.array_equal(back[k], p[k]), k


@pytest.mark.parametrize("n,masked", [(10, False), (7, True)])
def test_forward_loss_acc_grads_match_reference(n, masked):
    """Bridged JAX params, same batch: logits, loss, acc and grads agree.
    rtol/atol 1e-5: f32 convolutions sum in a different order."""
    _check_forward_loss_acc_grads(_jax_params(), _batch(n, masked))


def test_full_width_forward_loss_acc_grads_match_reference():
    """The same at full width (channels 32/64, fc 2048), where fc1_w's 3136
    rows follow the reference's 7×7×64 (H, W, C) flatten. Same tolerances."""
    _check_forward_loss_acc_grads(_jax_params(full=True), _batch(6, True))


def _check_forward_loss_acc_grads(p, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_jax(p)

    np.testing.assert_allclose(
        femnist_cnn.apply(tp, tbatch["images"]).numpy(),
        np.asarray(jcnn.apply(p, jbatch["images"])), rtol=1e-5, atol=1e-5)

    (jloss, jaux), jgrads = jax.value_and_grad(jcnn.loss_fn, has_aux=True)(p, jbatch)
    (tloss, taux), tgrads = torch.func.grad_and_value(
        femnist_cnn.loss_fn, has_aux=True)(tp, tbatch)[::-1]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
    assert float(taux["acc"]) == pytest.approx(float(jaux["acc"]), abs=1e-6)
    tgrads_jax = params_to_jax(tgrads)
    for k in p:
        np.testing.assert_allclose(tgrads_jax[k], np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    ev = fedavg.evaluate(tp, tbatch, femnist_cnn.loss_fn)
    jev = jfedavg.evaluate(p, jbatch, jcnn.loss_fn)
    assert ev.keys() == jev.keys() == {"eval_loss", "eval_acc"}
    for k in ev:
        assert float(ev[k]) == pytest.approx(float(jev[k]), rel=1e-5, abs=1e-6)


def test_init_matches_reference_per_leaf_std():
    """The port's own init (torch.Generator) copies ParamBuilder's
    std = scale/sqrt(jax_shape[0]) per leaf, within 5%."""
    cfg = configs.get("femnist_cnn")
    ref = _jax_params(full=True)
    port = params_to_jax(femnist_cnn.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert sum(v.size for v in port.values()) == 6_603_710
    for k, want in ref.items():
        got = port[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if not want.any():
            assert not got.any(), k                    # zero-init biases
        else:
            assert got.std() == pytest.approx(want.std(), rel=0.05), k


def test_module_wrapper_matches_functional_apply():
    cfg = configs.get("femnist_cnn").reduced()
    model = femnist_cnn.FemnistCNN(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
    params = femnist_cnn.init_params(cfg, torch.Generator().manual_seed(1),
                                     device="cpu")
    images = torch.from_numpy(_batch(5, False)["images"])
    with torch.no_grad():
        assert torch.equal(model(images), femnist_cnn.apply(params, images))
