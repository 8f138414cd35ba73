"""The frozen work arithmetic: the configurations' parameter totals, and
each timed kernel's bound at the shapes of PERF.md §6's kernel table."""
import json
import math

import pytest

from portbench.work import kernels, models

from conftest import ROOT


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, count, params_key", [
    ("femnist-cnn", 6_603_710, models.cnn_params),
    ("olmo-1b", 1_176_764_416, models.lm_params),
])
def test_parameter_totals(name, count, params_key):
    cfg = _config(name)
    assert params_key(cfg) == count == cfg["params"]


def test_model_flops():
    cnn = _config("femnist-cnn")
    assert models.cnn_forward_flops(cnn) == cnn["model_flops"]["forward_per_sample"]
    assert models.cnn_train_flops_per_sample(cnn) == cnn["model_flops"]["train_per_sample"]
    # 8 × 2048 OLMo-1B tokens a step: 122.3 TFLOP of model work
    olmo = _config("olmo-1b")
    assert models.lm_train_flops_per_token(olmo, 2048) * 16384 / 1e12 == pytest.approx(122.278, abs=1e-3)


FC1 = 6_422_528        # the fc1_w leaf
LM_LEAF = 136_134_656  # the LM gradient path's embedding leaf

# (work, PERF.md §6 "Bound ms")
ROWS = {
    "1 agg_reduce C=128, 16 segments": (kernels.agg_reduce(128, FC1, 16, 4), 1.1043),
    "1' agg_reduce C=16, one segment": (kernels.agg_reduce(16, FC1, 1, 4), 0.1304),
    "2 agg_reduce_quant C=128, 16 segments": (kernels.agg_reduce_quant(128, FC1, 16, 4), 1.1350),
    "3 quantize (16, N)": (kernels.quantize(16, FC1, 4), 0.2761),
    "3 quantize, the LM leaf": (kernels.quantize(1, LM_LEAF, 4), 0.3657),
    "4 dequantize (16, N), row mask": (kernels.dequantize(16, FC1, True), 0.1534),
    "4 dequantize, the LM leaf": (kernels.dequantize(1, LM_LEAF, False), 0.2032),
    "6 flash (4, 16, 4096, 256), KV 1, window 2048": (
        kernels.flash_attention(4, 16, 1, 4096, 256, 2, window=2048), 0.4170),
    "6 flash, olmo-1b's train shape": (
        kernels.flash_attention(8, 16, 16, 2048, 128, 2, with_lse=True), 0.1390),
    "9 flash backward (8, 14 -> 2, 2048, 64)": (
        kernels.flash_attention_bwd(8, 14, 2, 2048, 64, 2), 0.1521),
    "9 flash backward, olmo-1b's": (kernels.flash_attention_bwd(8, 16, 16, 2048, 128, 2), 0.3476),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_kernel_bounds_equal_the_kernel_table(row):
    work, bound_ms = ROWS[row]
    assert round(1e3 * work.bound_s(), 4) == bound_ms


def test_visible_pairs():
    assert kernels.visible_pairs(4, 0) == 10
    assert kernels.visible_pairs(4, 2) == 3 + 2 * 2
    assert kernels.visible_pairs(4, 0, causal=False) == 16
    assert math.isclose(kernels.Work({"f32": 67e12}).bound_s(), 1.0)
