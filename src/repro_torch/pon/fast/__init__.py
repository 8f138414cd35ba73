"""repro_torch.pon.fast — array-native upstream simulation, port of
``repro.pon.fast`` (numpy).

Three engines behind ``PonConfig.sim_engine`` / ``--sim-engine``:

  * ``event``  — the exact discrete-event heap (``pon.events``);
  * ``fast``   — vectorized schedules wherever they are bit-exact
    (dedicated service, FIFO packing), exact event fallback otherwise;
  * ``hybrid`` — additionally serves unpackable, *uncongested* PONs
    with the closed-form fluid model (``fluid_congested`` is the flag;
    ``ipact`` always stays on the exact sim).

``events.simulate_round`` / ``metro.simulate_hier_round`` dispatch here
when ``cfg.sim_engine != "event"``. The reference's fluid grant machine
for its incremental driver (``fast/fluid.py``) comes with the runtime
(ROADMAP.md Queue 1 item 4).
"""
from repro_torch.pon.fast.engine import (
    SIM_ENGINES,
    fluid_congested,
    serve_queued,
    simulate_round_fast,
    uniform_onu_rate,
)
from repro_torch.pon.fast.hier import simulate_hier_round_fast
from repro_torch.pon.fast.segments import fifo_pack, segment_max, segment_sum

__all__ = [
    "SIM_ENGINES",
    "fifo_pack",
    "fluid_congested",
    "segment_max",
    "segment_sum",
    "serve_queued",
    "simulate_hier_round_fast",
    "simulate_round_fast",
    "uniform_onu_rate",
]
