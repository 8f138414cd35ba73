"""repro_torch.pon — the PON transport, port of ``repro.pon`` (numpy and
plain Python, no torch): the round timing and its closed form, topologies,
DBA policies, background traffic, the event simulator, the metro forest
and the fast/hybrid engines."""
from repro_torch.pon.timing import (
    MODEL_UPDATE_MBITS,
    SLICE_MBPS,
    SYNC_THRESHOLD_S,
    PonConfig,
    add_pon_cli_args,
    pon_config_from_args,
    round_times,
    round_times_fifo,
    train_times,
)
from repro_torch.pon.topology import Onu, Topology, Wavelength
from repro_torch.pon.dba import (
    DBA_POLICIES,
    DbaPolicy,
    FifoDba,
    FlPriorityDba,
    IpactDba,
    TdmaDba,
    make_dba,
)
from repro_torch.pon.traffic import BackgroundTraffic
from repro_torch.pon.events import UpstreamJob, simulate_round, simulate_upstream
from repro_torch.pon.metro import (
    MetroTopology,
    expected_segment_mbits,
    simulate_hier_round,
)
from repro_torch.pon.fast import (
    SIM_ENGINES,
    simulate_hier_round_fast,
    simulate_round_fast,
)

__all__ = [
    "PonConfig", "add_pon_cli_args", "pon_config_from_args",
    "round_times", "round_times_fifo", "train_times",
    "MODEL_UPDATE_MBITS", "SLICE_MBPS", "SYNC_THRESHOLD_S",
    "Onu", "Topology", "Wavelength",
    "DBA_POLICIES", "DbaPolicy", "FifoDba", "FlPriorityDba", "IpactDba",
    "TdmaDba", "make_dba",
    "BackgroundTraffic",
    "UpstreamJob", "simulate_round", "simulate_upstream",
    "MetroTopology", "expected_segment_mbits", "simulate_hier_round",
    "SIM_ENGINES", "simulate_hier_round_fast", "simulate_round_fast",
]
