"""One module a kind of cell; ``workloads/<cell>.json`` names its driver.
Each has ``run(cell, seed, seconds, trace, device, t0) -> Outcome``."""
