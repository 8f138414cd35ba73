"""Run chosen phases of ``chip_smoke.py`` alone, in the order given, in one
process on one card — a short call to time a phase apart from the ones
before it in the full script.

    python3 tools/chip_phases.py phase_slice phase_transport phase_slice
    python3 tools/chip_phases.py phase_obs      # phase 18 alone
    python3 tools/chip_phases.py phase_cost     # phase 19 alone: the cost model
    python3 tools/chip_phases.py phase_examples # phase 20 alone: the examples
    python3 tools/chip_phases.py phase_fsdp     # phase 21 alone: FSDP, MoE over ranks
    python3 tools/chip_phases.py phase_tp       # phase 22 alone: TP and EP over "model"
    python3 tools/chip_phases.py phase_serve_tp # phase 23 alone: serving over "model"

``phase_card`` and ``phase_build`` always run first (the card's name and
power limit, every kernel built). Each phase prints as in the full script,
then its own wall time; a failing check exits non-zero, as there.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(names) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch import device

    device.resolve("cuda")
    for name in ["phase_card", "phase_build", *names]:
        t = time.perf_counter()
        getattr(chip_smoke, name)()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
