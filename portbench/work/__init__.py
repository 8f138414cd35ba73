"""The benchmark's frozen work arithmetic: each configuration's model FLOPs
and each timed kernel's operations and bytes as functions of a call's
shapes, and one H100's published peaks.

A frozen copy, so the yardstick does not move when the program changes:
the kernel costs are those of ``repro_torch/kernels/*.py``'s ``*_cost``
functions and the peaks those of ``repro_torch/launch/hw.py``, written out
here and never imported from the program.
"""
