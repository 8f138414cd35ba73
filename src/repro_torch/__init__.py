"""repro_torch: the PyTorch/CUDA port of the SFL-over-PON system.

A second package beside the JAX reference ``repro``, with the same module
layout and names so each module's counterpart is easy to find. It imports
``torch``, numpy and scipy only — never ``jax`` and nothing of ``repro``;
the numpy-only modules it needs are kept here as copies.

This slice runs the paper's synchronous round (``fl.RoundLoop`` with the
``sfl_two_step`` and ``classical`` strategies) on the FEMNIST CNN; both
aggregations go through the hand-written CUDA kernel in
``kernels/csrc/agg_reduce.cu``. Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
