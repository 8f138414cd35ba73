"""The plain reference the benchmark holds the program's outputs against:
plain PyTorch and NumPy, f32 with TF32 off, written from the published
descriptions. It imports nothing of the program (``repro_torch``) nor of
the JAX package, and takes only what the benchmark makes from the seed
(``portbench.inputs``): whatever the program derived from those inputs
(selections, deadlines, minibatches) it works out again. The program's
outputs it reads only to judge them, as the forest's first-round client
rows, which its own tiers aggregate to judge the program's update."""
