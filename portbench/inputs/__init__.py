"""What the benchmark makes from ``--seed`` and hands to both the program
and the plain reference: the federated clients' data, the initial weights
(drawn on the card in the type they are trained in), the per-client
sample counts and the stochastic-rounding noise. Nothing here imports the
program."""
