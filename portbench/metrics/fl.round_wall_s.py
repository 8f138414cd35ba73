"""The round's wall, s: the measured window over the rounds completed in
it (the host's clock, the card synchronised at both ends of every round),
time to an accuracy being rounds × this. The host paces these rounds, and
its speed drifts from run to run on a shared host, so it is read here and
not held to a bound."""


def read(ctx):
    return ctx["window_s"] / len(ctx["rows"])
