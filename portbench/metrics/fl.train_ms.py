"""Local training's host ms a round: the program's ``backend.train_s``
spans (card synchronised at both ends) summed over the measured window's
rounds, over the rounds."""


def read(ctx):
    rows = ctx["rows"]
    return 1e3 * sum(r.get("train_host_s", 0.0) for r in rows) / len(rows)
