"""The rest of a round, ms: each round's wall (``wall_s``) less the
backend's train, aggregate and eval spans, averaged over the measured
window: selection, the PON transport simulation, the minibatch draws and
their copy to the card, the server step and the loop's bookkeeping."""


def read(ctx):
    rows = ctx["rows"]
    rest = sum(r["wall_s"] - r.get("train_host_s", 0.0) - r.get("aggregate_host_s", 0.0)
               for r in rows) - ctx["eval_s"]
    return 1e3 * rest / len(rows)
