"""Pyramid rows the routed exchange fetches per network update on rank 0:
the port's counter `dist.exchange.rows` (`core/distributed.py`, the
interaction rows of the rank's source boxes below the shared levels) in
the traced `bench.update` chunks, over the updates they ran
(`update.networks`)."""
UNIT = "rows"
LAYER = "collectives (launch/mesh.py, core/distributed.py)"
MOVES = "update_ms"
KIND = "bench.update"


def read(ctx):
    counts = ctx.get("counts")
    if not counts:
        return None
    c = counts.get(KIND, {})
    if "dist.exchange.rows" not in c or not c.get("update.networks"):
        return None
    return c["dist.exchange.rows"] / c["update.networks"]
