"""Bytes the collectives move per activity step, as the port counts them
(`dist.<op>.bytes` of `launch/mesh.py`'s `Group`: a gather's whole output,
a merge's input) in the traced `bench.activity` chunks, over those chunks'
steps.  Rank 0's counters."""
UNIT = "bytes"
LAYER = "collectives (launch/mesh.py, core/distributed.py)"
MOVES = "activity_step_ms"
KIND = "bench.activity"


def read(ctx):
    counts, rec = ctx.get("counts"), ctx.get("profile")
    if not counts or not rec:
        return None
    c = counts.get(KIND, {})
    steps = sum(s for k, s in rec["chunk_steps"] if k == KIND)
    moved = sum(v for k, v in c.items() if k.startswith("dist.") and k.endswith(".bytes"))
    if not steps or not any(k.startswith("dist.") for k in c):
        return None
    return moved / steps
