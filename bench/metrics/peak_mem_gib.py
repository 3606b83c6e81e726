"""The window's peak of allocated device memory (`max_memory_allocated`
after a reset at the window's start), in GiB."""

UNIT = "GiB"
LAYER = "device"
MOVES = "neuron_steps_per_s"


def read(ctx):
    peak = ctx.get("peak_bytes")
    if not peak:
        return None
    return peak / 2 ** 30
