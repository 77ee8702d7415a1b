"""The card's idle share a planning step, in %: 1 - (the union of device
activity in the traced steps, a step) / (the wall time a step of the
window just before, unprofiled)."""
from cardbench.yardstick import trace as T


def read(ctx):
    return T.idle_percent(ctx)
