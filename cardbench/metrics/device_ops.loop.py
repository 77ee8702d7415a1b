"""Device activities an MPC period (kernels, copies, fills of the replayed
graph.StepGraph), a count from the trace."""


def read(ctx):
    if not ctx.events:
        return None
    return len(ctx.events) / ctx.units
