"""Failed 16x16 solves an MPC period of the articulated loop, summed over
the lanes: the lane-solves whose factorisation plant.whole_body.step
counts as failed (``whole_body.solve_counts()``, on the device, over every
substep of the run so far: the set-up's, the window's and the traced
ones), over the periods those lane-solves make (lane-solves / lanes /
substeps a period).  None where the program keeps no such count or ran
no solve."""


def read(ctx):
    from hector_torch.plant import whole_body as WB
    counts = getattr(WB, 'solve_counts', None)
    lanes = ctx.work.get('lanes')
    substeps = ctx.work.get('plant_substeps')
    if counts is None or not lanes or not substeps:
        return None
    solves, failed = counts()
    if not solves:
        return None
    return failed / (solves / (lanes * substeps))
