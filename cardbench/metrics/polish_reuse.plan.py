"""The share of the polish's steps that re-solved on saved factors, in %:
100 x the polish steps ``fused_riccati_warp_kernel<true>`` ran only the
linear half of the Riccati sweep for, on the factors of an earlier step
with the same active sets / every polish step it ran, both as the kernel
counts them (``fused_riccati.polish_step_counts()``), over every launch of
the run so far: the set-up's, the window's and the traced ones.  None where
the kernel never ran, or where the program keeps no such counts."""


def read(ctx):
    from hector_torch.qp import fused_riccati as FR
    counts = getattr(FR, 'polish_step_counts', None)
    if counts is None:
        return None
    steps, resolved = counts()
    if not steps:
        return None
    return 100.0 * resolved / steps
