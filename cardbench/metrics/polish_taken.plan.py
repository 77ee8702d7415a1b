"""The share of the polish's work that is kept, in %: 100 x (1 - the lanes
whose polish ``fused_riccati_warp_kernel<true>`` rejected, which fall back to
the interior point's iterate / the lanes it polished), both as the kernel
counts them (``fused_riccati.polish_counts()``), over every launch of the
run so far: the set-up's, the window's and the traced ones.  None where the
kernel never ran, or where the program keeps no such counts."""


def read(ctx):
    from hector_torch.qp import fused_riccati as FR
    counts = getattr(FR, 'polish_counts', None)
    if counts is None:
        return None
    lanes, rejected = counts()
    if not lanes:
        return None
    return 100.0 * (1.0 - rejected / lanes)
