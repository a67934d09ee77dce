"""Kernel launch calls on the host (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaLaunchKernelExC``) in the traced part of the
window, over the requests that completed in it."""
UNIT = "launches/req"
MOVES = "throughput"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    n = ctx.requests_done_in_profile()
    return p.launches / n if n else None
