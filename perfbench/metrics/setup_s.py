"""Process start to the first request of the window: imports, CUDA
initialisation, the kernels' build or load, the weights, the deployment
and the warm-up of every batch bucket the traffic can use."""
UNIT = "s"


def read(ctx):
    return ctx.setup_s
