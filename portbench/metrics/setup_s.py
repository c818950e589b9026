"""Set-up: process start to the first timed request (imports, the CUDA
context, loading or building the kernel library, making the weights,
warming the traffic's shapes). Host clock."""


def read(ctx):
    return ctx.setup_s
