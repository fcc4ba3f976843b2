"""Host seconds of the port's kernel build at the start of the run: the
nvcc build on a checkout's first run, the look-up of the built kernels
on every later one.  It is part of `setup_s`; read apart, it shows what
a run that compiled spent on compiling."""


def read(ctx):
    return ctx.build_s
