"""Kernel libraries nvcc built in the run (`build.compiled`, counted by
`repro_torch.kernels._build.build_all`): 7 on a checkout's first run, 0
on every later one."""
from portbench.lib.spans import counter


def read(ctx):
    return counter(ctx, "build.compiled")
