"""Host seconds of the port's set-up calls: the degree relabel, the
normalisation, the layers and `prepare_graph` (for training, the
trainer, which prepares its plan)."""


def read(ctx):
    return ctx.prepare_s
