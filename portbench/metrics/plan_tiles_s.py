"""Host seconds of `prepare_graph`'s tile store (`plan.tiles`) and its
packing, which merges repeated entries (`plan.pack`)."""
from portbench.lib.spans import stage_s


def read(ctx):
    return stage_s(ctx, ["plan.tiles", "plan.pack"])
