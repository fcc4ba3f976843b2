"""Host seconds of `prepare_graph`'s tile-format choice (`plan.format`)
and its carriers: the bucket groups, or the typed route's flat entries
and relation column (`plan.groups`)."""
from portbench.lib.spans import stage_s


def read(ctx):
    return stage_s(ctx, ["plan.format", "plan.groups"])
