"""Host seconds of the port's graph stages at set-up: the degree
relabel (`graph.relabel`), GCN's normalisation (`graph.normalise`) and
R-GCN's folded relation norm (`plan.fold`)."""
from portbench.lib.spans import stage_s


def read(ctx):
    return stage_s(ctx, ["graph.relabel", "graph.normalise", "plan.fold"])
