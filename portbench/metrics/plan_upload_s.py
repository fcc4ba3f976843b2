"""Host seconds of the plan's arrays going to the card, the bucket
groups' work table with them (`plan.upload`)."""
from portbench.lib.spans import stage_s


def read(ctx):
    return stage_s(ctx, ["plan.upload"])
