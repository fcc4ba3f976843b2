"""The plan's own count of its device bytes
(`PreparedPlan.held_bytes`: every tensor it holds), in GiB."""


def read(ctx):
    return ctx.plan_bytes / 2 ** 30 if ctx.plan_bytes else None
