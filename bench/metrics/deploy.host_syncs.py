"""Host syncs a deploy made: the program's counter
(`pipeline.host_sync_count()`) read before and after each deploy of
the window, averaged.  Moves `deploy_cells_per_s`."""


def read(ctx):
    if ctx["kind"] != "deploy":
        return None
    d = ctx["deploys"]
    return sum(x["syncs"] for x in d) / len(d)
