"""Mean fine WV sweeps a column ran while active, over the window's
deploys (`DeployReport.mean_iterations`, weighted by columns; fetched by
each deploy's one sync).  Moves `deploy_cells_per_s`."""


def read(ctx):
    if ctx["kind"] != "deploy":
        return None
    d = ctx["deploys"]
    return sum(x["mean_iterations"] * x["columns"] for x in d) / sum(x["columns"] for x in d)
