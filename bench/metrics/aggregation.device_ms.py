"""Device time of the aggregations per epoch: the device intervals of the
program's ``agg`` spans (each layer's SpMM over the table, and over the
transposed CSR in the backward), summed over the window's epochs."""


def read(run):
    aggs = [ev for ev in run.spans if ev["name"] == "agg" and "ddur" in ev]
    if not aggs:
        return None
    return sum(ev["ddur"] for ev in aggs) / run.n_epochs * 1e3
