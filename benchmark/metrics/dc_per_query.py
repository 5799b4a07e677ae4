"""Mean rows scored per window query (SearchStats.distance_computations,
summed over shards by the sharded entry). The delta engines only."""


def read(run):
    if run.dc is None or run.cell.traffic["mode"] != "lsh":
        return None
    return float(run.dc.mean())
