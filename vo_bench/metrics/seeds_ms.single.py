"""Mean `permon` `update_seeds` span (the depth filter's seed update and
the packing of its converged rows) per tracked frame of the window."""


def read(rec):
    v = [1e3 * f["t_update_seeds"] for f in rec["permon"]
         if "t_update_seeds" in f]
    return sum(v) / len(v) if v else None
