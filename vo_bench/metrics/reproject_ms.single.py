"""Mean `permon` `reproject` span (the map's reprojection and its K2
refinement; K2 is waited for in the next stage's first sync) per tracked
frame of the window."""


def read(rec):
    v = [1e3 * f["t_reproject"] for f in rec["permon"] if "t_reproject" in f]
    return sum(v) / len(v) if v else None
