"""Mean `permon` `optimize_pose` span (the pose's GN loop and its inlier
strip) per tracked frame of the window."""


def read(rec):
    v = [1e3 * f["t_optimize_pose"] for f in rec["permon"]
         if "t_optimize_pose" in f]
    return sum(v) / len(v) if v else None
