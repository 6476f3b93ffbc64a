"""Mean `permon` counter `pose_iters` (the pose's GN iterations, its
refinement pass included) per tracked frame of the window."""


def read(rec):
    v = [f["n_pose_iters"] for f in rec["permon"]
         if "n_pose_iters" in f and "t_device_step" in f]
    return sum(v) / len(v) if v else None
