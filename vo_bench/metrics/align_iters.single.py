"""Mean `permon` counter `align_iters` (the alignment's GN iterations,
summed over the pyramid levels) per tracked frame of the window."""


def read(rec):
    v = [f["n_align_iters"] for f in rec["permon"]
         if "n_align_iters" in f and "t_device_step" in f]
    return sum(v) / len(v) if v else None
