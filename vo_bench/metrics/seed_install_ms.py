"""Mean `permon` `seed_install` span (new point and line seeds written
into the seed tables from a keyframe's fetched detection) per add_image
call that installs seeds: one keyframe's in the sync path, inside
`kf_init_seeds`; in the pipelined path a drain's, which at depth 1 holds
one keyframe's as a rule."""


def read(rec):
    v = [1e3 * f["t_seed_install"] for f in rec["permon"]
         if "t_seed_install" in f]
    return sum(v) / len(v) if v else None
