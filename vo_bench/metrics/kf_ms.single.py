"""Mean `permon` `keyframe_path` span (K1 detection, segments, seed
install, local BA) per keyframe of the window."""


def read(rec):
    v = [1e3 * f["t_keyframe_path"] for f in rec["permon"]
         if "t_keyframe_path" in f]
    return sum(v) / len(v) if v else None
