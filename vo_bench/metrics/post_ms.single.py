"""Mean self time of the `permon` `post_fused` span (the host's
bookkeeping after the tracked-frame step) per tracked frame of the
window: `post_fused` less the `keyframe_path` inside it."""


def read(rec):
    v = [1e3 * (f["t_post_fused"] - f.get("t_keyframe_path", 0.0))
         for f in rec["permon"] if "t_post_fused" in f]
    return sum(v) / len(v) if v else None
