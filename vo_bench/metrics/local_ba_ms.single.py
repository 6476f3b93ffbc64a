"""Mean `permon` `local_ba` span per local BA solve of the window."""


def read(rec):
    v = [1e3 * f["t_local_ba"] for f in rec["permon"] if "t_local_ba" in f]
    return sum(v) / len(v) if v else None
