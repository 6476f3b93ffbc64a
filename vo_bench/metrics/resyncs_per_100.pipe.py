"""`permon` counter `mt_resync` (a dispatch that restarts the device map
carry from a full upload instead of a delta blob) per 100 pipelined
dispatches of the window."""


def read(rec):
    v = [f["n_mt_resync"] for f in rec["permon"] if "n_mt_resync" in f]
    return 100.0 * sum(v) / len(v) if v else None
