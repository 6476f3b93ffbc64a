"""Mean `permon` `mt_delta` span (packing the map's queued changes into
one delta blob and its upload) per chained pipelined dispatch of the
window."""


def read(rec):
    v = [1e3 * f["t_mt_delta"] for f in rec["permon"] if "t_mt_delta" in f]
    return sum(v) / len(v) if v else None
