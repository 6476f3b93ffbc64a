"""Mean `permon` `sparse_img_align` span (the alignment's inputs and its
GN loop over the pyramid levels: enqueue plus the host syncs inside it)
per tracked frame of the window."""


def read(rec):
    v = [1e3 * f["t_sparse_img_align"] for f in rec["permon"]
         if "t_sparse_img_align" in f]
    return sum(v) / len(v) if v else None
