"""Mean `permon` `drain_wait` span (the wait for a drain window's copy
to the host and its unpacking, inside `fetch`) per pipelined add_image
call of the window, calls that complete no drain counting 0. Near 0: the
card finished before the host asked; large: the host waits on the card."""


def read(rec):
    v = [1e3 * f.get("t_drain_wait", 0.0) for f in rec["permon"]
         if "n_inflight" in f]
    return sum(v) / len(v) if v else None
