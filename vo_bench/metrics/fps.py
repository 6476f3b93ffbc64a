"""Frames delivered in DEFAULT over the whole measured window's wall time
(every stream's frames; a batched window ends with flush() inside it)."""


def read(rec):
    return rec["ok_frames"] / rec["window_s"] if rec["window_s"] > 0 else None
