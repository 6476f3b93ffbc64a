"""Mean over the window's tracked frames of the program's own host spans
`device_step` (enqueue of the fused step) + `fetch` (the wait for its
results), from `FrameHandlerMono.permon`."""


def read(rec):
    v = [1e3 * (f["t_device_step"] + f.get("t_fetch", 0.0))
         for f in rec["permon"] if "t_device_step" in f]
    return sum(v) / len(v) if v else None
