"""Process start to the first timed frame: the kernels' build or load,
rendering, the program's set-up, bootstrap and warm-up."""


def read(rec):
    return rec["setup_s"]
