"""Kernel launches (cudaLaunchKernel, cuLaunchKernel, cuLaunchKernelEx in
the profiler's trace) over the traced slices / frames in them."""


def read(rec):
    n = sum(s["frames"] for s in rec["slices"])
    return sum(s["launches"] for s in rec["slices"]) / n if n else None
