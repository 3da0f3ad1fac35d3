"""Kernel launches per EM iteration: ops/fb_kernels.LAUNCHES over the
window (the plain versions on a CPU count none)."""


def read(readings):
    n, it = readings.get("launches"), readings.get("iterations")
    return n / it if n and it else None
