"""Set-up: process start to the first timed operation (imports, building
or loading the kernels, making the inputs and weights, warm-up)."""


def read(r):
    return r.get("setup_s")
