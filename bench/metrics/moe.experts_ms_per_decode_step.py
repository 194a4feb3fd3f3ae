"""Device milliseconds of the routed experts (K6, the grouped expert
kernel: two kernels a MoE layer) per decode step, from the driver's
profiled decode steps for K6."""


def read(r):
    k = r.get("k6")
    if not k or not k["device_s"]:
        return None
    return 1e3 * k["device_s"] / k["steps"]
