"""The paper's overlap ratio over the window, R = T_MM / (T_MM + T_Poll),
from ``core/overlap.overlapped_loop``'s report: the share of the host's
waiting that was for the train step and not for the ingest."""


def read(r):
    return r.get("overlap_R")
