"""Message bytes delivered unpacked into host memory, for every message
whose completion the host polled in the window, per second of the window
(headers and ACKs not counted)."""


def read(r):
    if "messages_done" not in r:
        return None
    return r["messages_done"] * r["msg_bytes"] / r["window_s"] / 1e6
