"""Tokens of every train step in the window (batch x sequence) per second
of the window; ingest, overlap waits and stalls all count."""


def read(r):
    if "train_steps" not in r:
        return None
    return r["train_steps"] * r["tokens_per_step"] / r["window_s"]
