"""Generated tokens emitted in the window (the prefills' first tokens and
every decode step's) per second of the window; prefills fall inside it."""


def read(r):
    if "serve_tokens" not in r:
        return None
    return r["serve_tokens"] / r["window_s"]
