"""Device milliseconds per tile of the three hand-written kernels."""


def read(run):
    t = sum(run.trace["kernels_s"].values()) if run.trace else 0.0
    return t / len(run.tiles) * 1e3 if t > 0 else None
