"""Seconds per tile of the RGB channel (projection, pixel chaining, gate)."""


def read(run):
    return run.stage_s("rgb_2d")
