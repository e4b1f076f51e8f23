"""Seconds per tile of the magnitude-gated global 3D match."""


def read(run):
    return run.stage_s("global_3d_matches")
