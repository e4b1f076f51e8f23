"""Seconds per tile of F2S3's feature-space 1-NN (kernel 3)."""


def read(run):
    return run.stage_s("feature_nn1")
