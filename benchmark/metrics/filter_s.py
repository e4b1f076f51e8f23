"""Seconds per tile of F2S3's learned filter and its rigid re-fits."""


def read(run):
    return run.stage_s("filter")
