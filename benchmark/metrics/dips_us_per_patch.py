"""DIPs seconds of a tile over the patches it describes (one per voxel in
fusion, one per point in F2S3), in microseconds."""


def read(run):
    s = run.stage_s("dips_features")
    patches = run.count("patches") / len(run.tiles)
    return None if s is None or not patches else s / patches * 1e6
