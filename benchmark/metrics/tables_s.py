"""Seconds per tile of the result tables: forming them and waiting for
their writer."""


def read(run):
    return run.stage_s("dense_output", "write_tables", "tables")
