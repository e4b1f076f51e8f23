"""Share of the traced window in which nothing ran on the device, in
percent."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0
