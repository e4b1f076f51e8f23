"""Operations of the networks the window ran (``flops.py``), over the
window and the TF32 peak, in percent."""


def read(run):
    ops = run.count("flops")
    return ops / (run.window_s * run.peaks["tf32_flops"]) * 100.0 if ops else None
