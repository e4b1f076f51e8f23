"""Candidates that kernel 3's (``knn``) certified filter passed to the
exact rescoring, per query row, over the window's launches (the program's
counters, ``timings["counters"]``); None where no tile launched it."""


def read(run):
    counted = [tile["timings"]["counters"] for tile in run.tiles
               if tile["timings"].get("counters", {}).get("knn.rows")]
    if not counted:
        return None
    return (sum(c["knn.rescored"] for c in counted)
            / sum(c["knn.rows"] for c in counted))
