"""``fit_s`` (s): the window's completed fits' summed wall time over
their count. A fit is timed from the call to ``fit`` until its factors
are on the card and synchronized: the estimator's host work, the
densify or the dense mask, the init and every sweep. Host clock."""


def read(run):
    if not run.fits:
        return None
    return sum(f.wall_s for f in run.fits) / len(run.fits)
