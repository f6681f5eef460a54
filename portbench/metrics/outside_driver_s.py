"""``outside_driver_s`` (s), layer "estimator and input handling": a
fit's wall time minus the driver's last stamp, summed over the window's
fits over their count. It holds the estimator's host work, the input
handling before the driver starts its clock (the densify, the dense
mask), what follows the last kept sweep (the final W projection; a
rolled-back sweep and its score) and the return. Host clock."""


def read(run):
    fits = [f for f in run.fits if f.stamps]
    if not fits:
        return None
    return sum(f.wall_s - f.stamps[-1] for f in fits) / len(fits)
