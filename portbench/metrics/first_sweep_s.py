"""``first_sweep_s`` (s), layer "init": the driver's first stamp, the
mean over the window's fits: the init (NNDSVD's randomized SVD) and the
first sweep with its CUDA graph capture. Host clock."""


def read(run):
    fits = [f for f in run.fits if f.stamps]
    if not fits:
        return None
    return sum(f.stamps[0] for f in fits) / len(fits)
