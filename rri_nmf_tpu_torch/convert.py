"""Carry fitted state from numpy (e.g. a fitted :mod:`rri_nmf_tpu`
estimator's ``W``/``T``, or a quantized X's int16 code and scale) into
the port's tensors.

The JAX package's results are numpy arrays; these helpers place them on
a device in the port's dtype policy, so a model fitted with either
package transforms, predicts and scores new data the same way in the
other. :func:`numpy_state` reads a fitted estimator of either package
into numpy, and ``from_numpy_state`` of
:class:`~rri_nmf_tpu_torch.sklearn_interface.NMF_TM_Estimator` and
:class:`~rri_nmf_tpu_torch.sklearn_interface.NMF_RS_Estimator` builds a
whole estimator from that.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import as_tensor, default_float, fit_device


def quantized_from_numpy(q, s, device=None):
    """A :class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` from the
    int16 code ``q`` (n, d) and the scale ``s`` (d,) as numpy arrays (a
    JAX package ``QuantizedX`` read with ``np.asarray``), on ``device``
    (default: the card; ``'cpu'`` for the CPU)."""
    from rri_nmf_tpu_torch.ops.quantized import QuantizedX
    device = fit_device(q, device)
    q = np.asarray(q)
    if q.dtype != np.int16 or q.ndim != 2 or np.shape(s) != q.shape[1:]:
        raise ValueError('expected an int16 (n, d) code and a (d,) scale, '
                         'got %s %s and %s' % (q.dtype, q.shape,
                                               np.shape(s)))
    return QuantizedX(torch.from_numpy(np.array(q)).to(device),
                      as_tensor(np.array(s), device=device))


def factors_from_numpy(W, T, device=None, dtype=None):
    """``(W, T)`` as tensors on ``device`` (default: the card for numpy
    factors, a tensor's own device; ``device='cpu'`` for the CPU) in
    ``dtype`` (default: the device's default float)."""
    device = fit_device(W, device)
    dtype = dtype if dtype is not None else default_float(device)
    return (as_tensor(np.asarray(W), device=device, dtype=dtype),
            as_tensor(np.asarray(T), device=device, dtype=dtype))


# the fitted attributes an estimator carries besides its constructor
# arguments: the factors, the TM estimator's idf, the RS estimator's
# rating range
STATE_KEYS = ('W', 'T', 'idf', 'min_rating', 'max_rating')


def numpy_state(est):
    """The fitted state of an estimator of either package — ``W``, ``T``
    and, where set, ``idf``, ``min_rating``, ``max_rating`` — as numpy
    values, ready for ``from_numpy_state``. Reads attributes only, so
    it needs neither package's imports."""
    out = {}
    for key in STATE_KEYS:
        v = getattr(est, key, None)
        if v is None:
            continue
        out[key] = v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    return out


def state_from_numpy(W, T, iteration, obj_history=(), resets_left=0,
                     random_state=0, obj_tracked=True, her=None,
                     es_score=None):
    """The port's :class:`~rri_nmf_tpu_torch.checkpoint.NMFState` from a
    JAX package checkpoint read as numpy: the factors, the iteration, the
    objective history, the reset budget, ``random_state``,
    ``obj_tracked``, the HER arrays (``Wy``, ``Ty``, ``beta``, ``e`` and,
    where present, ``Wb``, ``Tb``, ``eb``) and the early-stop score.
    Tensors stay on the CPU in their numpy dtypes; ``nmf()`` places them
    on the fit's device in its dtype when it resumes.

    The JAX PRNG key has no counterpart in a ``torch.Generator``, so the
    state carries no generator state: a fit resumed from it seeds its
    generator from ``random_state`` (only a ``'random'`` reset or DP noise
    draws from it). Save the state with
    :meth:`~rri_nmf_tpu_torch.checkpoint.NMFCheckpointer.save` and pass
    the directory as ``nmf(checkpoint=...)``."""
    from rri_nmf_tpu_torch.checkpoint import NMFState

    def tensor(a):
        return torch.as_tensor(np.array(a))
    return NMFState(
        W=tensor(W), T=tensor(T), iteration=int(iteration),
        obj_history=[float(o) for o in obj_history], generator_state=None,
        resets_left=int(resets_left), random_state=int(random_state),
        obj_tracked=bool(obj_tracked),
        her=(None if her is None
             else {k: tensor(v) for k, v in her.items()}),
        es_score=None if es_score is None else float(es_score))
