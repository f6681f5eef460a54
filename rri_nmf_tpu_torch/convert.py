"""Carry fitted state from numpy (e.g. a fitted :mod:`rri_nmf_tpu`
estimator's ``W``/``T``) into the port's tensors.

The JAX package's results are numpy arrays; these helpers place them on
a device in the port's dtype policy, so a model fitted with either
package transforms and scores new data the same way in the other.
:meth:`rri_nmf_tpu_torch.sklearn_interface.NMF_TM_Estimator.
from_numpy_state` builds a whole estimator from them.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import as_tensor, default_float


def factors_from_numpy(W, T, device=None, dtype=None):
    """``(W, T)`` as tensors on ``device`` (default: the CPU) in ``dtype``
    (default: the device's default float)."""
    device = torch.device(device) if device is not None \
        else torch.device('cpu')
    dtype = dtype if dtype is not None else default_float(device)
    return (as_tensor(np.asarray(W), device=device, dtype=dtype),
            as_tensor(np.asarray(T), device=device, dtype=dtype))
