"""Checkpoint / resume of an ``nmf()`` fit.

Counterpart of :mod:`rri_nmf_tpu.checkpoint`, built on ``torch.save`` and
``torch.load(weights_only=True)`` (no other serialization library is
needed). :class:`NMFState` is the whole resumable state of a fit — the
factors, the iteration, the objective history, the reset budget, the HER
extrapolation state and the early-stop score — with the fit's
``torch.Generator`` state and its device type in place of the JAX PRNG
key. :class:`NMFCheckpointer` keeps the last ``keep`` states of a
directory, one file a step, each written atomically.

``nmf(checkpoint=...)`` resumes from the latest step and saves every
``checkpoint_every`` sweeps; a resumed fit equals the straight one. On a
mesh the first rank writes and the first rank reads: :func:`restore_shared`
sends what it restored, or that it found nothing, to every rank, so the
whole mesh takes one branch even where the ranks see different
directories (as JAX's orbax restore is one collective operation).
"""

import dataclasses
import os
import pickle
import re
from typing import Any, Optional

import torch

_STEP_FILE = re.compile(r'^step_(\d+)\.pt$')


def _host(a):
    return a.detach().cpu() if isinstance(a, torch.Tensor) else a


@dataclasses.dataclass
class NMFState:
    """The complete resumable state of an ``nmf()`` fit.

    ``generator_state`` is the fit's ``torch.Generator`` state
    (:meth:`rri_nmf_tpu_torch.ops.sweep.GeneratorDraws.get_state`) and
    ``generator_device`` the device type it belongs to; both are None for
    a state that carries none (one converted from the JAX package,
    :func:`rri_nmf_tpu_torch.convert.state_from_numpy`). ``obj_tracked``
    records whether the writing fit tracked the objective (a grouped fit
    does not, so its history is empty by construction). ``her`` holds the
    HER state — ``Wy``/``Ty`` (extrapolated factors), ``beta``, ``e``
    (the last accepted objective) and ``Wb``/``Tb``/``eb`` (the best
    accepted iterate) — when the writing fit extrapolated, and
    ``es_score`` the early-stop comparison score."""
    W: Any
    T: Any
    iteration: int
    obj_history: list
    generator_state: Optional[torch.Tensor]
    resets_left: int
    random_state: int
    obj_tracked: bool = True
    her: Optional[dict] = None
    es_score: Optional[float] = None
    generator_device: Optional[str] = None

    def tree(self):
        """The state as a dict of tensors and plain values on the host,
        as ``torch.save`` writes it."""
        return {
            'W': _host(self.W), 'T': _host(self.T),
            'iteration': int(self.iteration),
            'obj_history': [float(o) for o in self.obj_history],
            'generator_state': _host(self.generator_state),
            'generator_device': self.generator_device,
            'resets_left': int(self.resets_left),
            'random_state': int(self.random_state),
            'obj_tracked': bool(self.obj_tracked),
            'her': (None if self.her is None
                    else {k: _host(v) for k, v in self.her.items()}),
            'es_score': (None if self.es_score is None
                         else float(self.es_score)),
        }

    @classmethod
    def from_tree(cls, tree, device=None):
        """The state of :meth:`tree`, its factors (and the HER tensors)
        moved to ``device`` when given."""
        def place(a):
            return a.to(device) if device is not None else a
        her = tree.get('her')
        return cls(
            W=place(tree['W']), T=place(tree['T']),
            iteration=int(tree['iteration']),
            obj_history=list(tree['obj_history']),
            generator_state=tree.get('generator_state'),
            resets_left=int(tree['resets_left']),
            random_state=int(tree['random_state']),
            obj_tracked=bool(tree.get('obj_tracked', True)),
            her=(None if her is None
                 else {k: place(v) for k, v in her.items()}),
            es_score=tree.get('es_score'),
            generator_device=tree.get('generator_device'))


class NMFCheckpointer(object):
    """Checkpoints of a fit in ``directory``, one file a step
    (``step_<n>.pt``), the last ``keep`` kept.

    Usage::

        ckpt = NMFCheckpointer('ckpts', keep=3)
        ckpt.save(step, state)          # written before it returns
        state = ckpt.restore()          # the latest, or restore(step)

    A save writes a temporary file in the directory and renames it over
    the step's file (``os.replace``), so a fit killed mid-save leaves the
    previous steps whole. Saves are synchronous: ``wait`` and
    :meth:`close` exist for the JAX package's interface and do nothing
    more."""

    def __init__(self, directory, keep=3):
        self.directory = str(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, 'step_%d.pt' % int(step))

    def steps(self):
        """The steps on disk, in ascending order."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step, state, wait=False):
        path = self._path(step)
        tmp = '%s.tmp%d' % (path, os.getpid())
        torch.save(state.tree(), tmp)
        os.replace(tmp, path)
        if self.keep > 0:
            for old in self.steps()[:-self.keep]:
                os.remove(self._path(old))

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step=None, device=None):
        """The state of ``step`` (default: the latest), or None when the
        directory holds none. The factors and HER tensors are placed on
        ``device`` when given (``nmf()`` passes the fit's device)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        tree = torch.load(self._path(step), map_location='cpu',
                          weights_only=True)
        return NMFState.from_tree(tree, device=device)

    def close(self):
        pass


# a tensor of more entries than this crosses as a tensor of its own shape
# (the factors, HER's factor-sized state); the rest rides one byte buffer
_INLINE = 1 << 12


def _pack(tree, big):
    if isinstance(tree, torch.Tensor) and tree.numel() > _INLINE:
        big.append(tree)
        return ('__tensor__', len(big) - 1, tuple(tree.shape),
                str(tree.dtype).split('.')[-1])
    if isinstance(tree, dict):
        return {k: _pack(v, big) for k, v in tree.items()}
    return tree


def _unpack(tree, big):
    if isinstance(tree, tuple) and tree and tree[0] == '__tensor__':
        return big[tree[1]]
    if isinstance(tree, dict):
        return {k: _unpack(v, big) for k, v in tree.items()}
    return tree


def restore_shared(ckpt, mesh, device):
    """The latest state of the first rank's (coordinate (0, 0))
    checkpointer, on every rank of ``mesh``, or None on every rank when
    the first rank finds none; the other ranks' ``ckpt`` is not read.
    The tensors of more than a few thousand entries cross as tensors of
    their shape on ``device`` (:meth:`Mesh.from_first`); the rest (the
    step, the history, the generator state, the reset budget, HER's
    scalars, the early-stop score) as one pickled byte buffer on the
    mesh's control device, after its length (0: no checkpoint). Every
    rank of the mesh calls it together."""
    first = mesh.member() == (0, 0)
    ctrl = mesh.control_device(device)
    header, big = b'', []
    if first:
        step = ckpt.latest_step()
        if step is not None:
            tree = torch.load(ckpt._path(step), map_location='cpu',
                              weights_only=True)
            skeleton = _pack(tree, big)
            header = pickle.dumps((skeleton, [(tuple(t.shape), t.dtype)
                                              for t in big]))
    size = int(mesh.from_first(torch.tensor(
        [len(header)], dtype=torch.int64, device=ctrl))[0])
    if size == 0:
        return None
    buf = (torch.frombuffer(bytearray(header), dtype=torch.uint8).to(ctrl)
           if first else torch.zeros(size, dtype=torch.uint8, device=ctrl))
    skeleton, specs = pickle.loads(
        mesh.from_first(buf).cpu().numpy().tobytes())
    big = [mesh.from_first(big[i].to(device) if first else
                           torch.zeros(shape, dtype=dtype, device=device))
           for i, (shape, dtype) in enumerate(specs)]
    return NMFState.from_tree(_unpack(skeleton, big), device=device)
