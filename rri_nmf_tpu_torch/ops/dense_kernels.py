"""Dense phase sweep: torch GEMMs around two hand-written CUDA kernels.

Counterpart of :mod:`rri_nmf_tpu.ops.dense_pallas`. A phase-order sweep
updates all k rows of T, then all k columns of W; within a phase the
other factor is frozen, so its Gram (``WᵀW`` / ``TTᵀ``) and the numerator
panel (``WᵀX`` / ``TXᵀ``) are computed once with ``torch.matmul`` and the
sequential topic loop runs in one kernel launch:

- **B1, the Gauss-Seidel kernel** (``csrc/gs.cu``, wrapper
  :func:`gs_update`): both phases of a plain fit and the W-phase of a
  fixed-T transform. Columns are independent; the kernel takes topics in
  blocks of 16 with 16 lanes per column (the block's Gram corrections as
  independent dot products, then the short in-block chain).
- **B2, the projected T-phase kernel** (``csrc/tm_proj.cu``, wrapper
  :func:`tm_proj_update`): the T-phase when every T row is projected onto
  the ``t_row_sum`` simplex (the topic-model recipe). The simplex
  threshold couples all d columns of a row, so the kernel is one
  cooperative grid whose blocks own column slices, and every row-wide
  reduction is a grid barrier combined in a fixed order.

Each wrapper takes a CPU tensor to its plain PyTorch twin
(:func:`gs_update_ref`, :func:`tm_proj_update_ref`: a Python loop over
topics with the same arithmetic) and a CUDA tensor to its kernel — or
raises; nothing routes a CUDA tensor to a twin. ``LAUNCHES`` counts the
kernel launches of each wrapper.

**16-bit factors.** A bfloat16 or float16 factor ``F`` is stored in 16
bits and worked in float32, as the JAX package's kernels do: each kernel
(and twin) reads F into a float32 work tile, runs the topic loop there
against float32 ``G`` and ``N``, and rounds once, when it writes the
tile out (``dense_pallas.py`` ``_make_gs_kernel``'s scratch).

The sweep reaches X only through its two numerator products, which
:func:`make_dense_phase_sweep` takes as arguments: the sparse sweep
(:mod:`rri_nmf_tpu_torch.ops.sweep_sparse`) is this sweep with sparse
contractions. The dense products follow the JAX package's storage
rules (:func:`~rri_nmf_tpu_torch.ops.sweep.resolve_mixed_dtypes`): the
numerators and Grams are formed in the accumulator dtype, a bfloat16 X
under default precision meets its factor cast to bfloat16, and a
:class:`~rri_nmf_tpu_torch.ops.quantized.QuantizedX` (``x_dtype=
'int16'``) is read through its scale-folded products.

Unlike the TPU kernels nothing is padded: the (8, 128) tiles and the
BN/BD pad quanta were Mosaic's needs; the CUDA kernels mask their ragged
edge. The VMEM gates become each kernel's own shared-memory gate
(:func:`gs_fits`, :func:`tm_proj_fits`).

**On a mesh** (``cfg.mesh``; :mod:`rri_nmf_tpu_torch.parallel.
sharded_dense`) the sweep runs on this rank's blocks with four
all-reduces of small operands: ``WᵀW`` and ``WᵀX`` over ``dp``, ``TTᵀ``
and ``TXᵀ`` over ``tp``. T's columns are independent within the T-phase
and W's rows within the W-phase, so B1 on a rank's tile is the global
update restricted to it. B2's simplex threshold couples a whole row, so
its numerator and factor panels are gathered over ``tp``, B2 runs on the
whole (k, d) panel on every ``tp`` rank, and each keeps its columns.
"""

import dataclasses

import torch

from rri_nmf_tpu_torch.matrixops import EPS_DIV_BY_ZERO, _proj_simplex_core
from rri_nmf_tpu_torch.ops._build import (CTYPES, check_operands,
                                          device_fits, launch, load)
from rri_nmf_tpu_torch.ops.quantized import (NARROW, QuantizedX,
                                             qx_t_numerator, qx_w_numerator,
                                             xmm)
from rri_nmf_tpu_torch.ops.sweep import (ALIVE, Sweep, precision_scope,
                                         resolve_mixed_dtypes)

# Kernel launches per wrapper since the last reset_launches(). A wrapper
# adds one right after its kernel launched, and nowhere else.
LAUNCHES = {'gs': 0, 'tm_proj': 0}

def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gs_fits(k, dtype, device):
    """Whether B1 can run at ``k`` on ``device``: a block holds its
    (32, k) factor strip in shared memory and the Gram beside it, whole
    when both fit, else 16 rows at a time; on an H100 that is k up to
    ~1200 in float32 (16-bit factors too: their strip is worked in
    float32), ~600 in float64. The answer is the launcher's own gate
    (``csrc/gs.cu`` ``rri_gs_fits``). On any other device the twin runs,
    and it has no such limit."""
    return device_fits('rri_gs_fits', dtype, device, k)


def tm_proj_fits(k, d, dtype, device):
    """Whether B2 can run at (``k``, ``d``) on ``device``: a block holds a
    Gram row in shared memory (its (k, cols) factor slice joins it when it
    fits, else the slice is worked in place in the output), the
    cooperative grid must be co-resident, and the counts need d below
    2^24. The answer is the launcher's own gate (``csrc/tm_proj.cu``
    ``rri_tm_proj_fits``). On any other device the twin runs, and it has
    no such limit."""
    return device_fits('rri_tm_proj_fits', dtype, device, k, d)


def _supports_base(cfg):
    return (not cfg.masked
            and cfg.update_order == 'phase'
            and cfg.reset_topic_method is None
            and not cfg.store_gradients
            and cfg.dp_sigma is None)


def _tm_proj_active(cfg):
    """Whether the T-phase needs the whole-row projected kernel."""
    return bool(cfg.project_T_each_iter and cfg.t_row_sum
                and not cfg.fix_T)


def supports_dense_kernels(cfg, d, dtype, device):
    """Whether the kernels cover ``cfg`` at ``d`` columns in ``dtype`` on
    ``device``."""
    if not _supports_base(cfg) or not gs_fits(cfg.k, dtype, device):
        return False
    if _tm_proj_active(cfg):
        return tm_proj_fits(cfg.k, d, dtype, device)
    return True


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------

def _work(F, G):
    """The twins' work copy of ``F``: in G's (float32) dtype for a 16-bit
    ``F``, which is cast back once at the end."""
    return F.to(G.dtype) if F.dtype in NARROW else F.clone()


def gs_update_ref(G, N, F, l1, l2, bound, ub=None, reps=1):
    """Plain version of B1: the Gauss-Seidel topic loop over the rows of
    ``F`` (k, m) with Gram ``G`` (k, k) and numerators ``N`` (k, m).
    ``ub`` (m,) overrides the scalar ``bound`` of the concave branch.
    Returns the updated copy of ``F`` (a 16-bit ``F`` worked in G's
    float32 and rounded once at the end)."""
    out_dtype = F.dtype
    F = _work(F, G)
    ubv = ub if ub is not None else torch.tensor(bound, dtype=F.dtype,
                                                 device=F.device)
    for _ in range(reps):
        for t in range(F.shape[0]):
            gtt = G[t, t]
            numer = N[t] - G[t] @ F + gtt * F[t] - l1
            denom = gtt + l2
            pos = numer.clamp_min(0.0) / (denom + EPS_DIV_BY_ZERO)
            neg = torch.where(denom - numer < 0, ubv, 0.0)
            F[t] = torch.where(denom > 0, pos, neg)
    return F.to(out_dtype)


def _michelot(v, s):
    """Michelot's exact simplex projection of the nonnegative row ``v``
    (the TPU kernel's fixpoint, iteration cap and feasible shortcut)."""
    d = v.numel()
    sv = v.sum()
    if bool(sv == s) and bool(v.min() >= 0):
        return v
    tau = (sv - s) / d
    m_prev, it, changed = d + 1, 0, True
    while changed and it < d + 2:
        active = v > tau
        m = int(active.sum())
        tau = (torch.where(active, v, 0.0).sum() - s) / max(m, 1)
        changed, m_prev, it = m != m_prev, m, it + 1
    return torch.where(v > tau, v - tau, 0.0)


def tm_proj_update_ref(G, N, F, l1, l2, s, reps=1):
    """Plain version of B2: the projected T-phase over the whole (k, d)
    panel. Returns the updated copy of ``F`` (16-bit: as
    :func:`gs_update_ref`)."""
    out_dtype = F.dtype
    F = _work(F, G)
    d = F.shape[1]
    col = torch.arange(d, device=F.device)
    for _ in range(reps):
        for t in range(F.shape[0]):
            gtt = G[t, t]
            numer = N[t] - G[t] @ F + gtt * F[t] - l1
            denom = gtt + l2
            if bool(denom > 0):
                row = _michelot(numer.clamp_min(0.0)
                                / (denom + EPS_DIV_BY_ZERO), s)
            else:
                # all mass on the first least-cost coordinate
                wneg = -numer
                idx = torch.where(wneg == wneg.min(), col, d).min()
                row = torch.zeros_like(F[t])
                row[idx] = s
            if bool((row.sum() - s).abs() > 1e-15):
                row = _michelot(row, s)
            F[t] = row
    return F.to(out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(F, operands):
    """:func:`~rri_nmf_tpu_torch.ops._build.check_operands` for B1/B2:
    ``F`` itself, and the other operands in F's dtype, or in float32
    beside a 16-bit ``F``."""
    check_operands(F, {'F': (F, tuple(F.shape))})
    if F.dtype in NARROW:
        ref = next(iter(operands.values()))[0]
        if ref.dtype != torch.float32:
            raise ValueError('beside %s factors G, N and ub are float32, '
                             'got %s' % (F.dtype, ref.dtype))
        check_operands(ref, operands)
    else:
        check_operands(F, operands)


def gs_update(G, N, F, l1, l2, bound, ub=None, reps=1):
    """B1: the Gauss-Seidel topic loop (see :func:`gs_update_ref`).

    A CPU ``F`` runs the plain twin; a CUDA ``F`` launches
    ``csrc/gs.cu``, with every operand a contiguous tensor on F's device,
    of F's dtype, or float32 beside a 16-bit ``F`` (G, N and ub are then
    float32; F and the result keep F's 16 bits)."""
    if F.device.type == 'cpu':
        return gs_update_ref(G, N, F, l1, l2, bound, ub=ub, reps=reps)
    k, m = F.shape
    shapes = {'G': (G, (k, k)), 'N': (N, (k, m))}
    if ub is not None:
        shapes['ub'] = (ub, (m,))
    _check(F, shapes)
    if not gs_fits(k, F.dtype, F.device):
        raise ValueError('k=%d exceeds the GS kernel\'s shared memory '
                         '(a 32-column %s strip and 16 Gram rows)'
                         % (k, F.dtype))
    out = torch.empty_like(F)
    ct = CTYPES[F.dtype]
    launch('rri_gs', F, G.data_ptr(), N.data_ptr(), F.data_ptr(),
           ub.data_ptr() if ub is not None else None, out.data_ptr(),
           k, m, ct(l1), ct(l2), ct(bound), int(reps))
    LAUNCHES['gs'] += 1
    return out


def tm_proj_update(G, N, F, l1, l2, s, reps=1):
    """B2: the projected T-phase (see :func:`tm_proj_update_ref`).

    A CPU ``F`` runs the plain twin; a CUDA ``F`` launches
    ``csrc/tm_proj.cu`` (operands as :func:`gs_update`'s)."""
    if F.device.type == 'cpu':
        return tm_proj_update_ref(G, N, F, l1, l2, s, reps=reps)
    k, d = F.shape
    _check(F, {'G': (G, (k, k)), 'N': (N, (k, d))})
    if not tm_proj_fits(k, d, F.dtype, F.device):
        raise ValueError('k=%d, d=%d exceed the projected T-phase kernel '
                         '(a %s Gram row in shared memory, d <= 2^24)'
                         % (k, d, F.dtype))
    out = torch.empty_like(F)
    # two banks of flagged per-block slots for B2's grid reductions
    # (zeroed by the launcher)
    scratch = torch.empty(load().rri_tm_proj_scratch_bytes(),
                          dtype=torch.uint8, device=F.device)
    # a 16-bit panel's float32 work slices when they do not fit shared
    # memory (the launcher reads them only then)
    work = (torch.empty(k, d, dtype=G.dtype, device=F.device)
            if F.dtype in NARROW else out)
    ct = CTYPES[F.dtype]
    launch('rri_tm_proj', F, G.data_ptr(), N.data_ptr(), F.data_ptr(),
           out.data_ptr(), work.data_ptr(), scratch.data_ptr(), k, d,
           ct(l1), ct(l2), ct(s), int(reps))
    LAUNCHES['tm_proj'] += 1
    return out


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _dense_wtx(X, W, acc, x_narrow):
    """``WᵀX`` (k, d) in ``acc``: the scale-folded product of a
    QuantizedX; else with W cast to a bfloat16 X's dtype under
    ``x_narrow``, its products summed in ``acc``."""
    if isinstance(X, QuantizedX):
        return qx_t_numerator(W, X, acc)
    return xmm((W.to(X.dtype) if x_narrow else W).T, X, acc)


def _dense_xtt(X, T, acc, x_narrow):
    """``T Xᵀ`` (k, n) in ``acc``, as :func:`_dense_wtx`."""
    if isinstance(X, QuantizedX):
        return qx_w_numerator(T, X, acc)
    return xmm(T.to(X.dtype) if x_narrow else T, X.T, acc)


def make_dense_phase_sweep(cfg, wtx=_dense_wtx, xtt=_dense_xtt):
    """Build ``sweep(X, W, T, w_row_sum_vec=None) -> (W, T)``: one
    phase-order sweep (torch GEMMs + the kernels) for a config that
    :func:`_supports_base` accepts. ``w_row_sum_vec`` (n,) is the per-row
    W bound when ``cfg.w_row_sum_is_vector``. X is dense (of any float
    dtype) or a QuantizedX; the factors are float32/float64, or 16-bit
    (worked in float32 inside the kernels).

    ``wtx(X, W, acc, x_narrow)`` and ``xtt(X, T, acc, x_narrow)`` are the
    two numerator products ``WᵀX`` (k, d) and ``T Xᵀ`` (k, n) in the
    accumulator dtype ``acc``, the only places the sweep touches X: dense
    GEMMs by default; the sparse sweep
    (:func:`rri_nmf_tpu_torch.ops.sweep_sparse.make_sparse_sweep`) passes
    its sparse contractions.

    With ``cfg.mesh`` X, W, T and ``w_row_sum_vec`` are this rank's blocks
    (see the module docstring)."""
    if not _supports_base(cfg):
        raise ValueError('config not supported by the dense kernels')
    mesh = cfg.mesh
    where = []      # the Split of the X the sweep last ran on (a mesh)

    def split_of(X, device):
        # a dense block by its storage, a sparse block or plan by itself
        key = ((X.q if isinstance(X, QuantizedX) else X).data_ptr()
               if isinstance(X, (torch.Tensor, QuantizedX)) else id(X),
               tuple(X.shape))
        if not where or where[0] != key:
            where[:] = [key, mesh.locate(*X.shape, device)]
        return where[1]

    # upper bounds of the concave qf branch (reference semantics: the
    # positive branch does not enforce ub)
    t_bound = float(cfg.t_row_sum) if cfg.t_row_sum else float('inf')
    w_bound = (float(cfg.w_row_sum)
               if (cfg.w_row_sum is not None
                   and not cfg.w_row_sum_is_vector) else float('inf'))

    def sweep(X, W, T, w_row_sum_vec=None):
        # a sparse plan stores its values in the factors' dtype
        _, acc, x_narrow = resolve_mixed_dtypes(
            getattr(X, 'dtype', W.dtype), W.dtype, cfg.matmul_precision)
        with precision_scope(cfg.matmul_precision):
            if not cfg.fix_T:
                G = xmm(W.T, W, acc)
                WX = wtx(X, W, acc, x_narrow).contiguous()     # (k, d)
                if mesh is not None:
                    G = mesh.sum_dp(G)
                    WX = mesh.sum_dp(WX)
                if _tm_proj_active(cfg) and mesh is not None:
                    # B2 on the whole panel, gathered over tp (exactly:
                    # a 16-bit T through its float32 work dtype)
                    split = split_of(X, W.device)
                    Tg = mesh.gather_cols(T.to(acc), split).to(T.dtype)
                    T = mesh.own_cols(tm_proj_update(
                        G, mesh.gather_cols(WX, split), Tg.contiguous(),
                        cfg.reg_t_l1, cfg.reg_t_l2, float(cfg.t_row_sum),
                        reps=cfg.inner_reps), split).contiguous()
                elif _tm_proj_active(cfg):
                    T = tm_proj_update(G, WX, T.contiguous(), cfg.reg_t_l1,
                                       cfg.reg_t_l2, float(cfg.t_row_sum),
                                       reps=cfg.inner_reps)
                else:
                    T = gs_update(G, WX, T.contiguous(), cfg.reg_t_l1,
                                  cfg.reg_t_l2, t_bound,
                                  reps=cfg.inner_reps)
            if not cfg.fix_W:
                G2 = xmm(T, T.T, acc)
                XTt = xtt(X, T, acc, x_narrow).contiguous()    # (k, n)
                if mesh is not None:
                    G2 = mesh.sum_tp(G2)
                    XTt = mesh.sum_tp(XTt)
                ub = None
                if cfg.w_row_sum_is_vector:
                    ub = w_row_sum_vec.reshape(-1).to(acc).contiguous()
                # W back in rows (n, k): a transposed view would reach the
                # next sweep's GEMMs in another layout than a W_in or a
                # restored W does, and cuBLAS sums the two in another
                # order (a resumed fit would leave the straight one)
                W = gs_update(G2, XTt, W.T.contiguous(), cfg.reg_w_l1,
                              cfg.reg_w_l2, w_bound, ub=ub,
                              reps=cfg.inner_reps).T.contiguous()
        # per-iteration W row projection (reference nmf.py:481-484)
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            s = (w_row_sum_vec.reshape(-1).to(W.dtype)
                 if cfg.w_row_sum_is_vector else float(cfg.w_row_sum))
            W = _proj_simplex_core(W, s)
        return W, T

    return sweep


class DenseResetSweep(Sweep):
    """The phase-order sweep with topic resets, through the kernels: the
    plain :class:`~rri_nmf_tpu_torch.ops.sweep.Sweep` interface, whose
    :meth:`speculate` is the kernel sweep (B1, and B2 for a projected
    T-phase) with no reset check, and whose :meth:`eager` is the plain
    sweep's Gram-blocked form.

    With no reset firing, the kernels compute what the Gram-blocked form
    does: a T row or W column is final once its topic is done in its
    phase, so its reset check can be made after the phase. After the
    sweep, one read asks whether a T row or W column came out dead while
    budget was left; only then does the sweep run again, from its
    inputs, through :meth:`eager`. B2 re-projects every drifted row, dead
    or not, where the no-reset branch leaves a dead row as it is, so
    under B2 any dead T row sends the sweep to :meth:`eager` (a row
    projected onto the simplex is never dead, so this does not happen in
    practice)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        base = dataclasses.replace(cfg, reset_topic_method=None,
                                   project_W_each_iter=False)
        if cfg.reset_topic_method is None or not _supports_base(base):
            raise ValueError('config not supported by the dense kernels '
                             'with resets')
        self.kernels = make_dense_phase_sweep(base)
        # a few launches a sweep, each counted by its wrapper: no graph,
        # whose replays would launch the kernels uncounted
        self.graphable = False

    def speculate(self, X, W, T, draws, resets_left, *extras):
        cfg = self.cfg
        wrs = extras[0].reshape(-1) if cfg.w_row_sum_is_vector else None
        W, T = self.kernels(X, W, T, wrs)
        mesh = cfg.mesh
        dead = []
        if not cfg.fix_T and (resets_left > 0 or _tm_proj_active(cfg)):
            s = T.sum(1)
            if mesh is not None:
                s = mesh.sum_tp(s)
            dead.append(~(s > ALIVE))
        if not cfg.fix_W and resets_left > 0:
            s = W.sum(0)
            if mesh is not None:
                s = mesh.sum_dp(s)
            dead.append(~(s > ALIVE))
        # per-iteration W row projection (reference nmf.py:481-484), after
        # the checks, as in the plain sweep
        if (cfg.project_W_each_iter and not cfg.fix_W
                and (cfg.w_row_sum is not None or cfg.w_row_sum_is_vector)):
            W = _proj_simplex_core(W, wrs.to(W.dtype) if wrs is not None
                                   else float(cfg.w_row_sum))
        dead = torch.cat(dead).any() if dead else None
        if dead is not None and mesh is not None:
            dead = mesh.any_all(dead)
        return (W, T, int(resets_left)), dead
