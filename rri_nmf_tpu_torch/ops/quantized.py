"""Column-scaled int16 storage of X, and the products that read a narrow X.

Counterpart of :mod:`rri_nmf_tpu.ops.quantized`. :class:`QuantizedX`
holds a nonnegative (n, d) matrix as ``q * s[None, :]``: ``q`` int16 in
[0, 32767] and ``s`` the per-column scale ``colmax / 32767`` (1 for a
zero column), 2 bytes an entry at ~70x less quantization noise than
bfloat16 for concentrated nonnegative data. ``dtype`` reports the
dequantized dtype, so the shared dtype rules
(:func:`rri_nmf_tpu_torch.ops.sweep.resolve_mixed_dtypes`) see a wide X.

The scale folds outside every product, as in the JAX package:

- T-phase numerator ``Wᵀ X = (Wᵀ q) ⊙ sᵀ`` (:func:`qx_t_numerator`);
- W-phase numerator ``X Tᵀ = q (T ⊙ sᵀ)ᵀ`` (:func:`qx_w_numerator`);
- the init's range finder ``X Ω = q (s ⊙ Ω)`` and ``Xᵀ Q = (qᵀ Q) ⊙ s``
  (:func:`qx_rmul`, :func:`qx_lmul_t`);
- residuals and objectives over dequantized row or column blocks
  (:func:`qx_row_block`, :func:`qx_col_block`).

JAX fuses the int16 -> float upcast into the GEMM's operand stream.
PyTorch has no mixed int16 x float GEMM, so :func:`xmm` upcasts fixed
row blocks of the narrow operand into one reused buffer of at most
:data:`UPCAST_BYTES` and sums the block products with ``torch.addmm``:
no n x d float copy of X is ever made (the memory the mode exists to
save). The same function serves a bfloat16 or float16 X beside float32
factors (``x_dtype='bfloat16'``, 16-bit factors): on the card two 16-bit
operands of one dtype go to one ``torch.mm(..., out_dtype=float32)``
(``aten::mm.dtype``, which the CPU build refuses), which reads the
16-bit values and sums in float32 without any copy.
"""

import numpy as np
import torch

from rri_nmf_tpu_torch.matrixops import default_float

# Bytes of the reused buffer a narrow operand is upcast into, a block of
# rows at a time.
UPCAST_BYTES = 1 << 30

NARROW = (torch.bfloat16, torch.float16)


def work_dtype(dtype):
    """The dtype a ``dtype`` storage is worked and summed in: float32
    for 16-bit storage, else ``dtype`` itself."""
    return torch.float32 if dtype in NARROW else dtype


class QuantizedX(object):
    """Column-scaled int16 code of a nonnegative dense matrix (see the
    module docstring): ``q`` (n, d) int16, ``s`` (d,) float scale, both on
    one device; the matrix is ``q * s[None, :]``."""

    __slots__ = ('q', 's')

    def __init__(self, q, s):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return 2

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def device(self):
        return self.q.device

    def to(self, device):
        """The code on ``device``."""
        return QuantizedX(self.q.to(device), self.s.to(device))

    def __repr__(self):
        return 'QuantizedX(shape=%r, dtype=%s, device=%s)' % (
            tuple(self.shape), self.dtype, self.device)


def _quantize_np(X, dt):
    """The host encoding (``rri_nmf_tpu.nmf._quantize_host``): numpy
    ``(q, s)`` of ``X`` in the numpy dtype ``dt``."""
    Xw = np.asarray(X, dtype=dt)
    if Xw.size and float(Xw.min()) < 0:
        raise ValueError("quantize_x encodes nonnegative X only (NMF input "
                         'contract); found negative entries')
    s = Xw.max(axis=0) / dt.type(32767)
    s = np.where(s > 0, s, dt.type(1)).astype(dt)
    q = np.clip(np.round(Xw / s), 0, 32767).astype(np.int16)
    return q, s


def quantize_x(X, dtype=None, device=None, mesh=None):
    """Encode the nonnegative dense ``X`` as a :class:`QuantizedX`.

    A numpy array (or list) is encoded on the host, so only the int16
    code crosses to ``device`` (default: the card; ``device='cpu'`` for
    the CPU), bit for bit as the JAX package's host encoder. A tensor is
    encoded on its own device (or ``device``), a block of columns at a
    time, so the float temporaries stay at block size. ``dtype`` is the
    scale's (dequantized) dtype: by default X's float dtype, else the
    device's default float. Negative entries raise ``ValueError``. With
    ``mesh``, X is a rank's block of a matrix no rank holds whole: each
    column's scale comes from its maximum over ``dp`` (the whole column,
    every rank calling together), and a negative entry on any rank
    raises on every rank."""
    from rri_nmf_tpu_torch.matrixops import fit_device
    if not isinstance(X, torch.Tensor):
        device = fit_device(X, device)
        X = np.asarray(X)
        if dtype is None:
            dtype = (torch.from_numpy(np.zeros(0, X.dtype)).dtype
                     if np.issubdtype(X.dtype, np.floating)
                     else default_float(device))
        dt = np.dtype(torch.empty(0, dtype=dtype).numpy().dtype)
        q, s = _quantize_np(X, dt)
        return QuantizedX(torch.from_numpy(q).to(device),
                          torch.from_numpy(s).to(device))
    if device is not None:
        X = X.to(device)
    if dtype is None:
        dtype = X.dtype if X.dtype.is_floating_point \
            else default_float(X.device)
    n, d = X.shape
    negative = bool(X.numel()) and bool(X.min() < 0)
    if mesh is not None:
        negative = bool(mesh.any_all(torch.tensor(negative,
                                                     device=X.device)))
    if negative:
        raise ValueError("quantize_x encodes nonnegative X only (NMF input "
                         'contract); found negative entries')
    if mesh is not None:
        # the whole column's maximum (every rank has a row)
        s = mesh.max_dp(X.amax(0)).to(dtype) / 32767
    else:
        s = X.amax(0).to(dtype) / 32767 if n else torch.ones(
            d, dtype=dtype, device=X.device)
    s = torch.where(s > 0, s, torch.ones((), dtype=dtype, device=X.device))
    q = torch.empty(n, d, dtype=torch.int16, device=X.device)
    B = _block(d, n, torch.empty(0, dtype=dtype).element_size())
    for j in range(0, d, B):
        Xb = X[:, j:j + B].to(dtype) / s[j:j + B]
        q[:, j:j + B] = Xb.round_().clamp_(0, 32767).to(torch.int16)
    return QuantizedX(q, s)


def dequantize_x(qx):
    """The whole dequantized matrix (small inputs and tests only: it is
    the n x d float copy quantized storage exists to avoid)."""
    return qx.q.to(qx.dtype) * qx.s[None, :]


# ---------------------------------------------------------------------------
# products with a narrow operand
# ---------------------------------------------------------------------------

def _block(n, width, itemsize):
    """Rows of ``width`` ``itemsize``-byte values that fit
    :data:`UPCAST_BYTES` (at least 1, at most ``n``)."""
    return max(1, min(max(n, 1), UPCAST_BYTES // max(1, width * itemsize)))


def _upcast_blocks(A, acc):
    """``(i, j, A[i:j] in acc)`` over blocks of A's rows, each block
    written into one reused buffer of at most :data:`UPCAST_BYTES`."""
    n, width = A.shape
    B = _block(n, width, torch.empty(0, dtype=acc).element_size())
    buf = torch.empty(min(B, n) * width, dtype=acc, device=A.device)
    for i in range(0, n, B):
        j = min(n, i + B)
        blk = buf[:(j - i) * width].view(j - i, width)
        blk.copy_(A[i:j])
        yield i, j, blk


def xmm(A, B, acc):
    """``A @ B`` in ``acc`` for 2-D operands of any float (or int16)
    dtypes: the plain product when both are ``acc``; on the card two
    16-bit operands of one dtype in one ``torch.mm(..., out_dtype=acc)``;
    otherwise the larger operand is upcast a block of its
    rows at a time (:func:`_upcast_blocks`) and the smaller one once:
    B's row blocks are A's column blocks, summed with ``addmm_``, and A's
    row blocks fill the output's row blocks. Products of 16-bit values
    are exact in float32, so every form forms the same products, summed
    in ``acc``."""
    if A.dtype == acc and B.dtype == acc:
        return A @ B
    if (A.dtype == B.dtype and A.dtype in NARROW and acc == torch.float32
            and A.is_cuda):
        return torch.mm(A, B, out_dtype=acc)
    if B.numel() >= A.numel():
        if (B.numel() > A.numel() and not B.is_contiguous()
                and B.T.is_contiguous()):
            # B is a transposed X: upcast contiguous blocks of X's rows
            return xmm(B.T, A.T, acc).T
        Aa = A.to(acc)
        out = torch.zeros(A.shape[0], B.shape[1], dtype=acc, device=A.device)
        for i, j, Bb in _upcast_blocks(B, acc):
            out.addmm_(Aa[:, i:j], Bb)
        return out
    if not A.is_contiguous() and A.T.is_contiguous():
        return xmm(B.T, A.T, acc).T
    Ba = B.to(acc)
    out = torch.empty(A.shape[0], B.shape[1], dtype=acc, device=A.device)
    for i, j, Ab in _upcast_blocks(A, acc):
        torch.mm(Ab, Ba, out=out[i:j])
    return out


# ---------------------------------------------------------------------------
# the scale-folded contractions of a QuantizedX
# ---------------------------------------------------------------------------

def qx_t_numerator(W, qx, acc):
    """``Wᵀ X`` as ``(Wᵀ q) ⊙ sᵀ``: (k, d) in ``acc``."""
    return xmm(W.T, qx.q, acc) * qx.s.to(acc)[None, :]


def qx_w_numerator(T, qx, acc):
    """``X Tᵀ`` transposed, (k, n): ``(T ⊙ sᵀ) qᵀ``."""
    Ts = T * qx.s.to(T.dtype)[None, :]
    return xmm(Ts, qx.q.T, acc).contiguous()


def qx_row_block(qx, off, rows, acc):
    """The dequantized (rows, d) row block starting at ``off``."""
    return qx.q[off:off + rows].to(acc) * qx.s.to(acc)[None, :]


def qx_col_block(qx, off, cols, acc):
    """The dequantized (n, cols) column block starting at ``off``."""
    return (qx.q[:, off:off + cols].to(acc)
            * qx.s[off:off + cols].to(acc)[None, :])


def qx_mean(qx):
    """The mean of the dequantized matrix without forming it:
    ``mean_j(s_j · mean_i(q_ij))``, the column sums of q taken in float64
    (int16 is read and summed in one pass)."""
    n = qx.shape[0]
    colmeans = (qx.q.sum(0, dtype=torch.float64) / max(n, 1)).to(qx.dtype)
    return (colmeans * qx.s).mean()


def qx_rmul(qx, Omega, acc):
    """``X Ω`` (n, p): Ω's rows prescaled by ``s``, then one pass of q."""
    return xmm(qx.q, Omega * qx.s.to(Omega.dtype)[:, None], acc)


def qx_lmul_t(qx, Q, acc):
    """``Xᵀ Q`` (d, p): one pass of q, then a row postscale."""
    return xmm(Q.T, qx.q, acc).T * qx.s.to(acc)[:, None]
