"""The port's multi-host layer (ROADMAP A.12f:
``rri_nmf_tpu_torch.parallel.multihost``, ``nmf()`` on a rank's own slab
and on pre-built plans, the NNDSVD init through the mesh, the restore
decided for the whole mesh) against the JAX package, on the CPU in
float64.

The counterparts of ``tests/test_multihost.py`` (under JAX's names) and
``tests/test_multiprocess.py``. JAX's multi-controller tests run two
processes of four virtual devices; here four rank processes of one gloo
world stand as two hosts of two ranks (``LOCAL_WORLD_SIZE=2``,
``tests/torch_multihost_worker.py`` in the pool of
``tests/torch_mesh_worker.py``), and every rank builds its inputs from
its own slab. The meshes are ``make_global_mesh``'s default (2, 2) and
(4, 1) (JAX's (4, 2) and (8, 1)). Each slab fit is held

- bit for bit across the ranks and against the same ranks' whole-X mesh
  fit (the same blocks, plans and collectives);
- against JAX's single-device fit at JAX's tolerances: W and T within
  1e-10, ``obj_history`` within 1e-12 relative for A and B and 1e-11 for
  D and F-J.

Where the port departs from JAX's layout (no TILE-rounded row quantum,
no empty slab), the test names the port's rule.
"""

import os

import numpy as np
import pytest
import torch

from rri_nmf_tpu.nmf import nmf as jax_nmf
from rri_nmf_tpu_torch.parallel import initialize_distributed
from torch_mesh_worker import REPO, MeshPool
from torch_multihost_worker import CONFIGS, K, N, problem, runs_on

torch.set_num_threads(2)

SHAPES = [None, (4, 1)]
W_TOL = 1e-10
OBJ_RTOL = {'A': 1e-12, 'B': 1e-12}
OBJ_RTOL_REST = 1e-11


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = MeshPool(tmp_path_factory.mktemp('multihost_ranks'),
                 env={'LOCAL_WORLD_SIZE': '2'},
                 cases='torch_multihost_worker')
    yield p
    p.close()


@pytest.fixture(scope='module')
def configs(pool, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('multihost_ckpt'))
    return {shape: pool.run('configs', mesh=(2, 2), shape=shape, tmp=tmp)
            for shape in SHAPES}


@pytest.fixture(scope='module')
def jax_fits():
    """JAX's single-device fits of configurations A-J (C and E are held
    against A)."""
    P = problem()
    out = {}
    for name, (kind, kw) in CONFIGS.items():
        if name == 'C':
            continue
        warm = {} if 'init' in kw else dict(W_in=P['W0'], T_in=P['T0'])
        X = P['X'] if kind == 'dense' else P['Xs'] if kind in (
            'coo', 'mxu') else P['Xm']
        extra = ({'W_mat': P['Ms']} if kind.startswith('masked') else
                 {'sparse': 'mxu' if kind == 'mxu' else True}
                 if kind in ('coo', 'mxu') else {})
        res = jax_nmf(X, K, **warm, **extra, **kw)
        out[name] = {'W': np.asarray(res['W']), 'T': np.asarray(res['T']),
                     'obj_history': np.asarray(res['obj_history'])}
    return out


def _close(a, b, tol):
    return np.allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                       atol=tol)


# ---------------------------------------------------------------------------
# tests/test_multihost.py
# ---------------------------------------------------------------------------

def test_initialize_distributed_single_process_noop():
    """Without a group and without torchrun's environment nothing is
    initialized, twice."""
    assert not torch.distributed.is_initialized()
    assert initialize_distributed() == (0, 1)
    assert initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_arguments():
    """A rank drives one device: more than one local device id raises,
    in a group or not."""
    with pytest.raises(ValueError, match='one device'):
        initialize_distributed(local_device_ids=[0, 1])


def test_initialize_distributed_from_torchrun_env(tmp_path):
    """torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) joins a group through env:// with gloo where there is
    no card; make_global_mesh is then the one-rank (1, 1) mesh."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    code = ('from rri_nmf_tpu_torch.parallel import initialize_distributed, '
            'make_global_mesh\n'
            'import torch.distributed as dist\n'
            'print(initialize_distributed(), initialize_distributed(), '
            'dist.get_backend(), make_global_mesh().shape)\n'
            'dist.destroy_process_group()\n')
    env = dict(os.environ, RANK='0', WORLD_SIZE='1', MASTER_ADDR='localhost',
               MASTER_PORT=str(port), LOCAL_RANK='0', CUDA_VISIBLE_DEVICES='',
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split('\n')[0] == '(0, 1) (0, 1) gloo (1, 1)'


def test_global_mesh_matches_local_single_process(pool):
    """In a group, initialize_distributed returns it (idempotent); the
    default global mesh is (hosts, ranks per host) = (2, 2), make_mesh's
    shape; an explicit (4, 1) holds every rank; on one host (no
    LOCAL_WORLD_SIZE: the host names) make_mesh's rule."""
    got = pool.run('world', mesh=(2, 2))
    assert [e['init'] for e in got['every']] == [
        [(r, 4), (r, 4)] for r in range(4)]
    assert [e['default'] for e in got['every']] == [
        ((2, 2), (0, 0)), ((2, 2), (0, 1)), ((2, 2), (1, 0)),
        ((2, 2), (1, 1))]
    assert got['like_make_mesh']
    assert [e['explicit'] for e in got['every']] == [
        ((4, 1), (r, 0)) for r in range(4)]
    assert [e['one_host'] for e in got['every']] == [
        e['default'] for e in got['every']]


def test_global_mesh_keeps_tp_within_a_host(pool):
    """A tp row across hosts and hosts of unequal rank counts raise JAX's
    ValueError."""
    got = pool.run('world', mesh=(2, 2))
    for key in ('tp_across', 'unequal'):
        assert 'cannot lay out mesh_shape=(' in got[key], got[key]
        assert 'with tp inside a process' in got[key]


def test_process_row_block_covers_everything(pool):
    """The ranks' row ranges cover [0, n) once per dp row, and every rank
    of a dp row loads the same rows."""
    got = pool.run('world', mesh=(2, 2))
    for shape in ((2, 2), (4, 1)):
        for n in (100, 5, 64, 17, 4):
            ranges = sorted({e['rows'][(shape, n)] for e in got['every']})
            assert len(ranges) == shape[0]
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_distribute_dense_and_factors_roundtrip(pool):
    """distribute_dense / distribute_factors gathered back are X, W and
    T; each rank's block is its (rows, columns), contiguous, and W's
    block has whole columns."""
    rng = np.random.RandomState(0)
    X = rng.rand(64, 32)
    W, T = rng.rand(64, 5), rng.rand(5, 32)
    got = pool.run('roundtrip', mesh=(2, 2))
    np.testing.assert_array_equal(got['X'], X)
    np.testing.assert_array_equal(got['W'], W)
    np.testing.assert_array_equal(got['T'], T)
    shape, whole, split = got['block']
    assert shape == (32, 16) and whole == (64, 32)
    assert (split.r0, split.r1, split.c0, split.c1) == (0, 32, 0, 16)
    assert got['W_block'] == ((32, 5), (64, 5))
    assert got['contiguous']


def test_global_mesh_drives_a_sharded_fit(pool):
    """A fit from the ranks' slabs on make_global_mesh: parity with the
    single-device fit."""
    got = pool.run('roundtrip', mesh=(2, 2))
    assert _close(got['fit']['W'], got['single']['W'], 1e-11)
    assert _close(got['fit']['T'], got['single']['T'], 1e-11)


def test_process_row_block_clamped_and_mesh_aware(pool):
    """Every rank's range is block_range of its dp coordinate for any n on
    both meshes; fewer rows than dp, and a rank outside the mesh, raise
    (no (0, 0) range, no empty slab)."""
    got = pool.run('world', mesh=(2, 2))
    assert all(e['rule'] for e in got['every'])
    assert 'cannot be split' in got['too_few']
    assert got['outside'] == 'rank 3 is not in Mesh(dp=3, tp=1)'


def test_distribute_masked_coo_single_process(pool, configs, jax_fits):
    """distribute_masked_coo of each rank's slabs equals
    partition_masked_coo / partition_masked_gram of the whole arrays bit
    for bit (COO, segsum and 'mxu' plans), and the plans drive nmf():
    the COO plan (G) and the Gram plan (H) against JAX's fits, H's
    objective non-increasing and its calculator on the mesh equal to the
    last objective."""
    got = pool.run('plans', mesh=(2, 2))
    for backend in (None, 'segsum', 'mxu'):
        assert got[(4, 1), 'masked', backend], backend
    fits = configs[(4, 1)]['fits']
    for name in ('G', 'H'):
        assert _close(fits[name]['W'], jax_fits[name]['W'], W_TOL)
        assert _close(fits[name]['T'], jax_fits[name]['T'], W_TOL)
    oh = fits['H']['obj_history']
    assert np.all(np.diff(oh) <= 1e-12)
    assert abs(fits['H']['calculator'] - oh[-1]) < 1e-9


def test_process_row_block_tiled(pool):
    """JAX's tile-rounded quantum has no counterpart: the 'mxu' plan takes
    the same rows as the dense and COO backends (process_row_block's),
    and its split is the mesh's, on both meshes."""
    got = pool.run('plans', mesh=(2, 2))
    assert got[(2, 2), 'rows'] and got[(4, 1), 'rows']


def test_distribute_sparse_coo_single_process(pool, configs):
    """distribute_sparse_coo of each rank's slab equals partition_coo /
    partition_mxu of the whole X bit for bit (the 'mxu' plan's COO
    companion too) on both meshes, and the plans drive nmf(): the COO
    plan on (2, 2) and (4, 1) and the 'mxu' plan on (4, 1), bit for bit
    the whole-X sparse mesh fits, objective non-increasing."""
    got = pool.run('plans', mesh=(2, 2))
    for shape in ((2, 2), (4, 1)):
        for key in ('coo', 'mxu', 'obj_coo'):
            assert got[shape, key], (shape, key)
    for shape in SHAPES:
        assert configs[shape]['as_whole']['I']
    assert configs[(4, 1)]['as_whole']['J']
    oh = configs[(4, 1)]['fits']['J']['obj_history']
    assert np.all(np.diff(oh) <= 1e-12)


def test_distribute_sparse_coo_guards(pool):
    got = pool.run('guards', mesh=(2, 2))
    for key in ('dense_rows', 'factor_rows', 'rows'):
        assert 'process_row_block' in got[key], got[key]
    assert 'columns' in got['dense_columns']
    assert 'columns' in got['columns']
    assert 'backend' in got['backend']
    assert 'W_in AND T_in' in got['warm']
    assert 'mesh=None' in got['no_mesh']
    assert 'W_mat' in got['w_mat']
    # a plan of another mesh is caught on either axis
    assert 'rebuild' in got['other_mesh_cols']
    assert 'rebuild' in got['other_mesh_rows']
    assert 'conflicts' in got['conflicts']
    assert 'rebuild' in got['mxu_kwarg']
    assert 'dtype' in got['dtype']
    assert 'diagnostics' in got['diagnostics']
    assert 'host X' in got['host_x']
    assert got['no_companion']
    assert 'with_obj_coo' in got['with_obj_coo']
    assert got['untracked_finite']
    for key in ('rows', 'columns', 'backend', 'warm', 'no_mesh', 'w_mat',
                'other_mesh_cols', 'conflicts', 'dtype', 'with_obj_coo'):
        assert got[key].startswith('ValueError'), (key, got[key])


def test_distribute_masked_coo_guards(pool):
    got = pool.run('guards', mesh=(2, 2))
    assert 'row-partitioned' in got['row_partitioned']
    assert 'scipy-sparse' in got['scipy_sparse']
    assert 'process_row_block' in got['masked_rows']
    assert 'backend' in got['masked_backend']
    assert 'W_in AND T_in' in got['masked_warm']
    assert 'phase' in got['phase'] and got['phase'].startswith('ValueError')
    assert any(w.startswith('RuntimeWarning') and 'Gram plan' in w
               for w in got['gram_plan_warning']), got['gram_plan_warning']
    assert 'rebuild' in got['masked_other_mesh']


# ---------------------------------------------------------------------------
# tests/test_multiprocess.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', SHAPES, ids=['2x2', '4x1'])
def test_two_process_results_agree_bitwise(configs, shape):
    """Every rank's gathered results of every configuration are bit for
    bit the same."""
    got = configs[shape]
    names = [n for n in 'ABCDEFGHIJ' if n == 'E' or runs_on(n, got['shape'])]
    assert sorted(got['across_ranks']) == sorted(names)
    assert all(got['across_ranks'].values()), got['across_ranks']


@pytest.mark.parametrize('shape', SHAPES, ids=['2x2', '4x1'])
def test_multiprocess_matches_single_controller(configs, jax_fits, shape):
    """The first rank's slab fits against JAX's single-device fits: W, T
    within 1e-10, obj_history 1e-12 (A, B) and 1e-11 (D, F-J) relative;
    C (grouped dispatch) equals A exactly; E (resumed with other warm
    starts) equals A's straight fit."""
    fits = configs[shape]['fits']
    for name, ref in jax_fits.items():
        if name not in fits:
            continue
        got = fits[name]
        assert _close(got['W'], ref['W'], W_TOL), name
        assert _close(got['T'], ref['T'], W_TOL), name
        np.testing.assert_allclose(got['obj_history'], ref['obj_history'],
                                   rtol=OBJ_RTOL.get(name, OBJ_RTOL_REST),
                                   err_msg=name)
    np.testing.assert_array_equal(fits['C']['W'], fits['A']['W'])
    np.testing.assert_array_equal(fits['C']['T'], fits['A']['T'])
    assert len(fits['E']['obj_history']) == 5
    assert fits['E']['first_history'] == fits['A']['obj_history'][:2]


@pytest.mark.parametrize('shape', SHAPES, ids=['2x2', '4x1'])
def test_slab_fits_equal_whole_x_mesh_fits(configs, shape):
    """Each slab or plan fit is bit for bit the same ranks' fit of the
    whole X on the same mesh (E, the resumed fit, the straight A)."""
    got = configs[shape]['as_whole']
    assert all(got.values()), got


@pytest.mark.parametrize('shape', [(2, 2), (4, 1), (1, 1)],
                         ids=['2x2', '4x1', '1x1'])
@pytest.mark.parametrize('init', ['nndsvd', 'nndsvda', 'nndsvdar',
                                  'nndsvd_lrc', 'smart_random'])
def test_mesh_nndsvd_matches_single_device(pool, shape, init):
    """The NNDSVD family's init of the ranks' blocks through the mesh
    (the section norms and means summed over the mesh) within 1e-10 of
    the single-device device-backend init of the whole X with the same Ω
    (JAX's mp_worker.py bound), the SVD too; every rank the same bits; a
    (1, 1) mesh bit for bit (the SVD and the sections: the fills of
    nndsvda/nndsvdar read a mean summed in blocks)."""
    got = pool.run('nndsvd', mesh=(2, 2), shape=shape, init=init)
    assert got['across_ranks']
    assert max(got['gap'].values()) <= 1e-10, got['gap']
    if shape == (1, 1) and init in ('nndsvd', 'nndsvd_lrc'):
        assert got['equal'] and max(got['gap'].values()) == 0.0


def test_rank_block_options(pool):
    """A rank-block X beside the whole-X mesh fit, bit for bit: a dense
    mask as a RankBlock and whole, a RankBlock W_in with a whole X,
    x_dtype int16 (scales from the column maxima over dp) and bfloat16;
    a fresh NNDSVD fit; callbacks on X gathered whole; the calculator on
    the mesh, and its pickle raising JAX's mesh-sharded ValueError."""
    got = pool.run('block_options', mesh=(2, 2))
    for key in ('mask_block', 'mask_whole', 'w_in_block', 'int16',
                'bfloat16', 'fresh_finite', 'diagnostics', 'objective',
                'across_ranks'):
        assert got[key], key
    assert 'mesh-sharded' in got['pickled']


def test_rank_block_guards(pool):
    """A rank-block X: no mesh, a sparse mode, a sparse mask, w_row, an
    integer block, another mesh's block and coherence_pmi raise as JAX's
    process-spanning X does; so does a block W_in without T_in."""
    got = pool.run('guards', mesh=(2, 2))
    assert got['block_no_mesh'].startswith('ValueError') and \
        'mesh=None' in got['block_no_mesh']
    for key in ('block_sparse', 'block_sparse_mask'):
        assert got[key].startswith('NotImplementedError') and \
            'distribute_sparse_coo' in got[key], got[key]
    assert got['block_w_row'].startswith('NotImplementedError')
    assert 'floating point' in got['block_int']
    assert 'rebuild' in got['block_other_mesh']
    assert 'coherence_pmi' in got['block_pmi']
    assert 'needs T_in' in got['block_w_in_alone']


def test_restore_is_one_decision_for_the_mesh(pool, tmp_path):
    """Ranks that see different checkpoint directories: when only the
    first rank's holds a checkpoint every rank resumes from it (the
    resumed fit from other warm starts equals the straight fit bit for
    bit); when only another rank's holds one every rank starts fresh. A
    mesh that restored on each rank alone would run ranks to different
    iteration counts and stall in its next all-reduce, which the pool
    ends after CASE_SECONDS."""
    got = pool.run('restore', mesh=(2, 2), tmp=str(tmp_path))
    every = got['every']
    assert [e['disk_a'] for e in every] == [[2], [], [], []]
    assert [e['disk_b'] for e in every] == [[], [3], [], []]
    assert all(e['resumed'] for e in every)
    assert all(e['started'] for e in every)
    assert len(got['resumed']['obj_history']) == 5
