"""No run may hold JAX or the JAX package: the check compares top-level
names whole. The plain references import nothing of either package."""

import subprocess
import sys

import pytest

from portbench.core.harness import FORBIDDEN, forbidden_modules
from portbench.core.spec import ROOT


@pytest.mark.parametrize('modules, found', [
    (['torch', 'rri_nmf_tpu_torch', 'rri_nmf_tpu_torch.nmf'], []),
    (['rri_nmf_tpu', 'rri_nmf_tpu.nmf'], ['rri_nmf_tpu']),
    (['jax._src.core', 'numpy'], ['jax']),
    (['jaxlib.xla_client'], ['jaxlib']),
    (['flax.linen'], ['flax']),
    (['jaxtyping', 'flaxen', 'rri_nmf_tpu_tools'], []),
])
def test_top_level_names_compared_whole(modules, found):
    assert forbidden_modules(modules) == found


def test_forbidden_names():
    assert set(FORBIDDEN) == {'jax', 'jaxlib', 'flax', 'rri_nmf_tpu'}


CODE = '''
import sys
sys.path.insert(0, %r)
from portbench.core.spec import load_module
for name in ('plain', 'tm_interleaved', 'tm_phase', 'rs_masked'):
    load_module('reference', name)
bad = sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'jaxlib', 'flax', 'rri_nmf_tpu', 'rri_nmf_tpu_torch'})
print(','.join(bad))
'''


def test_references_import_nothing_of_the_packages():
    out = subprocess.run([sys.executable, '-c', CODE % str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd='/')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''


def test_harness_imports_nothing_of_jax():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import portbench.core.harness, portbench.readings\n'
            'import rri_nmf_tpu_torch.sklearn_interface\n'
            'print(",".join(sorted({m.split(".")[0] for m in sys.modules}'
            ' & {"jax", "jaxlib", "flax", "rri_nmf_tpu"})))' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd='/')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''
