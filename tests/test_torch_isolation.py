"""The port stands alone: no JAX, no snap_tpu, no PyTorch C++ extension.

The card's machine has torch and numpy but no jax, flax, ml_collections,
absl, orbax or tensorstore; the port and chip_smoke.py must import there.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {'jax', 'jaxlib', 'flax', 'ml_collections', 'absl', 'orbax',
           'tensorstore', 'snap_tpu'}

class Blocker(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split('.')[0] in BLOCKED:
      raise ImportError(f'blocked import of {name}')
    return None

sys.meta_path.insert(0, Blocker())
import snap_tpu_torch
names = ['snap_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(snap_tpu_torch.__path__,
                                          'snap_tpu_torch.')]
for name in names:
  importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
'''


def test_port_imports_without_jax_or_snap_tpu():
  proc = subprocess.run(
      [sys.executable, '-c', _BLOCKED_IMPORT], cwd=REPO, capture_output=True,
      text=True, timeout=300,
      env={'PATH': '/usr/bin:/bin', 'PYTHONPATH': str(REPO),
           'OMP_NUM_THREADS': '1'})
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.split()[-1]) >= 20  # every module of the port


def test_no_pytorch_cpp_extension_in_the_port():
  sources = [p for p in (REPO / 'snap_tpu_torch').rglob('*')
             if p.suffix in ('.py', '.cu', '.cuh', '.h', '.cpp')]
  sources.append(REPO / 'chip_smoke.py')
  assert len(sources) > 20
  for path in sources:
    text = path.read_text()
    for banned in ('cpp_extension', 'torch/extension.h', '#include <torch/',
                   'import jax', 'from snap_tpu.', 'import snap_tpu\n'):
      assert banned not in text, (path, banned)
