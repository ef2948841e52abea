"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import pkgutil
import subprocess
import sys

import supervised_gan_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(supervised_gan_tpu_torch.__file__)

# runs in a fresh interpreter: this test process has imported jax already
_PROBE = r"""
import importlib, pkgutil, sys
import supervised_gan_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m.startswith('jaxlib.') or m == 'supervised_gan_tpu'
             or m.startswith('supervised_gan_tpu.'))
print(len(names))
assert not bad, bad
"""


def test_port_modules_import_without_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n_modules = len(list(pkgutil.walk_packages(
        supervised_gan_tpu_torch.__path__, 'supervised_gan_tpu_torch.')))
    assert int(out.stdout.split()[-1]) == n_modules >= 20


def test_port_sources_do_not_name_jax():
    offenders = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(dirpath, f)
                text = open(path).read()
                for needle in ('supervised_gan_tpu.', 'import jax',
                               'from jax'):
                    if needle in text:
                        offenders.append((path, needle))
    assert not offenders
