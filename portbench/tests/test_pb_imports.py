"""What a benchmark process loads: never JAX or the JAX package, and the
reference, every configuration's reference module with it, nothing of the
program.  Modules are compared by their top-level name whole (the part
before the first dot): the port's name begins with the JAX package's."""

import ast
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'supervised_gan_tpu'}


def reference_files():
    """The module path of the reference that each configuration of
    BENCHMARK.json names."""
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    return sorted({json.loads((ROOT / c['file']).read_text())['reference']
                   .split()[0] for c in bench['configs']})


def loaded_after(code):
    """The top-level names of sys.modules after ``code`` runs in a fresh
    interpreter at the checkout's root."""
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\nprint(json.dumps('
         'sorted({m.split(".")[0] for m in sys.modules})))'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'HOME': str(ROOT / 'portbench_run'),
             'OMP_NUM_THREADS': '1'})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cell_loads_no_jax():
    """Everything each cell's run imports, the program's model built, one
    reference step's modules and the kernel families included."""
    mods = loaded_after(
        'import portbench.run, portbench.harness as h\n'
        'b = h.benchmark()\n'
        'for w in b["workloads"]:\n'
        '    r = h.Run(w["name"], 1, "cpu", '
        'flags=h.lookup(b, w["name"])[2]["cpu_test_flags"])\n'
        '    p = h.Program(r.flags, r.mix, 1, 2, '
        '__import__("torch").device("cpu"), "pb_imports")\n'
        '    h.step_flops(r.recipe, r.flags, 1)\n'
        'h.roofline.families()\n'
        'import portbench.calibrate\n'
        'for m in ("dispatch.host_ms_per_step", "step_mfu"): h.reader(m)\n')
    assert 'supervised_gan_tpu_torch' in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = ['portbench.reference.nets', 'portbench.reference.ctx'] + [
        p[:-len('.py')].replace('/', '.') for p in reference_files()]
    mods = loaded_after('import ' + ', '.join(names))
    assert 'supervised_gan_tpu_torch' not in mods
    assert not mods & FORBIDDEN


def test_the_reference_sources_import_nothing_of_the_program():
    paths = set((ROOT / 'portbench' / 'reference').glob('*.py'))
    paths |= {ROOT / p for p in reference_files()}
    for path in sorted(paths):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split('.')[0]
                assert top not in FORBIDDEN | {'supervised_gan_tpu_torch',
                                               'portbench'}, (path, n)
