"""One run of one cell: set-up, the measured window, the traced stretch and
the check against the plain reference.

Everything is found by name: the cell in BENCHMARK.json, its configuration
(configs/<config>.json: the flags, host threads, source, reduced,
assumed, the CPU tests' narrow widths, and its plain reference: a module
path and a class, ``recipe_class``), its traffic mix
(traffic/<traffic>.json, read by traffic.py), its check
(workloads/<cell>.json: the limits and any subsets, check.py), the hand
kernels' families (kernels/<family>.py, roofline.py) and each per-layer
metric's reader (metrics/<metric>.py).  The program,
supervised_gan_tpu_torch, is driven through the calls of its train.py
``dispatch``: ``train_chunk(batches)`` for a mix of k > 1 steps a
dispatch, else ``set_input(batch)`` and ``optimize_parameters()``, each
dispatch ended by a synchronize.

Set-up: the program's model from the configuration's flags, the seeded
weights written into it, its pools filled with seeded images (so the
checked steps swap, as every step after the pools' first fill does), the
mix's images drawn, then the checked steps through the window's own call,
each on its own batch: the program's eager steps of one batch each, then
one dispatch of the window's size (with steps_per_dispatch k > 1 a
train_chunk of k batches, the step graph captured and replayed), with the
readings the check needs taken between them (check.py), and the mix's
warm-up dispatches.  With a CUDA device the second step also records the
hand kernels' calls (roofline.py) for the per-layer metrics.
"""

import gc
import importlib.util
import itertools
import json
import os
import re
import sys
import time
from pathlib import Path

import torch

from . import check, roofline, trace, traffic, weights
from .reference.ctx import Ctx, Draws

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
RUN_DIR = ROOT / 'portbench_run'
IDENT = re.compile(r'[A-Za-z_][A-Za-z0-9_]*')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / 'BENCHMARK.json')


def lookup(bench, name):
    """(workload entry, configuration entry, configuration file, mix,
    check file: its limits and subsets, see check.py) of cell ``name``."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit('unknown workload %r (BENCHMARK.json has %s)'
                         % (name, ', '.join(sorted(cells))))
    w = cells[name]
    c = {x['name']: x for x in bench['configs']}[w['config']]
    return (w, c, load_json(ROOT / c['file']),
            traffic.load(PKG / 'traffic' / ('%s.json' % w['traffic'])),
            load_json(PKG / 'workloads' / ('%s.json' % name)))


def recipe_class(conf_file, conf):
    """The reference class that configuration ``conf`` (read from
    ``conf_file``) names in its ``reference``: '<path of a module from the
    checkout's root> <class>', the contract in reference/__init__.py.  The
    module is imported under the dotted name of its path, so that its
    relative imports resolve and its classes are those every other
    importer sees.  A configuration that names none, or a module or class
    that is not there, stops the run."""
    def stop(why):
        raise SystemExit('configuration %s: %s' % (conf_file, why))
    if 'reference' not in conf:
        stop('no "reference" (a module path and a class name)')
    words = str(conf['reference']).split()
    if len(words) != 2:
        stop('"reference" %r is not a module path and a class name'
             % (conf['reference'],))
    path = (ROOT / words[0]).resolve()
    if (path.suffix != '.py' or not path.is_file()
            or not path.is_relative_to(ROOT)):
        stop('no module %s in the checkout' % words[0])
    module = importlib.import_module(
        '.'.join(path.relative_to(ROOT).with_suffix('').parts))
    cls = getattr(module, words[1], None)
    if not isinstance(cls, type):
        stop('%s has no class %s' % (words[0], words[1]))
    return cls


def metric_specs(bench, name, kind):
    """The ``kind`` ('end_to_end' or 'per_layer') metrics cell ``name``
    reports."""
    return [m for m in bench[kind] if name in m.get('workloads', [name])]


def to_argv(flags):
    argv = []
    for k, v in flags.items():
        if v is True:
            argv.append('--' + k)
        elif v is False or v is None:
            continue
        elif isinstance(v, list):
            argv += ['--' + k] + [str(x) for x in v]
        else:
            argv += ['--' + k, str(v)]
    return argv


def split_channels(flags, host, device):
    """The reference's inputs of one host batch: {'A': label channels,
    'B': image channels}, NCHW float32 (--which_channel, AtoB)."""
    idx = {'r': 0, 'g': 1, 'b': 2}
    groups = [[idx[c] for c in g] for g in flags['which_channel'].split('_')]
    x = torch.from_numpy(host['A']).to(device)
    return {k: x[..., g].permute(0, 3, 1, 2).contiguous()
            for k, g in zip('AB', groups)}


def seeds(seed):
    """(program and draws, weights, images, pools) seeds of a run's
    --seed."""
    return seed, 4 * seed + 1, 4 * seed + 2, 4 * seed + 3


def pool_images(recipe, mix, seed, device):
    """{pool name: (size, C, H, W)} float32 images on ``device`` with the
    mix's statistics (traffic.draw): what both sides' pools start full
    of."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: traffic.draw(mix, (recipe.pool_size,) + tuple(shape), 1,
                               gen)
            for name, shape in recipe.pool_shapes().items()}


class Program:
    """The port's model of one configuration, as its train entry point
    builds it, with the seeded weights in place of its own init."""

    def __init__(self, flags, mix, seed, pool_seed, device, name):
        from supervised_gan_tpu_torch.models import create_model
        from supervised_gan_tpu_torch.models.base import disable_tf32
        from supervised_gan_tpu_torch.options import TrainOptions
        gpu = '-1' if device.type == 'cpu' else str(device.index or 0)
        argv = to_argv(flags) + [
            '--batchSize', str(mix['batch']), '--manualSeed', str(seed),
            '--gpu_ids', gpu, '--dataroot', str(RUN_DIR / 'no_images'),
            '--steps_per_dispatch',
            str(mix['steps_per_dispatch']), '--checkpoints_dir',
            str(RUN_DIR / 'checkpoints'), '--name', name, '--display_id',
            '0']
        disable_tf32()
        self.opt = TrainOptions().parse(argv)
        self.model = create_model(self.opt)
        # the pools' decisions: the generator the reference's pools draw
        # alike (reference/train.py Pool)
        self.model.pool_generator = torch.Generator().manual_seed(pool_seed)
        self.k = mix['steps_per_dispatch']

    def load(self, state):
        with torch.no_grad():
            for label, net in self.model.nets().items():
                net.load_state_dict(state[label], strict=True)

    def fill_pools(self, images):
        """Every pool full of ``images`` {pool name: (size, C, H, W)}."""
        for name, x in images.items():
            pool = self.model.pools[name]
            pool['images'].copy_(x)
            pool['num'] = pool['images'].shape[0]

    def dispatch(self, batches):
        """One call of train.py's dispatch, without its synchronize."""
        if self.k > 1:
            self.model.train_chunk(batches)
        else:
            self.model.set_input(batches[0])
            self.model.optimize_parameters()

    def params(self):
        return {'%s.%s' % (label, n): p
                for label, net in self.model.nets().items()
                for n, p in net.named_parameters()}

    def moments(self):
        keys = {p: k for k, p in self.params().items()}
        out = {}
        for opt in self.model.optimizers().values():
            for p, st in opt.state.items():
                if 'exp_avg' in st:
                    out[keys[p]] = st['exp_avg']
        return out

    def losses(self):
        return {k: float(v) for k, v in
                self.model.get_current_errors().items()}


def plant(program, fault):
    """Break the timed path underneath the harness (for the fault checks
    only): 'frozen' makes every optimizer step a no-op; 'batch0' feeds
    every step of a chunk the chunk's first batch."""
    model = program.model
    if fault == 'frozen':
        for opt in model.optimizers().values():
            opt.step = lambda *a, **k: None
    elif fault == 'batch0':
        inner = model.train_chunk_stacked

        def first_only(stacked, k):
            return inner({name: t[:1].expand_as(t).contiguous()
                          for name, t in stacked.items()}, k)
        model.train_chunk_stacked = first_only
    elif fault is not None:
        raise ValueError('unknown fault %r' % (fault,))


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class Run:
    """One run of cell ``name`` on ``device``.  ``flags``: changes to the
    configuration's flags (the CPU tests' narrow widths); ``fault``: see
    ``plant``."""

    def __init__(self, name, seed, device, flags=None, fault=None,
                 bench=None):
        self.bench = bench or benchmark()
        (self.cell, self.config, cfg, self.mix,
         checks) = lookup(self.bench, name)
        self.recipe = recipe_class(self.config['file'], cfg)
        self.limits = checks['limits']
        self.subsets = checks.get('subsets', {})
        self.name = name
        self.flags = dict(cfg['flags'], **(flags or {}))
        self.seed = seed
        self.device = torch.device(device)
        self.fault = fault
        self.batches = None
        self.cursor = 0
        self.sites = []
        self.build_s = 0.0

    # ------------------------------------------------------------ set-up -- #
    def next_batches(self, n):
        out = [self.batches[(self.cursor + i) % len(self.batches)]
               for i in range(n)]
        self.cursor += n
        return out

    def check_sizes(self):
        """The steps of each checked dispatch: the program's eager steps
        before it captures a chunk (models/base.py CAPTURE_AFTER), one
        batch each, then one dispatch of the window's size."""
        from supervised_gan_tpu_torch.models.base import CAPTURE_AFTER
        return [1] * CAPTURE_AFTER + [self.mix['steps_per_dispatch']]

    def setup(self, warmup=True):
        """Build, load, fill the pools, the checked steps, warm up; returns
        the program's readings."""
        cuda = self.device.type == 'cuda'
        if cuda:
            from supervised_gan_tpu_torch.ops.kernels import build
            t = time.perf_counter()
            if build.build_all():
                self.build_s = time.perf_counter() - t
        s_prog, s_w, s_img, s_pool = seeds(self.seed)
        self.program = Program(self.flags, self.mix, s_prog, s_pool,
                               self.device, 'portbench_' + self.name)
        plant(self.program, self.fault)
        ref = self.recipe(self.flags, self.device)
        start = weights.make(ref, s_w, self.device)
        self.program.load(start)
        self.program.fill_pools(pool_images(ref, self.mix, s_pool,
                                             self.device))
        del ref
        start = {'%s.%s' % (label, k): v for label, sd in start.items()
                 for k, v in sd.items()}
        self.batches = traffic.batches(self.mix, self.flags['fineSize'],
                                       s_img, self.device)
        readings = {'losses': []}
        from supervised_gan_tpu_torch.ops.kernels import functions
        for i, n in enumerate(self.check_sizes()):
            batches = self.next_batches(n)
            if i == 1 and cuda:
                with roofline.recording(functions,
                                        roofline.families()) as calls:
                    self.program.dispatch(batches)
                self.sites = calls
            else:
                self.program.dispatch(batches)
            readings['losses'].append(self.program.losses())
            if i == 0:
                readings['moments'] = check.norms(self.program.moments())
        params = self.program.params()
        readings['change'] = check.change(params, {k: start[k]
                                                   for k in params})
        del start
        for _ in range(self.mix['warmup_dispatches'] if warmup else 0):
            self.program.dispatch(
                self.next_batches(self.mix['steps_per_dispatch']))
        sync(self.device)
        return readings

    # ------------------------------------------------------------ window -- #
    def window(self, seconds):
        """Dispatches until ``seconds`` have passed; [(start, call returned,
        synchronized, steps)] on the host clock."""
        k = self.mix['steps_per_dispatch']
        out = []
        t_start = time.perf_counter()
        while True:
            batches = self.next_batches(k)
            t0 = time.perf_counter()
            self.program.dispatch(batches)
            t1 = time.perf_counter()
            sync(self.device)
            t2 = time.perf_counter()
            out.append((t0, t1, t2, k))
            if t2 - t_start >= seconds:
                return out

    def traced(self):
        """The mix's trace_dispatches dispatches under the profiler, each in
        the harness's spans; a trace.Summary."""
        k = self.mix['steps_per_dispatch']
        n = self.mix['trace_dispatches']

        def one():
            batches = self.next_batches(k)
            with torch.profiler.record_function(trace.DISPATCH_SPAN):
                with torch.profiler.record_function(trace.CALL_SPAN):
                    self.program.dispatch(batches)
                sync(self.device)

        graph = self.program.model._graph
        prof = trace.trace(one, n, None if graph is None
                           else trace.graph_kernels(graph.graph))
        return trace.Summary(prof, n * k)

    def finite(self):
        losses = self.program.losses()
        return all(v == v and abs(v) != float('inf') for v in losses.values())

    def free(self):
        del self.program
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # --------------------------------------------------------- reference -- #
    def reference(self, precision='f32'):
        """The reference's readings of the checked steps, from the same
        seeds, weights, pools, images and draws; ``precision`` 'fp8' gives
        the control's (reference/ctx.py)."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        s_prog, s_w, s_img, s_pool = seeds(self.seed)
        recipe = self.recipe(self.flags, self.device, s_pool)
        start = weights.make(recipe, s_w, self.device)
        recipe.fill_pools(pool_images(recipe, self.mix, s_pool, self.device))
        start = {'%s.%s' % (label, k): v for label, sd in start.items()
                 for k, v in sd.items()}
        if self.batches is None:
            self.batches = traffic.batches(self.mix, self.flags['fineSize'],
                                           s_img, self.device)
        dtype = (torch.bfloat16 if self.flags.get('compute_dtype')
                 == 'bfloat16' else torch.float32)
        ctx = Ctx(Draws(s_prog, self.device, dtype), precision)
        readings = {'losses': []}
        step = 0
        for n in self.check_sizes():
            for _ in range(n):
                batch = split_channels(self.flags, self.batches[step],
                                       self.device)
                losses = recipe.step(batch, ctx)
                step += 1
                if step == 1:
                    readings['moments'] = check.norms(
                        recipe.first_moments())
            readings['losses'].append({k: float(v.detach()) for k, v in
                                       losses.items()})
        readings['steps'] = list(itertools.accumulate(self.check_sizes()))
        params = recipe.named_params()
        readings['change'] = check.change(params, {k: start[k]
                                                   for k in params})
        return readings


# --------------------------------------------------------- the readers -- #
def reader(metric):
    path = PKG / 'metrics' / ('%s.py' % metric)
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Readings:
    """What a per-layer metric's reader reads: the window, the trace's
    summary, the recorded calls (``roofline.Site``, each with its family)
    and the families' device operations."""

    def __init__(self, run, window, summary, flops_per_step):
        self.batch = run.mix['batch']
        self.steps_per_dispatch = run.mix['steps_per_dispatch']
        self.window = window
        self.trace = summary
        self.sites = run.sites
        self.flops_per_step = flops_per_step
        self.device_names = {name: frozenset(fam.DEVICE_NAMES) for name, fam
                             in roofline.families().items()}
        self.hand_kernels = frozenset().union(*self.device_names.values())

    def window_s(self):
        return self.window[-1][2] - self.window[0][0]

    def window_steps(self):
        return sum(w[3] for w in self.window)

    def is_hand(self, name):
        """A device operation of one of the port's hand kernels, by the
        identifiers in its (demangled) name: any family's DEVICE_NAMES."""
        return not self.hand_kernels.isdisjoint(IDENT.findall(name))

    def family_sites(self, family):
        """The recorded calls of one family's entry points."""
        return [s for s in self.sites if s.family == family]

    def is_family(self, family, name):
        """A device operation of family ``family``'s kernels."""
        return not self.device_names[family].isdisjoint(IDENT.findall(name))


def step_flops(recipe, flags, batch):
    """FLOPs of one train step of reference class ``recipe`` at the cell's
    shapes, counted on the meta device (shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode
    on_meta = recipe(flags, 'meta')
    size = flags['fineSize']
    a_nc, b_nc = flags['input_nc'], flags['output_nc']
    x = {'A': torch.empty((batch, a_nc, size, size), device='meta'),
         'B': torch.empty((batch, b_nc, size, size), device='meta')}
    with FlopCounterMode(display=False) as counter:
        on_meta.step(x, Ctx(Draws(0, 'meta')))
    return float(counter.get_total_flops())


def end_to_end(window, batch, setup_s):
    """{metric: value} of the end-to-end metrics from the window."""
    steps = sum(w[3] for w in window)
    per_step = sorted((w[2] - w[0]) / w[3] * 1e3 for w in window)
    p90 = per_step[max(0, -(-9 * len(per_step) // 10) - 1)]
    return {'train_img_s': steps * batch / (window[-1][2] - window[0][0]),
            'step_ms_p90': p90, 'setup_s': setup_s}


FORBIDDEN = ('jax', 'jaxlib', 'flax', 'supervised_gan_tpu')


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules
                   if m.split('.')[0] in FORBIDDEN})


def process_start():
    """The process's start on the time.time() clock (/proc), or None."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return None
