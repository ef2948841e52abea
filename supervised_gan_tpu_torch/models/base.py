"""BaseModel: the recipe protocol the drivers consume (counterpart of
supervised_gan_tpu/models/base.py; reference models/base_model.py:5-64).

It holds the device (``--gpu_ids``: ``cuda:<first id>``, or the CPU for
``-1``), sets the ops' kernel switch from ``--no_pallas`` (as the JAX
package's model init sets PALLAS_ENABLED), the compute dtype, and three
generators seeded from
``--manualSeed``: a CPU one for weight init, one on the device for every
noise draw and dropout mask, and a CPU one for the image pools' decisions.
They do not reproduce ``jax.random``'s numbers.

Checkpoints: ``<label>_net_<name>.pth`` per network (a CPU torch
``state_dict``, the format of the reference and of the JAX package), and
the port's own full train state ``<label>_state.pt`` (parameters, Adam
moments and steps, pools, learning rates and generator states) for an
exact ``--continue_train``.  ``build_G`` and ``build_D_bank`` build a
generator and a multi-scale discriminator bank from the plain or a
suffixed (``1``, ``2``) option block.  The JAX package's ``_state.pkl`` is a
different format and is not read.

Data parallelism (--data_mesh, parallel/mesh.py; JAX models/base.py:244-270,
533-543 there): in a process group each rank keeps its rows of the global
batch (``set_input``), of each global noise draw (``noise``) and of each
pooled batch (the pools stay replicated and see the gathered batch:
``query_pool``, ``sample_pool``); every Adam averages its gradients over the
ranks before it steps (``adam``), and a chunk runs its steps eagerly, one
by one, with no captured graph (as JAX runs chunks under a mesh).

Under --spatial_mesh (parallel/spatial.py) each step input, noise draw and
pooled batch of a sharded height is cut to the rank's rows too, after the
batch rows; each pool of a sharded height holds the rank's rows of its
images, applying the same decisions as every other rank (``query_pool``),
and a checkpoint stores them whole (``save_full_state`` inside
spatial.whole_pools, train.py ``save``).

The dispatch path carries the profiler spans of utils/profile.py (on only
while a profiler records): ``dispatch.train_chunk``; a ``dispatch.stage_inputs``
a batch (``set_input``'s, or each of a chunk's) holding its
``dispatch.host_inputs`` and ``dispatch.to_device``; ``dispatch.stage_rows``;
each eager ``train_step`` as the timed ``dispatch.eager_step``; and each of a
chunk's batches after the first, staged behind the step enqueued before it,
as the timed ``dispatch.stage_ahead`` (its count is how often a chunk's
staging overlaps the card's work).  Nothing inside ``train_step``: a
captured step holds nothing host-side.
"""

import os

import torch

from .graph import StepGraph
from .pools import (REJECT, decide, draw_decisions, pool_apply, pool_take,
                    sample_rows)
from .. import nn, parallel
from ..ops.kernels import set_kernels_enabled
from ..parallel import spatial
from ..utils import pth as pthio
from ..utils.profile import span, timed

# eager steps a model runs before a chunk captures its step: the first fills
# the kernels' libraries, the resampling constants and Adam's state
CAPTURE_AFTER = 2


def parse_which_channel(spec):
    """'rg_b' -> [[0, 1], [2]] (rgb indices per group)."""
    idx = {'r': 0, 'g': 1, 'b': 2}
    return [[idx[c] for c in group] for group in spec.split('_')]


def device_from_opt(gpu_ids):
    """The device --gpu_ids asks for.  A GPU that is not there raises: the
    drivers never carry on silently on the CPU."""
    if not gpu_ids:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('--gpu_ids %d asks for a CUDA device but none is '
                           'available; pass --gpu_ids -1 to run on the CPU'
                           % gpu_ids[0])
    return torch.device('cuda', gpu_ids[0])


def disable_tf32():
    """Float32 means float32 on both routes.  The kernels' f32 route is
    3xTF32, f32 accurate; cuDNN's convolutions and cuBLAS's matmuls would
    run an f32 input as one TF32 product (10-bit mantissa) by default, so a
    --no_pallas f32 step would be a TF32 step.  The entry points turn that
    off for both."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def adam(groups, beta1, device):
    """optax.scale_by_adam(b1=beta1, b2=0.999, eps=1e-8) with the learning
    rate applied per parameter group (models/base.py:179-218 there):
    torch's Adam computes the same function.  ``groups``: [(params, lr)].

    On a CUDA device it is capturable, with each group's rate a device
    tensor (``set_lr`` writes it in place), so a captured step holds it and
    a decayed rate needs no new capture; eager steps there run the same
    Adam.  In a process group it averages each group's gradients over the
    ranks before every step (parallel/mesh.py average_gradients), which
    covers the recipes that call ``.step()`` themselves."""
    cuda = device.type == 'cuda'
    opt = torch.optim.Adam(
        [{'params': list(p),
          'lr': torch.full((), lr, device=device) if cuda else lr}
         for p, lr in groups],
        betas=(beta1, 0.999), eps=1e-8, capturable=cuda)
    # eager steps run it uncaptured on purpose: no warning about that
    opt._warned_capturable_if_run_uncaptured = True
    parallel.average_gradients(opt)
    return opt


def set_lr(group, lr):
    """Write ``lr`` into an optimizer group: in place into its device tensor
    (which a captured step reads), else as a float."""
    if isinstance(group['lr'], torch.Tensor):
        group['lr'].fill_(lr)
    else:
        group['lr'] = lr


class BaseModel:
    # the attributes set_input sets and train_step reads, and those that
    # train_step sets and the driver reads (metrics, taps)
    STEP_INPUTS = ()
    STEP_OUTPUTS = ()

    def name(self):
        return type(self).__name__

    def initialize(self, opt):
        self.opt = opt
        self.isTrain = opt.isTrain
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.device = device_from_opt(opt.gpu_ids)
        if (opt.isTrain and getattr(opt, 'data_mesh', 0) > 1
                and parallel.world() != opt.data_mesh):
            raise RuntimeError(
                '--data_mesh %d trains in a process group of %d ranks, but '
                'this process is in %s: run it through the train or '
                'train_ss entry point (parallel.launch)'
                % (opt.data_mesh, opt.data_mesh,
                   'one of %d' % parallel.world() if parallel.active()
                   else 'none'))
        if (opt.isTrain and getattr(opt, 'spatial_mesh', 0) > 1
                and spatial.size() != opt.spatial_mesh):
            raise RuntimeError(
                '--spatial_mesh %d splits the height over %d ranks, but this '
                'process is not in such a group: run it through the train '
                'entry point (parallel.launch)'
                % (opt.spatial_mesh, opt.spatial_mesh))
        set_kernels_enabled(not opt.no_pallas)
        seed = opt.manualSeed if opt.manualSeed is not None else 0
        self.init_generator = torch.Generator().manual_seed(seed)
        self.noise_generator = torch.Generator(
            device=self.device).manual_seed(seed)
        self.pool_generator = torch.Generator().manual_seed(seed + 1)
        self.compute_dtype = (torch.bfloat16
                              if opt.compute_dtype == 'bfloat16'
                              else torch.float32)
        self.pools = {}
        self.sampled_pools = ()    # pools only read (models/pools.py)
        self.pool_rejects = {}     # a pool's rejection probability, if not
        #                            pools.REJECT (cgan2's --pool_reject_prob)
        self.steps_run = 0
        self._rows = None          # this step's pool rows, on the device
        self._graph = None         # the captured step (models/graph.py)
        self._stage_ahead = None   # train_chunk's stager of its later batches

    def noise_draw(self, shape):
        """N(0, 1) float32 noise of ``shape`` on the device from the seeded
        generator: the one draw ``noise`` makes."""
        return torch.randn(shape, generator=self.noise_generator,
                           device=self.device)

    def noise(self, shape, rows=True):
        """N(0, 1) noise of a global-batch ``shape`` (leading axis
        --batchSize): in a process group, this rank's rows of it; with
        ``rows`` False the whole draw (a replicated pool's)."""
        x = self.noise_draw(shape)
        if not rows:
            return x
        return spatial.cut(parallel.rows(x))

    # ----------------------------------------------------------- inputs -- #
    def host_inputs(self, input):
        """{STEP_INPUTS name: host tensor} of one loader batch; recipes
        define it (and set image_paths)."""
        raise NotImplementedError

    def to_device(self, t, out=None):
        """A host tensor on the model's device (copied into ``out``, a device
        tensor of its shape and dtype, where given); on a card through pinned
        memory, without synchronizing the host."""
        if self.device.type == 'cuda':
            t = t.pin_memory()
        if out is None:
            return t.to(self.device, non_blocking=True)
        return out.copy_(t, non_blocking=True)

    def set_input(self, input):
        """The step inputs of one loader batch; in a process group this
        rank's rows of it, cut before the host copy."""
        with span('dispatch.stage_inputs'):
            with span('dispatch.host_inputs'):
                hosts = self.host_inputs(input)
            with span('dispatch.to_device'):
                for name, t in hosts.items():
                    t = parallel.rows(t)
                    h = t.shape[-2]
                    setattr(self, name, spatial.mark(
                        self.to_device(spatial.cut(t)), h))

    def get_image_paths(self):
        return self.image_paths

    def step_inputs(self):
        return {name: getattr(self, name) for name in self.STEP_INPUTS}

    # ------------------------------------------------------------ pools -- #
    def pool_queries(self):
        """The pools a train step queries or samples (``sampled_pools``), in
        order, each for a batch of --batchSize images; recipes with pools
        define it."""
        return []

    def stage_rows(self, k):
        """The pool rows (models/pools.py decide, sample_rows) of the next
        k steps, drawn on the host in the order k eager steps draw them, as
        one (k, Q, 3) tensor on the device (one copy); None when no pool is
        queried."""
        with span('dispatch.stage_rows'):
            rows = []
            n = self.opt.batchSize
            for _ in range(k):
                for name in self.pool_queries():
                    pool = self.pools[name]
                    if pool is None:
                        continue
                    if name in self.sampled_pools:
                        rows += sample_rows(pool, n, self.pool_generator)
                    else:
                        rows += decide(pool, draw_decisions(
                            pool, n, self.pool_generator),
                            self.pool_rejects.get(name, REJECT))
            if not rows:
                return None
            return self.to_device(torch.tensor(
                rows, dtype=torch.int64)).view(k, -1, 3)

    def _next_rows(self, name, n):
        if self._rows is None or self._rows.shape[0] < n:
            raise RuntimeError('%s: no pool rows staged for this query; run '
                               'steps through optimize_parameters or '
                               'train_chunk' % name)
        rows, self._rows = self._rows[:n], self._rows[n:]
        return rows

    def query_pool(self, name, batch):
        """The pooled batch of pool ``name``: the next rows of this step.  In
        a process group the pool is replicated: every rank applies the rows
        to the gathered global batch and keeps its own rows of the result."""
        pool = self.pools[name]
        if pool is None:
            return batch
        h = spatial.height(batch)
        batch = parallel.gather_rows(batch.detach().to(pool['images'].dtype))
        return spatial.mark(parallel.rows(pool_apply(
            pool, batch, self._next_rows(name, batch.shape[0]))), h)

    def sample_pool(self, name):
        """--batchSize stored images of the sampled pool ``name``, at the
        next rows of this step (this rank's rows of them in a group)."""
        return parallel.rows(pool_take(
            self.pools[name], self._next_rows(name, self.opt.batchSize)))

    # --------------------------------------------------------- training -- #
    def train_step(self):
        """One iteration on the step inputs and the staged pool rows; recipes
        define it.  It must not synchronize the host with the device: no
        host copy, no .item(), no branch on a device value (a captured CUDA
        graph holds it)."""
        raise NotImplementedError

    def _step(self, optimizer, loss):
        """One optimizer update on ``loss``'s gradients."""
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()

    def optimize_parameters(self):
        """One training iteration on the current input."""
        rows = self.stage_rows(1)
        self._rows = None if rows is None else rows[0]
        with timed('dispatch.eager_step'):
            self.train_step()
        self.steps_run += 1

    def train_chunk(self, batches):
        """len(batches) iterations: the same as set_input(b);
        optimize_parameters() for each b in turn (the same draws, the same
        final state; metrics and taps are the last step's), with the
        batches staged into one device stack (JAX models/base.py:298 there):
        the first before the chunk's pool rows and its first step, each
        later one behind the step before it, so that on a card the host
        stages batch i + 1 while the card runs step i.  In a process group:
        set_input and optimize_parameters for each batch, no graph (JAX
        models/base.py:304-310 there)."""
        with span('dispatch.train_chunk'):
            if parallel.active():
                for b in batches:
                    self.set_input(b)
                    self.optimize_parameters()
                return
            k = len(batches)
            stacked = {}
            self._stage_batch(stacked, k, 0, batches[0])

            def ahead(i):
                with timed('dispatch.stage_ahead'):
                    self._stage_batch(stacked, k, i, batches[i])
            self._stage_ahead = ahead
            try:
                self.train_chunk_stacked(stacked, k)
            finally:
                self._stage_ahead = None

    def _stage_batch(self, stacked, k, i, batch):
        """Loader batch ``batch`` into slot i of the chunk's device stacks
        ``stacked`` ({STEP_INPUTS name: (k, ...) tensor}, allocated from
        slot 0's shapes)."""
        with span('dispatch.stage_inputs'):
            with span('dispatch.host_inputs'):
                hosts = self.host_inputs(batch)
            with span('dispatch.to_device'):
                for name, t in hosts.items():
                    if i == 0:
                        stacked[name] = torch.empty(
                            (k,) + t.shape, dtype=t.dtype, device=self.device)
                    slot = stacked[name][i]
                    if t.shape != slot.shape or t.dtype != slot.dtype:
                        raise RuntimeError(
                            'train_chunk: batch %d of the chunk gives %s a '
                            '%s %s tensor, batch 0 a %s %s one' % (
                                i, name, tuple(t.shape), t.dtype,
                                tuple(slot.shape), slot.dtype))
                    self.to_device(t, slot)

    def train_chunk_stacked(self, stacked, k):
        """k iterations whose inputs lie on the device stacked on the leading
        axis ({STEP_INPUTS name: (k, ...) tensor}).  On a card, once the model
        has run CAPTURE_AFTER eager steps, each is a replay of the captured
        step (models/graph.py; one graph of one step, whatever k), with no
        synchronize; before that, and on the CPU, an eager step.  A capture
        or replay that fails raises.  Inside train_chunk, slot i + 1 of the
        stacks is staged right after step i is enqueued (its stager, set
        for the call); called alone, every slot is staged already."""
        ahead = self._stage_ahead
        rows = self.stage_rows(k)
        cuda = self.device.type == 'cuda'
        for i in range(k):
            inputs = {name: t[i] for name, t in stacked.items()}
            step_rows = None if rows is None else rows[i]
            if cuda and (self._graph is not None
                         or self.steps_run >= CAPTURE_AFTER):
                if self._graph is None:
                    self._graph = StepGraph(self, inputs, step_rows)
                self._graph.replay(self, inputs, step_rows)
            else:
                for name, t in inputs.items():
                    setattr(self, name, t)
                self._rows = step_rows
                with timed('dispatch.eager_step'):
                    self.train_step()
            self.steps_run += 1
            if ahead is not None and i + 1 < k:
                ahead(i + 1)

    def graph_kernels(self):
        """Kernel nodes in the captured step (None before a capture): what
        a trace of its replays records a replay."""
        return None if self._graph is None else self._graph.kernels

    # ------------------------------------------------------ checkpoints -- #
    def _net_path(self, network_label, epoch_label, model_dir=''):
        d = model_dir or self.save_dir
        return os.path.join(d, '%s_net_%s.pth' % (epoch_label, network_label))

    def load_network(self, net, network_label, epoch_label, model_dir=''):
        # explicit model_dir wins, else save_dir (reference base_model.py:55-61)
        path = self._net_path(network_label, epoch_label, model_dir)
        print('loading %s' % path)
        return pthio.load_pth(path, net)

    def save_network(self, net, network_label, epoch_label):
        pthio.save_pth(self._net_path(network_label, epoch_label), net)

    def build_G(self, in_nc, out_nc, suffix=''):
        """define_G from the (optionally suffixed) architecture options,
        weights drawn from the seeded init generator."""
        o = self.opt

        def g(name, default=None):
            return getattr(o, name + suffix, default)

        return nn.define_G(
            in_nc, out_nc, g('ngf'), g('which_model_netG'), o.norm,
            not g('no_dropout'), n_layers_G=g('n_layers_G'),
            use_fcn=g('noiseSize') != 1, noise_nc=g('noise_nc'),
            add_gaussian_noise=o.add_gaussian_noise,
            gaussian_sigma=o.gaussian_sigma,
            upsample_mode=g('upsample_mode'),
            n_layers_CRN_block=g('n_layers_CRN_block'),
            share_label_weights=not g('no_share_label_block_weights'),
            use_residual=bool(g('use_residual')),
            n_layers_G_skip=g('n_layers_G_skip', -1),
            generator=self.init_generator)

    def build_D_bank(self, input_nc, suffix='', num_classes=2):
        """The multi-scale discriminator bank of a suffixed option block, as
        a ModuleList (reference fcgan_model.py:78); ``num_classes`` 3 gives
        each D a 3-class logit head (--use_multi_class_GAN)."""
        o = self.opt

        def g(name):
            return getattr(o, name + suffix)

        if not (len(g('scale_factor')) == len(g('lambda_D'))
                == len(g('n_layers_D'))):
            raise ValueError('--scale_factor%s, --lambda_D%s and '
                             '--n_layers_D%s must have one length'
                             % (suffix, suffix, suffix))
        return torch.nn.ModuleList(
            nn.define_D(input_nc, g('ndf'), g('which_model_netD'),
                        n_layers_D=n_layers, norm=o.norm,
                        use_sigmoid=g('no_lsgan'), scale_factor=scale,
                        num_classes=num_classes,
                        generator=self.init_generator)
            for scale, n_layers in zip(g('scale_factor'), g('n_layers_D')))

    def bank_apply(self, bank, x):
        """Every discriminator of a bank on x, in the compute dtype."""
        return [d(x, self.compute_dtype) for d in bank]

    def load_bank(self, bank, label_fmt, epoch, model_dir=''):
        for i, d in enumerate(bank):
            self.load_network(d, label_fmt % i, epoch, model_dir)

    def save_bank(self, bank, label_fmt, epoch_label):
        for i, d in enumerate(bank):
            self.save_network(d, label_fmt % i, epoch_label)

    def _state_path(self, epoch_label):
        return os.path.join(self.save_dir, '%s_state.pt' % epoch_label)

    def save_full_state(self, epoch_label, nets, optimizers, pools, extra):
        """nets / optimizers / pools: dicts by name; extra: plain values."""
        payload = {
            'params': {k: {n: v.detach().cpu() for n, v in
                           net.state_dict().items()}
                       for k, net in nets.items()},
            'optim': {k: _optim_state(o) for k, o in optimizers.items()},
            'pools': {k: None if p is None else
                      {'images': p['images'].cpu(), 'num': p['num']}
                      for k, p in pools.items()},
            'generators': {'noise': self.noise_generator.get_state(),
                           'pool': self.pool_generator.get_state()},
            'extra': dict(extra)}
        torch.save(payload, self._state_path(epoch_label))

    def load_full_state(self, epoch_label, nets, optimizers, pools):
        """Restore what save_full_state wrote, in place; returns its
        ``extra`` dict, or None when there is no state file."""
        path = self._state_path(epoch_label)
        if not os.path.exists(path):
            return None
        print('loading %s' % path)
        payload = torch.load(path, map_location='cpu', weights_only=True)
        for k, net in nets.items():
            net.load_state_dict(payload['params'][k], strict=True)
        for k, o in optimizers.items():
            _load_optim_state(o, payload['optim'][k])
        self._graph = None             # it held the replaced Adam state
        for k, p in pools.items():
            saved = payload['pools'][k]
            if p is not None:
                p['images'].copy_(spatial.cut(saved['images']))
                p['num'] = saved['num']
        self.noise_generator.set_state(payload['generators']['noise'])
        self.pool_generator.set_state(payload['generators']['pool'])
        return payload['extra']


def _optim_state(o):
    """An optimizer's state_dict with each group's rate as a float."""
    sd = o.state_dict()
    for g in sd['param_groups']:
        g['lr'] = float(g['lr'])
    return sd


def _load_optim_state(o, sd):
    """load_state_dict that keeps this optimizer's own group settings
    (capturable or not, the rate's device tensor) and takes the saved rate
    into them; a capturable Adam's steps go to the parameters' device."""
    own = [{k: v for k, v in g.items() if k != 'params'}
           for g in o.param_groups]
    o.load_state_dict(sd)
    for g, mine in zip(o.param_groups, own):
        lr = float(g['lr'])
        g.update(mine)
        set_lr(g, lr)
        if g['capturable']:
            for p in g['params']:
                st = o.state.get(p)
                if st and 'step' in st:
                    st['step'] = st['step'].to(p.device, torch.float32)
