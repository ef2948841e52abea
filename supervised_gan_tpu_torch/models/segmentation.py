"""Segmentation: image -> per-pixel classes, the downstream evaluation gate
(reference models/segm_model.py).

Counterpart of supervised_gan_tpu/models/segmentation.py.  G
(--which_model_netG) gives logits over the classes (the label channels,
plus a background class with --add_background_onehot); the head is a
softmax with cross_entropy_2d (per-class --weights), or with
--use_sigmoid_ss a sigmoid with the (weighted) BCE.  With
--which_model_netD other than None a D bank judges cat(A, probabilities)
pairs and G adds the GAN loss (no logD option: the reference's log D).

The labels are made on the host from the loader's batch
(``onehot_label_input``, numpy: background pixels tie on every label
channel, so the argmax takes the first maximum).  The streaming metrics
(the confusion matrix -> pixelAcc / meanAcc / meanIU, the Rand F-score)
are host numpy, read from the step's outputs after the step
(``accum_accs``), never inside it; train_ss and test_ss drive the
reset_accs / accum_accs / get_current_accs protocol.  Under --spatial_mesh
they read whole maps: every sp rank gathers the rows of the maps they read
(``whole``), so each rank's metrics are its data row's, as RandScore is a
score over whole images.
"""

from collections import OrderedDict

import numpy as np
import torch

from .base import BaseModel, adam, parse_which_channel, set_lr
from .common import PairDiscriminator, alternate_updates, g_apply
from .pools import init_pool
from .. import nn
from ..nn.generators import activate
from ..nn.losses import cross_entropy_2d, gan_loss, seg_bce_loss
from ..parallel import spatial
from ..utils.images import tensor2im
from ..utils.metrics import compute_rand_f_scores


def _nhwc(t):
    """NCHW tensor -> NHWC float32 numpy (a host copy)."""
    return t.detach().float().cpu().numpy().transpose(0, 2, 3, 1)


class SegAccumulatorMixin:
    """reset_accs / accum_accs / get_current_accs (reference
    segm_model.py:282-341), on the host."""

    def reset_accs(self):
        self.confusion = 0
        self.numAveragedImages = 0
        self.numAveragedPixels = 0
        self.RandScore = 0
        self.pixelAcc = 0
        self.meanAcc = 0
        self.meanIU = 0

    def whole(self, name):
        """The map ``name`` whole: gathered over the sp group where it is
        row-sharded (every sp rank calls it)."""
        return spatial.full(getattr(self, name))

    def accum_accs(self):
        if 'RandScore' in self.opt.which_metric:
            self.compute_current_rand_score()
        if 'meanIU' in self.opt.which_metric:
            self.compute_current_accuracy()

    def compute_current_rand_score(self):
        assert self.num_classes == 2
        # foreground = channel 0
        T = self.whole('real_B')[:, :1].detach().float().cpu().numpy()
        S = self.whole('fake_B')[:, :1].detach().float().cpu().numpy()
        ris = compute_rand_f_scores(S, T, do_thin=False)
        n = self.numAveragedImages
        m = n + ris.size
        self.numAveragedImages = m
        self.RandScore = (n * self.RandScore + ris.sum()) / m

    def compute_current_accuracy(self):
        if self.opt.add_background_onehot_acc:
            labels = _nhwc(self.whole('real_B'))
            labels = np.concatenate(
                [labels, 1.0 - np.minimum(1, labels.sum(-1, keepdims=True))],
                -1).argmax(-1).ravel()
            preds = _nhwc(self.whole('fake_B'))
            preds = np.concatenate(
                [preds, 1.0 - np.minimum(1, preds.sum(-1, keepdims=True))],
                -1).argmax(-1).ravel()
            plusone = 1
        else:
            labels = self.whole('label').cpu().numpy().ravel()
            preds = _nhwc(self.whole('logit')).argmax(-1).ravel()
            plusone = 0
        n_cls = self.num_classes + plusone
        num_pixels = labels.size
        conf = np.bincount(labels.astype(np.int64) * n_cls
                           + preds.astype(np.int64),
                           minlength=n_cls * n_cls).reshape(n_cls, n_cls)
        self.confusion = self.confusion + conf
        self.numAveragedPixels += num_pixels
        rel = np.sum(self.confusion, axis=1)
        sel = np.sum(self.confusion, axis=0)
        tp = np.diag(self.confusion)
        self.pixelAcc = tp.sum() / np.maximum(1, self.numAveragedPixels)
        self.meanAcc = np.mean(tp / np.maximum(1, rel))
        self.meanIU = np.mean(tp / np.maximum(1, rel + sel - tp))

    def get_current_accs(self):
        accs = []
        if 'RandScore' in self.opt.which_metric:
            accs.append(('RandScore', self.RandScore))
        if 'meanIU' in self.opt.which_metric:
            accs.append(('meanIU', self.meanIU))
        return OrderedDict(accs)

    def onehot_label_input(self, input_B):
        """[-1, 1] label channels, NHWC numpy -> ([0, 1] one-hot (+ the
        background), the argmax label)."""
        b = (input_B + 1) / 2.0
        if self.opt.add_background_onehot:
            bg = 1.0 - np.clip(b.sum(-1, keepdims=True), 0, 1)
            b = np.concatenate([b, bg], -1)
        label = b.argmax(-1)
        return b, label


class SegmentationModel(SegAccumulatorMixin, PairDiscriminator, BaseModel):
    STEP_INPUTS = ('input_A', 'input_B', 'label')
    STEP_OUTPUTS = ('_metrics', 'logit', 'fake_B')

    def name(self):
        return 'SegmentationModel'

    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        groups = parse_which_channel(opt.which_channel)
        if len(groups) != 2:
            raise ValueError('--which_channel must name two groups, got %r'
                             % opt.which_channel)
        self.groups = groups
        opt.input_nc = len(groups[0])
        opt.output_nc = len(groups[1])
        self.num_classes = opt.output_nc + 1 if opt.add_background_onehot \
            else opt.output_nc
        self.act = 'sigmoid' if opt.use_sigmoid_ss else 'softmax'
        self.class_weights = opt.weights
        self.use_D = opt.isTrain and opt.which_model_netD != 'None'
        self.old_lr = getattr(opt, 'lr', 0.0)

        self.netG = self.build_G(opt.input_nc, self.num_classes)
        if self.use_D:
            pair_nc = self.num_classes if opt.no_cgan \
                else self.num_classes + opt.input_nc
            self.netD = self.build_D_bank(pair_nc)
        if not self.isTrain or opt.continue_train:
            self.load_network(self.netG, 'G', opt.which_epoch)
            if self.use_D:
                self.load_bank(self.netD, 'D_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam([(self.netG.parameters(), self.old_lr)],
                             opt.beta1, self.device)
            if self.use_D:
                self.optD = adam([(self.netD.parameters(), self.old_lr)],
                                 opt.beta1, self.device)
                self.pools = {'fake': init_pool(
                    opt.pool_size, (pair_nc, opt.fineSize, opt.fineSize),
                    self.device)}
            if opt.continue_train:
                extra = self.load_full_state(opt.which_epoch, self.nets(),
                                             self.optimizers(), self.pools)
                if extra is not None:
                    self.old_lr = extra['lr']
                    self.apply_learning_rates()

        print('------------ Networks initialized -------------')
        nn.print_network(self.netG, 'G')
        if self.use_D:
            for i, d in enumerate(self.netD):
                nn.print_network(d, 'D_%d' % i)
        print('-----------------------------------------------')

    def nets(self):
        nets = OrderedDict([('G', self.netG)])
        if self.use_D:
            nets['D'] = self.netD
        return nets

    def optimizers(self):
        out = {'G': self.optG}
        if self.use_D:
            out['D'] = self.optD
        return out

    def pool_queries(self):
        return ['fake'] * self.opt.n_update_D if self.use_D else []

    # ----------------------------------------------------------- inputs -- #
    def host_inputs(self, input):
        AtoB = self.opt.which_direction == 'AtoB'
        g0, g1 = self.groups
        if self.opt.dataset_mode == 'aligned':
            a = input['A' if AtoB else 'B'][..., g0]
            b = input['B' if AtoB else 'A'][..., g1]
        elif self.opt.dataset_mode == 'single':
            a = input['A'][..., g0]
            b = input['A'][..., g1]
        else:
            raise NotImplementedError(
                'Dataset mode [%s] is not recognized' % self.opt.dataset_mode)
        onehot, label = self.onehot_label_input(b)
        self.image_paths = input['A_paths' if AtoB else 'B_paths']

        def nchw(arr):
            return torch.from_numpy(np.ascontiguousarray(
                arr, np.float32)).permute(0, 3, 1, 2).contiguous()
        return {'input_A': nchw(a), 'input_B': nchw(onehot),
                'label': torch.from_numpy(label.astype(np.int64))}

    # ---------------------------------------------------------- training -- #
    def draw_noise(self, val=False):
        o = self.opt
        s = o.noiseSizeVal if val else o.noiseSize
        return self.noise((o.batchSize, o.noise_nc, s, s))

    def _record(self, val=False):
        logit = g_apply(self.netG, self.input_A, self.draw_noise(val),
                        self.compute_dtype, activation='none')
        return {'logit': logit, 'fake_B': activate(logit, self.act)}

    def _ce(self, logit, fake_B, real_B, label, weighted):
        weights = self.class_weights if weighted else None
        if self.opt.use_sigmoid_ss:
            return seg_bce_loss(fake_B, real_B, weights)
        return cross_entropy_2d(logit, label, weights)

    def update_G(self, taps):
        """One G update (the D bank held fixed); returns its metrics."""
        o = self.opt
        d_params = list(self.netD.parameters()) if self.use_D else []
        for p in d_params:
            p.requires_grad_(False)
        try:
            ce = self._ce(taps['logit'], taps['fake_B'], self.input_B,
                          self.label, weighted=True)
            metrics = {'G_CE': ce}
            total = ce
            if self.use_D:
                outs = self.bank_apply(self.netD, self.pair(taps['fake_B']))
                gan = sum(gan_loss(d, True, not o.no_lsgan) * lam
                          for d, lam in zip(outs, o.lambda_D))
                metrics['G_GAN'] = gan
                total = gan + ce
            self._step(self.optG, total)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self):
        o = self.opt
        taps, _, metrics = alternate_updates(
            self._record, o.n_update_D if self.use_D else 0, self.update_D,
            o.n_update_G, self.update_G)
        self._metrics = metrics
        self.logit = taps['logit'].detach()
        self.fake_B = taps['fake_B'].detach()

    # what the metrics and visuals read: the step's or forward's inputs
    real_A = property(lambda self: self.input_A)
    real_B = property(lambda self: self.input_B)

    # ------------------------------------------------------- evaluation -- #
    def forward(self, val_mode=False):
        """G on the current input, no gradient: logits and probabilities
        (the noise at --noiseSizeVal in val mode)."""
        with torch.no_grad():
            taps = self._record(val_mode)
        self.logit, self.fake_B = taps['logit'], taps['fake_B']

    def test(self):
        self.forward(val_mode=False)

    def compute_cross_entropy_loss(self):
        """The unweighted CE (or BCE) of the last forward against its
        labels."""
        with torch.no_grad():
            ce = self._ce(self.logit, self.fake_B, self.real_B,
                          self.real_B.argmax(1), weighted=False)
        self._metrics = OrderedDict([('G_CE', ce)])

    def get_current_errors(self):
        return OrderedDict((k, float(v)) for k, v in self._metrics.items())

    def get_current_visuals(self):
        return OrderedDict([
            ('image', tensor2im(self.real_A)),
            ('label', tensor2im(self.real_B * 2 - 1)),
            ('prediction', tensor2im(self.fake_B * 2 - 1))])

    def save(self, label):
        self.save_network(self.netG, 'G', label)
        if self.use_D:
            self.save_bank(self.netD, 'D_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, {'lr': self.old_lr})

    def apply_learning_rates(self):
        for o in self.optimizers().values():
            set_lr(o.param_groups[0], self.old_lr)

    def update_learning_rate(self):
        """Linear decay by lr / niter_decay per epoch, not clamped at 0."""
        lr = self.old_lr - self.opt.lr / self.opt.niter_decay
        print('update learning rate: %f -> %f' % (self.old_lr, lr))
        self.old_lr = lr
        self.apply_learning_rates()
