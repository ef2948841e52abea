"""SegmentationCycle: the segmentation gate with a label -> image GAN and
an image -> label -> image cycle (reference models/segm_cycle_model.py).

Counterpart of supervised_gan_tpu/models/segmentation_cycle.py.  G1
(--which_model_netG1) gives class logits of the image A under the
segmentation head (models/segmentation.py: softmax and cross_entropy_2d,
or sigmoid and BCE); G2 (--which_model_netG2) maps the one-hot label B
back to an image, judged by the D2 bank on (B, image) pairs (the image
alone with --no_cgan), its fakes through ``pool2``.  The G loss
(reference :224-259):

  lambda_A * CE(G1(A) ~ B) + GAN(D2 on (B, G2(B)))
  + lambda_B * L1(softmax(G1(A)), B) + lambda_A_cycle * L1(G2(G1(A)), A)

(the reference's L1 between the prediction and the label, :257).  One Adam
over G1 (lr1) and G2 (lr2), one over D2 (lr2), the clamped three-rate
decay.  --sequential_train loads the nets named in --which_model_to_load
(G1, G2, D2) unless --continue_train.  The metrics, the val forward (noise
at --noiseSizeVal) and the test() of train_ss / test_ss are
SegmentationModel's, on G1.  Unlike the JAX package, a --continue_train
restores the full train state, as the port's segmentation recipe does.
"""

from collections import OrderedDict

import torch

from .base import BaseModel, adam, parse_which_channel, set_lr
from .common import alternate_updates, g_apply
from .pools import init_pool
from .segmentation import SegmentationModel
from .two_group import TwoGroupModel
from .. import nn
from ..nn.generators import activate
from ..nn.losses import gan_loss, weighted_l1_loss
from ..utils.images import tensor2im


class SegmentationCycleModel(SegmentationModel):
    STEP_OUTPUTS = ('_metrics', 'logit', 'fake_B', 'recon_A')
    METRICS_ORDER = ('G_CE', 'G_GAN')     # a train step's

    def name(self):
        return 'SegmentationCycleModel'

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
        self.use_D = False           # the D2 bank is this recipe's own
        self.old_lr = getattr(opt, 'lr', 0.0)
        self.old_lr1 = getattr(opt, 'lr1', 0.0)
        self.old_lr2 = getattr(opt, 'lr2', 0.0)

        self.netG1 = self._build_g(opt.input_nc, self.num_classes, '1')
        self.netG2 = self._build_g(self.num_classes, opt.input_nc, '2')
        if self.isTrain:
            self.netD2 = self.build_D_bank(self.pair_nc(), suffix='2')
            if opt.sequential_train and not opt.continue_train:
                self.load_sequential()
        if not self.isTrain or opt.continue_train:
            self.load_network(self.netG1, 'G1', opt.which_epoch)
            self.load_network(self.netG2, 'G2', opt.which_epoch)
            if self.isTrain:
                self.load_bank(self.netD2, 'D2_%d', opt.which_epoch)
        for net in self.nets().values():
            net.to(self.device)
            nn.set_noise_generator(net, self.noise_generator)

        if self.isTrain:
            self.optG = adam([(self.netG1.parameters(), self.old_lr1),
                              (self.netG2.parameters(), self.old_lr2)],
                             opt.beta1, self.device)
            self.optD2 = adam([(self.netD2.parameters(), self.old_lr2)],
                              opt.beta1, self.device)
            self.pools = {'pool2': init_pool(
                opt.pool_size, (self.pair_nc(), opt.fineSize, opt.fineSize),
                self.device)}
            if opt.continue_train:
                extra = self.load_full_state(opt.which_epoch, self.nets(),
                                             self.optimizers(), self.pools)
                if extra is not None:
                    self.old_lr = extra['lr']
                    self.old_lr1 = extra['lr1']
                    self.old_lr2 = extra['lr2']
                    self.apply_learning_rates()

        print('------------ Networks initialized -------------')
        nn.print_network(self.netG1, 'G1')
        nn.print_network(self.netG2, 'G2')
        if self.isTrain:
            for i, d in enumerate(self.netD2):
                nn.print_network(d, 'D2_%d' % i)
        print('-----------------------------------------------')

    def _build_g(self, in_nc, out_nc, sfx):
        """define_G from the suffixed block, no residual, the unet's skips
        from --n_layers_G<sfx>_skip (segmentation_cycle.py:40-55 there)."""
        o = self.opt

        def g(name):
            return getattr(o, name + sfx)

        return nn.define_G(
            in_nc, out_nc, g('ngf'), g('which_model_netG'), o.norm,
            not g('no_dropout'), n_layers_G=g('n_layers_G'),
            use_fcn=g('noiseSize') != 1, noise_nc=g('noise_nc'),
            add_gaussian_noise=o.add_gaussian_noise,
            gaussian_sigma=o.gaussian_sigma,
            upsample_mode=g('upsample_mode'),
            n_layers_CRN_block=g('n_layers_CRN_block'),
            share_label_weights=not g('no_share_label_block_weights'),
            use_residual=False,
            n_layers_G_skip=getattr(o, 'n_layers_G%s_skip' % sfx),
            generator=self.init_generator)

    def pair_nc(self):
        o = self.opt
        return o.input_nc if o.no_cgan else o.input_nc + self.num_classes

    def load_sequential(self):
        o = self.opt
        mdir, ep = o.pretrained_model_dir, o.which_epoch_sequential
        for label in ('G1', 'G2'):
            if label in o.which_model_to_load:
                self.load_network(getattr(self, 'net' + label), label, ep,
                                  mdir)
        if 'D2' in o.which_model_to_load:
            self.load_bank(self.netD2, 'D2_%d', ep, mdir)

    def nets(self):
        nets = OrderedDict([('G1', self.netG1), ('G2', self.netG2)])
        if self.isTrain:
            nets['D2'] = self.netD2
        return nets

    def optimizers(self):
        return {'G': self.optG, 'D2': self.optD2}

    def apply_learning_rates(self):
        if not self.isTrain:
            return
        for group, lr in zip(self.optG.param_groups,
                             (self.old_lr1, self.old_lr2)):
            set_lr(group, lr)
        set_lr(self.optD2.param_groups[0], self.old_lr2)

    # the clamped three-rate decay of the two-group recipes
    update_learning_rate = TwoGroupModel.update_learning_rate
    lrs = TwoGroupModel.lrs

    def pool_queries(self):
        return ['pool2'] * self.opt.n_update_D2

    # ---------------------------------------------------------- training -- #
    def _record(self):
        """G1(A) (logits and probabilities), G2(B), G2(G1(A)); noise1 and
        noise2 drawn first, in this order."""
        o = self.opt
        noise1 = self.noise((o.batchSize, o.noise_nc1, o.noiseSize1,
                             o.noiseSize1))
        noise2 = self.noise((o.batchSize, o.noise_nc2, o.noiseSize2,
                             o.noiseSize2))
        cd = self.compute_dtype
        logit = g_apply(self.netG1, self.input_A, noise1, cd,
                        activation='none')
        fake_B = activate(logit, self.act)
        return {'logit': logit, 'fake_B': fake_B,
                'fake_A': g_apply(self.netG2, self.input_B, noise2, cd),
                'recon_A': g_apply(self.netG2, fake_B, noise2, cd)}

    def update_D2(self, taps):
        lsgan = not self.opt.no_lsgan2
        fake = self.query_pool('pool2', self.pair(
            taps['fake_A'], self.input_B).detach())
        real = self.pair(self.input_A, self.input_B)
        lf = sum(gan_loss(o, False, lsgan)
                 for o in self.bank_apply(self.netD2, fake))
        lr = sum(gan_loss(o, True, lsgan)
                 for o in self.bank_apply(self.netD2, real))
        self._step(self.optD2, (lf + lr) * 0.5)

    def update_G(self, taps):
        o = self.opt
        lsgan = not o.no_lsgan2
        d_params = list(self.netD2.parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            outs = self.bank_apply(self.netD2, self.pair(
                taps['fake_A'], self.input_B))
            gan = sum(gan_loss(d, True, lsgan) * lam
                      for d, lam in zip(outs, o.lambda_D2))
            ce = self._ce(taps['logit'], taps['fake_B'], self.input_B,
                          self.label, weighted=True)
            l1 = weighted_l1_loss(taps['fake_B'], self.input_B)
            cyc = weighted_l1_loss(taps['recon_A'], self.input_A)
            total = (ce * o.lambda_A + gan + l1 * o.lambda_B
                     + cyc * o.lambda_A_cycle)
            params = list(self.netG1.parameters()) + list(
                self.netG2.parameters())
            # inert biases take no part in the forward: their grad is None
            grads = torch.autograd.grad(total, params, allow_unused=True)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        self.optG.zero_grad(set_to_none=True)
        for p, g in zip(params, grads):
            p.grad = g
        self.optG.step()
        return {'G_CE': ce.detach(), 'G_GAN': gan.detach()}

    def train_step(self):
        o = self.opt
        taps, _, metrics = alternate_updates(
            self._record, o.n_update_D2, self.update_D2, o.n_update_G,
            self.update_G)
        self._metrics = metrics
        self.logit = taps['logit'].detach()
        self.fake_B = taps['fake_B'].detach()
        self.recon_A = taps['recon_A'].detach()

    # ------------------------------------------------------- evaluation -- #
    def draw_noise(self, val=False):
        """G1's noise: --noiseSizeVal and --noise_nc in val mode, else
        --noiseSize1 and --noise_nc1 (segmentation_cycle.py:141-146
        there)."""
        o = self.opt
        s = o.noiseSizeVal if val else o.noiseSize1
        nc = o.noise_nc if val else o.noise_nc1
        return self.noise((o.batchSize, nc, s, s))

    def forward(self, val_mode=False):
        """G1 on the current input, no gradient."""
        with torch.no_grad():
            self.logit = g_apply(self.netG1, self.input_A,
                                 self.draw_noise(val_mode),
                                 self.compute_dtype, activation='none')
            self.fake_B = activate(self.logit, self.act)

    def get_current_visuals(self):
        out = SegmentationModel.get_current_visuals(self)
        if self.isTrain and hasattr(self, 'recon_A'):
            out['recon'] = tensor2im(self.recon_A)
        return out

    def save(self, label):
        self.save_network(self.netG1, 'G1', label)
        self.save_network(self.netG2, 'G2', label)
        self.save_bank(self.netD2, 'D2_%d', label)
        self.save_full_state(label, self.nets(), self.optimizers(),
                             self.pools, self.lrs())
