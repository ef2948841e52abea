"""Network factory: the string registry of supervised_gan_tpu/nn/factory.py
(`define_G` :22, `define_D` :66), every name it builds, with the same
arguments."""

from .core import BatchNorm2d, InstanceNorm2d, count_params, init_weights
from . import discriminators as D
from . import generators as G

def get_norm_layer(norm_type='instance'):
    if norm_type == 'batch':
        return BatchNorm2d
    if norm_type == 'instance':
        return InstanceNorm2d
    raise NotImplementedError('normalization layer [%s] is not found' % norm_type)


def define_G(input_nc, output_nc, ngf, which_model_netG, norm='batch',
             use_dropout=False, n_layers_G=5, use_fcn=False, noise_nc=0,
             add_gaussian_noise=False, gaussian_sigma=0.1,
             upsample_mode='convt', share_label_weights=True,
             n_layers_CRN_block=1, use_residual=False, n_layers_G_skip=-1,
             generator=None):
    """Build a generator; with ``generator`` (a CPU torch.Generator) its
    weights are initialized from it, else they are left uninitialized for
    a checkpoint to fill."""
    norm_layer = get_norm_layer(norm)
    if which_model_netG in ('resnet_9blocks', 'resnet_6blocks'):
        net = G.ResnetGenerator(
            input_nc, output_nc, ngf, norm_layer, use_dropout,
            9 if which_model_netG == 'resnet_9blocks' else 6, use_residual)
    elif which_model_netG == 'crn':
        net = G.CascadedRefinementNetwork(
            input_nc, output_nc, noise_nc, ngf=ngf, n_layers=n_layers_G,
            norm_layer=norm_layer, upsample_mode=upsample_mode,
            add_gaussian_noise=add_gaussian_noise,
            gaussian_sigma=gaussian_sigma,
            share_label_weights=share_label_weights,
            n_layers_block=n_layers_CRN_block)
    elif which_model_netG in ('unet_128', 'unet_256'):
        net = G.UnetGenerator(
            input_nc, output_nc, 7 if which_model_netG == 'unet_128' else 8,
            ngf, norm_layer, use_dropout, use_residual, add_gaussian_noise,
            gaussian_sigma, n_layers_G_skip)
    elif which_model_netG in ('fcgan', 'deconv'):
        net = G.FCGANGenerator(noise_nc, input_nc, ngf, n_layers=n_layers_G,
                               use_dropout=use_dropout, use_fcn=use_fcn)
    elif which_model_netG == 'autoencoder':
        net = G.AutoEncoder(input_nc, output_nc, n_layers_G, ngf, norm_layer,
                            use_dropout)
    elif which_model_netG == 'fcgan_star':
        net = G.FCGANGeneratorStar(noise_nc, input_nc, ngf,
                                   n_layers=n_layers_G,
                                   use_dropout=use_dropout, use_fcn=use_fcn)
    elif which_model_netG == 'dcgan':
        net = G.DCGANGenerator(nz=noise_nc, nc=input_nc, ngf=ngf)
    else:
        raise NotImplementedError(
            'Generator model name [%s] is not recognized' % which_model_netG)
    if generator is not None:
        init_weights(net, generator)
    return net


def define_D(input_nc, ndf, which_model_netD, n_layers_D=3, norm='batch',
             use_sigmoid=False, scale_factor=1, num_classes=2,
             generator=None):
    """Build a discriminator; ``generator`` as in define_G."""
    norm_layer = get_norm_layer(norm)
    if which_model_netD in ('basic', 'n_layers'):
        n_layers = 3 if which_model_netD == 'basic' else n_layers_D
        net = D.NLayerDiscriminator(input_nc, ndf, n_layers, norm_layer,
                                    use_sigmoid, scale_factor, num_classes)
    elif which_model_netD == 'n_layers_sep':
        net = D.NLayerDiscriminatorSep(input_nc, ndf, n_layers_D, norm_layer,
                                       use_sigmoid, scale_factor, num_classes)
    elif which_model_netD == 'dcgan':
        net = D.DCGANDiscriminator(nc=input_nc, ndf=ndf)
    else:
        raise NotImplementedError(
            'Discriminator model name [%s] is not recognized'
            % which_model_netD)
    if generator is not None:
        init_weights(net, generator)
    return net


def print_network(net, name=''):
    """Parameter accounting, as the JAX package prints it."""
    n = count_params(net)
    print('%s[%s] Total number of parameters: %d'
          % (name and name + ' ', type(net).__name__, n))
    return n
