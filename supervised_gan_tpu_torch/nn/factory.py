"""Network factory: the string registry of supervised_gan_tpu/nn/factory.py
(`define_G` :22), for the generators ported so far."""

from .core import BatchNorm2d, InstanceNorm2d, count_params, init_weights
from . import generators as G

_NOT_YET = ('resnet_9blocks', 'resnet_6blocks', 'unet_128', 'unet_256',
            'autoencoder', 'fcgan_star', 'dcgan')


def get_norm_layer(norm_type='instance'):
    if norm_type == 'batch':
        return BatchNorm2d
    if norm_type == 'instance':
        return InstanceNorm2d
    raise NotImplementedError('normalization layer [%s] is not found' % norm_type)


def define_G(input_nc, output_nc, ngf, which_model_netG, norm='batch',
             use_dropout=False, n_layers_G=5, use_fcn=False, noise_nc=0,
             add_gaussian_noise=False, upsample_mode='convt',
             share_label_weights=True, n_layers_CRN_block=1, generator=None):
    """Build a generator; with ``generator`` (a CPU torch.Generator) its
    weights are initialized from it, else they are left uninitialized for
    a checkpoint to fill."""
    norm_layer = get_norm_layer(norm)
    if which_model_netG == 'crn':
        net = G.CascadedRefinementNetwork(
            input_nc, output_nc, noise_nc, ngf=ngf, n_layers=n_layers_G,
            norm_layer=norm_layer, upsample_mode=upsample_mode,
            add_gaussian_noise=add_gaussian_noise,
            share_label_weights=share_label_weights,
            n_layers_block=n_layers_CRN_block)
    elif which_model_netG in ('fcgan', 'deconv'):
        net = G.FCGANGenerator(noise_nc, input_nc, ngf, n_layers=n_layers_G,
                               use_dropout=use_dropout, use_fcn=use_fcn)
    elif which_model_netG in _NOT_YET:
        raise NotImplementedError(
            'Generator model name [%s] not yet ported' % which_model_netG)
    else:
        raise NotImplementedError(
            'Generator model name [%s] is not recognized' % which_model_netG)
    if generator is not None:
        init_weights(net, generator)
    return net


def print_network(net, name=''):
    """Parameter accounting, as the JAX package prints it."""
    n = count_params(net)
    print('%s[%s] Total number of parameters: %d'
          % (name and name + ' ', type(net).__name__, n))
    return n
