"""Model recipe factory: the string dispatch of supervised_gan_tpu/models/
factory.py (reference models/models.py:2-44, plus cgan_causal, which the
JAX package registers).  In a process group every rank's networks start as
rank 0's (parallel/mesh.py broadcast_modules), as DDP's do.  Every recipe
trains under --spatial_mesh (parallel/spatial.py)."""

import torch

from .. import parallel
from ..utils.profile import timed


def create_model(opt):
    print(opt.model)
    if opt.model == 'fcgan':
        from .fcgan import FCGANModel
        model = FCGANModel()
    elif opt.model == 'cgan':
        from .cgan import CGANModel
        model = CGANModel()
    elif opt.model == 'cgan2':
        from .cgan2 import CGAN2Model
        model = CGAN2Model()
    elif opt.model == 'cgan_cycle':
        from .cgan_cycle import CGANCycleModel
        model = CGANCycleModel()
    elif opt.model == 'cgan2_cycle':
        from .cgan2_cycle import CGAN2CycleModel
        model = CGAN2CycleModel()
    elif opt.model == 'cgan_causal':
        from .cgan_causal import CGANCausalModel
        model = CGANCausalModel()
    elif opt.model == 'twostage':
        from .twostage import TwoStageModel
        model = TwoStageModel()
    elif opt.model == 'twostage_cycle':
        from .twostage_cycle import TwoStageCycleModel
        model = TwoStageCycleModel()
    elif opt.model == 'twostage_factd':
        from .twostage_factd import TwoStageFactDModel
        model = TwoStageFactDModel()
    elif opt.model == 'test':
        if opt.dataset_mode != 'single':
            raise ValueError('--model test needs --dataset_mode single')
        from .test_model import TestModel
        model = TestModel()
    elif opt.model == 'segmentation':
        from .segmentation import SegmentationModel
        model = SegmentationModel()
    elif opt.model == 'segmentation_cycle':
        from .segmentation_cycle import SegmentationCycleModel
        model = SegmentationCycleModel()
    else:
        raise ValueError("Model [%s] not recognized." % opt.model)
    with timed('models.init'):
        model.initialize(opt)
        parallel.broadcast_modules([v for v in vars(model).values()
                                    if isinstance(v, torch.nn.Module)])
    print("model [%s] was created" % model.name())
    return model
