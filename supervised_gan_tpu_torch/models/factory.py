"""Model recipe factory: the string dispatch of supervised_gan_tpu/models/
factory.py, for the recipes ported so far."""

_NOT_YET = ('cgan2', 'cgan_cycle', 'cgan2_cycle', 'cgan_causal', 'test',
            'segmentation_cycle')


def create_model(opt):
    print(opt.model)
    if opt.model == 'twostage_cycle':
        from .twostage_cycle import TwoStageCycleModel
        model = TwoStageCycleModel()
    elif opt.model == 'twostage':
        from .twostage import TwoStageModel
        model = TwoStageModel()
    elif opt.model == 'twostage_factd':
        from .twostage_factd import TwoStageFactDModel
        model = TwoStageFactDModel()
    elif opt.model == 'fcgan':
        from .fcgan import FCGANModel
        model = FCGANModel()
    elif opt.model == 'cgan':
        from .cgan import CGANModel
        model = CGANModel()
    elif opt.model == 'segmentation':
        from .segmentation import SegmentationModel
        model = SegmentationModel()
    elif opt.model in _NOT_YET:
        raise NotImplementedError('Model [%s] not yet ported' % opt.model)
    else:
        raise ValueError("Model [%s] not recognized." % opt.model)
    model.initialize(opt)
    print("model [%s] was created" % model.name())
    return model
