"""Testing options: a copy of supervised_gan_tpu/options/test_options.py
(reference options/test_options.py:4-14)."""

from .base_options import BaseOptions


class TestOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self.parser
        p.add_argument('--ntest', type=int, default=float("inf"), help='# of test examples')
        p.add_argument('--results_dir', type=str, default='./results/', help='results are saved here')
        p.add_argument('--aspect_ratio', type=float, default=1.0, help='aspect ratio of result images')
        p.add_argument('--phase', type=str, default='test', help='train, val, test, etc')
        p.add_argument('--which_epoch', type=str, default='latest', help='checkpoint label to load')
        p.add_argument('--how_many', type=int, default=50, help='how many test images to run')
        p.add_argument('--save_as_single_image', action='store_true')
        self.isTrain = False
