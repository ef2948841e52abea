"""Result-image writer: the ``save_images`` part of supervised_gan_tpu/
utils/visualizer.py (reference util/visualizer.py:143-156).  The training
sinks (loss log, visdom, .mat dumps) come with the training slice."""

import os

from .images import save_image


class Visualizer:
    def __init__(self, opt):
        self.win_size = opt.display_winsize

    def save_images(self, webpage, visuals, image_path):
        image_dir = webpage.get_image_dir()
        short_path = os.path.basename(image_path[0])
        name = os.path.splitext(short_path)[0]

        webpage.add_header(name)
        ims, txts, links = [], [], []
        for label, image_numpy in visuals.items():
            image_name = '%s_%s.png' % (name, label)
            save_image(image_numpy, os.path.join(image_dir, image_name))
            ims.append(image_name)
            txts.append(label)
            links.append(image_name)
        webpage.add_images(ims, txts, links, width=self.win_size)
