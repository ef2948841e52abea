"""Training and sampling sinks (counterpart of supervised_gan_tpu/utils/
visualizer.py; reference util/visualizer.py:9-156): console and append-only
``checkpoints/<name>/loss_log.txt`` loss lines, the self-regenerating HTML
page of training images under ``checkpoints/<name>/web/``, the loss series
as ``plot_data.mat``, and the sampler's result images.  There is no visdom
display: the port never contacts a server."""

import os
import time

import numpy as np

from . import html
from .images import mkdirs, save_image


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.win_size = opt.display_winsize
        self.name = opt.name
        self.use_html = opt.isTrain and not getattr(opt, 'no_html', False)
        self.plot_data = None
        if self.use_html:
            self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, 'web')
            self.img_dir = os.path.join(self.web_dir, 'images')
            print('create web directory %s...' % self.web_dir)
            mkdirs([self.web_dir, self.img_dir])
        if opt.isTrain:
            self.log_name = os.path.join(opt.checkpoints_dir, opt.name,
                                         'loss_log.txt')
            with open(self.log_name, 'a') as log_file:
                log_file.write('================ Training Loss (%s) '
                               '================\n' % time.strftime('%c'))

    def display_current_results(self, visuals, epoch):
        if not self.use_html:
            return
        for label, image_numpy in visuals.items():
            save_image(image_numpy, os.path.join(
                self.img_dir, 'epoch%.3d_%s.png' % (epoch, label)))
        webpage = html.HTML(self.web_dir, 'Experiment name = %s' % self.name,
                            reflesh=1)
        for n in range(epoch, 0, -1):
            webpage.add_header('epoch [%d]' % n)
            ims = ['epoch%.3d_%s.png' % (n, label) for label in visuals]
            webpage.add_images(ims, list(visuals), ims, width=self.win_size)
        webpage.save()

    def plot_current_errors(self, epoch, counter_ratio, errors):
        """Append to the loss series and write it as plot_data.mat (the
        reference's .mat dump, util/visualizer.py:96-123)."""
        import scipy.io
        if self.plot_data is None:
            self.plot_data = {'X': [], 'Y': [], 'legend': list(errors.keys())}
        self.plot_data['X'].append(epoch + counter_ratio)
        self.plot_data['Y'].append([errors[k]
                                    for k in self.plot_data['legend']])
        scipy.io.savemat(
            os.path.join(self.opt.checkpoints_dir, self.name,
                         'plot_data.mat'),
            {'X': np.array(self.plot_data['X']),
             'Y': np.array(self.plot_data['Y']),
             'legend': self.plot_data['legend']})

    def print_current_errors(self, epoch, i, errors, t):
        message = '(epoch: %d, iters: %d, time: %.3f) ' % (epoch, i, t)
        for k, v in errors.items():
            message += '%s: %.3f ' % (k, v)
        print(message)
        with open(self.log_name, 'a') as log_file:
            log_file.write('%s\n' % message)

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
