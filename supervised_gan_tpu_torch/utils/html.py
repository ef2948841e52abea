"""Self-contained HTML report writer (copy of supervised_gan_tpu/utils/
html.py): ``<web_dir>/index.html`` plus an ``images/`` subdirectory, the
layout of the reference's dominate-based writer (util/html.py:6-49)."""

import os

from .images import mkdirs


class HTML:
    def __init__(self, web_dir, title, reflesh=0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(self.web_dir, 'images')
        self.reflesh = reflesh
        mkdirs([self.web_dir, self.img_dir])
        self._body = []

    def get_image_dir(self):
        return self.img_dir

    def add_header(self, str_):
        self._body.append('<h3>%s</h3>' % str_)

    def add_images(self, ims, txts, links, width=400):
        rows_img, rows_txt = [], []
        for im, txt, link in zip(ims, txts, links):
            rows_img.append(
                '<td halign="center" valign="top"><p>'
                '<a href="images/%s"><img style="width:%dpx" src="images/%s"/></a>'
                '</p></td>' % (link, width, im))
            rows_txt.append('<td halign="center" valign="top"><p>%s</p></td>'
                            % txt)
        self._body.append(
            '<table border="1" style="table-layout: fixed;">'
            '<tr>%s</tr><tr>%s</tr></table>'
            % (''.join(rows_img), ''.join(rows_txt)))

    def save(self):
        head = '<meta http-equiv="refresh" content="%d">' % self.reflesh \
            if self.reflesh > 0 else ''
        html = ('<!DOCTYPE html><html><head><title>%s</title>%s</head>'
                '<body>%s</body></html>'
                % (self.title, head, '\n'.join(self._body)))
        with open(os.path.join(self.web_dir, 'index.html'), 'wt') as f:
            f.write(html)
