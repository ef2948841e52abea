"""Datasets: single / aligned / unaligned (reference data/*_dataset.py), a
copy of supervised_gan_tpu/data/datasets.py.

Each dataset's ``get(index, rng)`` returns a dict of HWC float32 arrays in
[-1,1] plus path strings.  The rng is supplied by the loader, derived from
(manualSeed, epoch, index) so augmentation is reproducible.
"""

import os

from .transforms import (build_transform, build_transform_parts, load_rgb,
                         make_dataset)

_CACHE_CAP_BYTES = 2 << 30      # stop caching past 2 GiB, keep streaming


class _DecodeCache:
    """Opt-in (--cache_data) RAM cache of the decode+resize prefix, keyed
    by path.  The recipe datasets are small (the VNC set is tens of
    images) and every epoch re-decodes and re-resizes the same files —
    on a 1-core host that makes the loader the bottleneck for 512px
    training (measured 33.5 img/s vs the chip's 36).  Augmentation
    (crop/flip/rot + normalize) stays per-sample and rng-driven, so
    cached and uncached pipelines are bit-identical."""

    def __init__(self):
        import threading
        self.store = {}
        self.bytes = 0
        self.full = False
        self._lock = threading.Lock()   # loader uses a thread pool

    def get(self, path, compute):
        with self._lock:
            arr = self.store.get(path)
        if arr is None:
            arr = compute()             # decode outside the lock
            with self._lock:
                if not self.full and path not in self.store:
                    if self.bytes + arr.nbytes > _CACHE_CAP_BYTES:
                        self.full = True
                        print('cache_data: cap (%d MiB) reached, further '
                              'images stream from disk'
                              % (_CACHE_CAP_BYTES >> 20))
                    else:
                        self.store[path] = arr
                        self.bytes += arr.nbytes
        return arr


class SingleDataset:
    """Images from <dataroot>/<phase>; the workhorse — the VNC data packs
    label+image into RGB channels of one PNG (reference data/single_dataset.py)."""

    def __init__(self, opt):
        self.opt = opt
        self.dir_A = os.path.join(opt.dataroot, opt.phase)
        self.A_paths = sorted(make_dataset(self.dir_A))
        self.transform = build_transform(opt, opt.isTrain)
        self._prefix, self._finish = build_transform_parts(opt, opt.isTrain)
        self._cache = _DecodeCache() if getattr(opt, 'cache_data',
                                                False) else None

    def __len__(self):
        return len(self.A_paths)

    def get(self, index, rng):
        path = self.A_paths[index]
        if self._cache is not None:
            arr8 = self._cache.get(path,
                                   lambda: self._prefix(load_rgb(path)))
            return {'A': self._finish(arr8, rng), 'A_paths': path}
        arr = self.transform(load_rgb(path), rng)
        return {'A': arr, 'A_paths': path}


class AlignedDataset:
    """pix2pix-style A|B side-by-side images: bicubic resize to
    (2*loadSize, loadSize), shared random crop window, coupled flip
    (reference data/aligned_dataset.py:10-50)."""

    def __init__(self, opt):
        from PIL import Image
        self.Image = Image
        self.opt = opt
        assert opt.resize_or_crop == 'resize_and_crop'
        self.dir_AB = os.path.join(opt.dataroot, opt.phase)
        self.AB_paths = sorted(make_dataset(self.dir_AB))
        self._cache = _DecodeCache() if getattr(opt, 'cache_data',
                                                False) else None

    def __len__(self):
        return len(self.AB_paths)

    def _decode(self, path):
        import numpy as np
        img = load_rgb(path).resize((self.opt.loadSize * 2,
                                     self.opt.loadSize), self.Image.BICUBIC)
        return np.asarray(img, dtype=np.uint8)

    def get(self, index, rng):
        import numpy as np
        opt = self.opt
        path = self.AB_paths[index]
        if self._cache is not None:
            ab = self._cache.get(path, lambda: self._decode(path))
        else:
            ab = self._decode(path)
        h, w_total = ab.shape[:2]
        w = w_total // 2
        # randint semantics of the reference: inclusive upper bound w-fineSize-1
        w_off = int(rng.integers(0, max(0, w - opt.fineSize - 1) + 1))
        h_off = int(rng.integers(0, max(0, h - opt.fineSize - 1) + 1))
        A = ab[h_off:h_off + opt.fineSize, w_off:w_off + opt.fineSize]
        B = ab[h_off:h_off + opt.fineSize, w + w_off:w + w_off + opt.fineSize]
        if not opt.no_flip and rng.random() < 0.5:
            A = A[:, ::-1]
            B = B[:, ::-1]
        # uint8 crop -> f32 normalize (per-pixel op commutes with the crop)
        A = np.ascontiguousarray(A.astype(np.float32) / 255.0 * 2.0 - 1.0)
        B = np.ascontiguousarray(B.astype(np.float32) / 255.0 * 2.0 - 1.0)
        return {'A': A, 'B': B, 'A_paths': path, 'B_paths': path}


class UnalignedDataset:
    """<phase>A / <phase>B directories with independent indices; the cgan2*
    recipes use the B side for pre-generated fake labels
    (reference data/unaligned_dataset.py:10-50)."""

    def __init__(self, opt):
        self.opt = opt
        self.dir_A = os.path.join(opt.dataroot, opt.phase + 'A')
        self.dir_B = os.path.join(opt.dataroot, opt.phase + 'B')
        self.A_paths = sorted(make_dataset(self.dir_A))
        self.B_paths = sorted(make_dataset(self.dir_B))
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        self.transform = build_transform(opt, opt.isTrain)
        self._prefix, self._finish = build_transform_parts(opt, opt.isTrain)
        self._cache = _DecodeCache() if getattr(opt, 'cache_data',
                                                False) else None

    def __len__(self):
        return max(self.A_size, self.B_size)

    def _load(self, path, rng):
        if self._cache is not None:
            arr8 = self._cache.get(path,
                                   lambda: self._prefix(load_rgb(path)))
            return self._finish(arr8, rng)
        return self.transform(load_rgb(path), rng)

    def get(self, index, rng):
        A_path = self.A_paths[index % self.A_size]
        B_path = self.B_paths[index % self.B_size]
        A = self._load(A_path, rng)
        B = self._load(B_path, rng)
        return {'A': A, 'B': B, 'A_paths': A_path, 'B_paths': B_path}

    def load_images(self, paths, rng=None):
        """Transform a list of image paths (reference unaligned_dataset.py:44-50)."""
        import numpy as np
        rng = rng or np.random.default_rng(0)
        return [self.transform(load_rgb(p), rng) for p in paths]


def CreateDataset(opt):
    if opt.dataset_mode == 'aligned':
        ds = AlignedDataset(opt)
    elif opt.dataset_mode == 'unaligned':
        ds = UnalignedDataset(opt)
    elif opt.dataset_mode == 'single':
        ds = SingleDataset(opt)
    else:
        raise ValueError("Dataset [%s] not recognized." % opt.dataset_mode)
    print("dataset [%s] was created" % type(ds).__name__)
    return ds
