"""Host-side async prefetch loader: a copy of supervised_gan_tpu/data/
loader.py.

Replaces the reference's multiprocess ``torch.utils.data.DataLoader``
(data/custom_dataset_data_loader.py:31-35) with a thread-pool prefetcher:
the native PNG decode (data/native_io.py), PIL and the augmentation
release the GIL, the queue keeps a couple of batches ahead of the device,
and epoch shuffling is a seeded permutation so the stream is reproducible
under --manualSeed.  ``--no_native_io`` switches the native decoder off
for the process, as in the JAX loader.

Yields dicts of stacked numpy arrays: {'A': (B,H,W,3) float32, 'A_paths':
[str], ...} — NHWC; the model's set_input moves them to the device as NCHW.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .datasets import CreateDataset


def _collate(samples):
    batch = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals, 0)
        else:
            batch[k] = vals
    return batch


class DataLoader:
    def __init__(self, opt):
        self.opt = opt
        if getattr(opt, 'no_native_io', False):
            from . import transforms
            transforms._NATIVE_IO = False
        self.dataset = CreateDataset(opt)
        self.batch_size = opt.batchSize
        self.serial = opt.serial_batches
        self.seed = opt.manualSeed if opt.manualSeed is not None else 0
        self.num_workers = max(int(opt.nThreads), 1)
        self._epoch = 0

    def __len__(self):
        return int(min(len(self.dataset), self.opt.max_dataset_size))

    def load_data(self):
        return self

    def __iter__(self):
        self._epoch += 1
        n = len(self)
        if self.serial:
            order = np.arange(n)
        else:
            order = np.random.RandomState(
                (self.seed + self._epoch) % (2 ** 31)).permutation(n)

        def fetch(idx):
            rng = np.random.default_rng(
                (self.seed * 1000003 + self._epoch * 131071 + int(idx))
                % (2 ** 63))
            return self.dataset.get(int(idx), rng)

        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # keep up to 4 batches in flight
            pending = []
            it = iter(batches)
            for _ in range(4):
                b = next(it, None)
                if b is None:
                    break
                pending.append([pool.submit(fetch, i) for i in b])
            while pending:
                futures = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append([pool.submit(fetch, i) for i in b])
                yield _collate([f.result() for f in futures])


def CreateDataLoader(opt):
    loader = DataLoader(opt)
    print('CustomDatasetDataLoader')
    return loader
