"""The port's native PNG decoder (supervised_gan_tpu_torch/data/native_io.py
with csrc/dataio.cpp) against PIL and the JAX package's decoder: every
colour type and row filter in its scope bitwise, the files outside it
falling back to PIL, the switches that turn it off, a failed build raising,
and the loader's batches with the decoder on and off and against the JAX
loader."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from supervised_gan_tpu.data import CreateDataLoader as JCreateDataLoader
from supervised_gan_tpu.data import native_io as jnative_io
from supervised_gan_tpu.data import transforms as jtransforms
from supervised_gan_tpu.options import TrainOptions as JTrainOptions
from supervised_gan_tpu_torch.data import CreateDataLoader
from supervised_gan_tpu_torch.data import native_io
from supervised_gan_tpu_torch.data import transforms
from supervised_gan_tpu_torch.options import TrainOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def native_gate():
    """The decoder's switch is process-wide (--no_native_io clears it in
    both packages' loaders): put both back after each test."""
    saved = transforms._NATIVE_IO, jtransforms._NATIVE_IO
    yield
    transforms._NATIVE_IO, jtransforms._NATIVE_IO = saved


# ------------------------------------------------------- PNGs by hand -- #

def _chunk(tag, data):
    return (struct.pack('!I', len(data)) + tag + data
            + struct.pack('!I', zlib.crc32(tag + data) & 0xffffffff))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(row, prior, ftype, bpp):
    """One scanline under PNG filter ``ftype`` (RFC 2083 6.2-6.6)."""
    x = row.astype(np.int32)
    up = prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, ul)}[ftype]
    return ((x - pred) % 256).astype(np.uint8)


def write_png(path, raw, color_type, filters, palette=None, depth=8,
              interlace=0):
    """Write ``raw`` (H, W, channels) as a PNG of ``color_type``, row y
    filtered with ``filters[y % len(filters)]``.  ``interlace`` 1 writes
    the Adam7 passes, each row filtered with 0."""
    h, w = raw.shape[:2]
    flat = raw.reshape(h, -1)
    if depth == 16:
        flat = raw.astype('>u2').view(np.uint8).reshape(h, -1)
    bpp = flat.shape[1] // w
    if interlace:
        lines = []
        for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                               (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                               (1, 0, 2, 1)):
            sub = raw[y0::dy, x0::dx]
            if sub.size:
                lines += [b'\x00' + r.tobytes()
                          for r in sub.reshape(sub.shape[0], -1)]
        body = b''.join(lines)
    else:
        prior = np.zeros(flat.shape[1], np.uint8)
        lines = []
        for y in range(h):
            f = filters[y % len(filters)]
            lines.append(bytes([f])
                         + _filter_row(flat[y], prior, f, bpp).tobytes())
            prior = flat[y]
        body = b''.join(lines)
    parts = [b'\x89PNG\r\n\x1a\n',
             _chunk(b'IHDR', struct.pack('!2I5B', w, h, depth, color_type,
                                         0, 0, interlace))]
    if palette is not None:
        parts.append(_chunk(b'PLTE', palette.tobytes()))
    parts += [_chunk(b'IDAT', zlib.compress(body, 6)), _chunk(b'IEND', b'')]
    with open(path, 'wb') as f:
        f.write(b''.join(parts))


def _as_rgb(raw, color_type, palette=None):
    """The RGB pixels a decoder must give for ``raw``."""
    if color_type in (0, 4):
        return np.repeat(raw[..., :1], 3, -1)
    if color_type == 3:
        return palette[raw[..., 0]]
    return raw[..., :3]


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _raw(color_type, h, w, seed):
    rng = np.random.RandomState(seed)
    if color_type == 3:
        return rng.randint(0, 23, (h, w, 1)).astype(np.uint8)
    return rng.randint(0, 256, (h, w, CHANNELS[color_type])).astype(np.uint8)


def _palette(seed):
    return np.random.RandomState(seed + 100).randint(
        0, 256, (23, 3)).astype(np.uint8)


def assert_three_agree(path, want=None):
    """The port's decoder, PIL and the JAX decoder give the same pixels
    (and ``want`` where given)."""
    ours = native_io.decode_png(path)
    pil = np.asarray(Image.open(path).convert('RGB'))
    theirs = jnative_io.decode_png(path)
    assert ours is not None and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, pil)
    np.testing.assert_array_equal(ours, theirs)
    if want is not None:
        np.testing.assert_array_equal(ours, want)


# ------------------------------------------------------------- pixels -- #

@pytest.mark.parametrize('mode,shape', [
    ('L', (31, 57)), ('RGB', (63, 41, 3)), ('LA', (17, 29, 2)),
    ('RGBA', (23, 19, 4)), ('P', (21, 35, 3))])
def test_pil_written_colour_types(tmp_path, mode, shape):
    """Each colour type in scope, as PIL writes it, at odd sizes."""
    a = np.random.RandomState(len(shape) + shape[0]).randint(
        0, 256, shape).astype(np.uint8)
    img = (Image.fromarray(a).quantize(32) if mode == 'P'
           else Image.fromarray(a, mode=mode))
    p = str(tmp_path / ('%s.png' % mode))
    img.save(p)
    assert_three_agree(p)


@pytest.mark.parametrize('ftype', [0, 1, 2, 3, 4])
def test_each_row_filter(tmp_path, ftype):
    """Every row under one filter (RGB, 3 bytes a pixel)."""
    raw = _raw(2, 13, 27, ftype)
    p = str(tmp_path / ('f%d.png' % ftype))
    write_png(p, raw, 2, [ftype])
    assert_three_agree(p, raw)


@pytest.mark.parametrize('color_type', [0, 2, 3, 4, 6])
def test_filters_mixed_by_row_per_colour_type(tmp_path, color_type):
    """Rows cycling through filters 0-4 (the Sub, Average and Paeth
    neighbours at each colour type's bytes a pixel), odd sides."""
    raw = _raw(color_type, 19, 33, color_type)
    pal = _palette(color_type) if color_type == 3 else None
    p = str(tmp_path / ('c%d.png' % color_type))
    write_png(p, raw, color_type, [4, 0, 3, 1, 2, 4, 3], palette=pal)
    assert_three_agree(p, _as_rgb(raw, color_type, pal))


def test_split_idat_and_one_pixel(tmp_path):
    """A stream split over several IDAT chunks, and a 1 x 1 image."""
    raw = _raw(6, 9, 11, 5)
    p = str(tmp_path / 'split.png')
    write_png(p, raw, 6, [1, 4])
    data = open(p, 'rb').read()
    ihdr_end = 8 + 25
    (n,) = struct.unpack('!I', data[ihdr_end:ihdr_end + 4])
    body = data[ihdr_end + 8:ihdr_end + 8 + n]
    rest = data[ihdr_end + 12 + n:]
    with open(p, 'wb') as f:
        f.write(data[:ihdr_end] + _chunk(b'IDAT', body[:7])
                + _chunk(b'IDAT', body[7:20]) + _chunk(b'IDAT', body[20:])
                + rest)
    assert_three_agree(p, raw[..., :3])
    one = str(tmp_path / 'one.png')
    write_png(one, _raw(2, 1, 1, 6), 2, [4])
    assert_three_agree(one, _raw(2, 1, 1, 6))


# ------------------------------------------------------- out of scope -- #

def _out_of_scope(tmp_path, kind):
    p = str(tmp_path / ('%s.png' % kind))
    if kind == '16bit':
        raw = np.random.RandomState(7).randint(0, 65536, (13, 17, 3))
        write_png(p, raw.astype(np.uint16), 2, [0], depth=16)
    elif kind == 'interlaced':
        write_png(p, _raw(2, 19, 21, 8), 2, [0], interlace=1)
    elif kind == 'jpeg':
        Image.fromarray(_raw(2, 16, 16, 9)).save(p, format='JPEG')
    elif kind == 'bmp':
        Image.fromarray(_raw(2, 15, 9, 10)).save(p, format='BMP')
    return p


@pytest.mark.parametrize('kind', ['16bit', 'interlaced', 'jpeg', 'bmp'])
def test_out_of_scope_falls_back_to_pil(tmp_path, kind):
    """16-bit and interlaced PNGs and files that are not PNGs give None,
    as in JAX, and load_rgb then gives PIL's pixels."""
    p = _out_of_scope(tmp_path, kind)
    assert native_io.decode_png(p) is None
    assert jnative_io.decode_png(p) is None
    transforms._NATIVE_IO = True
    ours = transforms.load_rgb(p)
    np.testing.assert_array_equal(np.asarray(ours),
                                  np.asarray(Image.open(p).convert('RGB')))
    if kind == 'interlaced':
        np.testing.assert_array_equal(np.asarray(ours), _raw(2, 19, 21, 8))


def test_missing_file_gives_none(tmp_path):
    assert native_io.decode_png(str(tmp_path / 'missing.png')) is None


def test_load_rgb_takes_the_decoder(tmp_path, monkeypatch):
    """With the switch on, a PNG is decoded natively (PIL never opens it)
    and equals the pixels written."""
    raw = _raw(2, 32, 24, 11)
    p = str(tmp_path / 'x.png')
    Image.fromarray(raw).save(p)
    transforms._NATIVE_IO = True

    def no_pil(*a, **k):
        raise AssertionError('PIL opened a PNG in the decoder\'s scope')
    monkeypatch.setattr(transforms.Image, 'open', no_pil)
    np.testing.assert_array_equal(np.asarray(transforms.load_rgb(p)), raw)


# -------------------------------------------------------- switched off -- #

def _no_decode(*a, **k):
    raise AssertionError('the native decoder ran with the switch off')


def test_no_native_io_flag_routes_to_pil(tmp_path, monkeypatch):
    """--no_native_io clears the switch (in the loader, as JAX's does), and
    load_rgb then never calls the decoder."""
    root = _loader_set(tmp_path)
    transforms._NATIVE_IO = True
    CreateDataLoader(TrainOptions().parse(_loader_flags(root)
                                          + ['--no_native_io']))
    assert transforms._NATIVE_IO is False
    monkeypatch.setattr(native_io, 'decode_png', _no_decode)
    p = os.path.join(root, 'train', '000.png')
    np.testing.assert_array_equal(np.asarray(transforms.load_rgb(p)),
                                  np.asarray(Image.open(p).convert('RGB')))


_ENV_PROBE = r"""
import sys
import numpy as np
from PIL import Image
from supervised_gan_tpu_torch.data import native_io, transforms
def no_decode(*a, **k):
    raise AssertionError('decoded natively')
native_io.decode_png = no_decode
img = transforms.load_rgb(sys.argv[1])
assert transforms._NATIVE_IO is False
pil = np.asarray(Image.open(sys.argv[1]).convert('RGB'))
assert (np.asarray(img) == pil).all()
print('pil')
"""


def test_env_switch_routes_to_pil(tmp_path):
    """SGAN_TPU_NO_NATIVE_IO=1, read at import as in JAX, turns the decoder
    off for the process."""
    p = str(tmp_path / 'x.png')
    Image.fromarray(_raw(2, 8, 8, 12)).save(p)
    out = subprocess.run(
        [sys.executable, '-c', _ENV_PROBE, p], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, SGAN_TPU_NO_NATIVE_IO='1', OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == 'pil'


# --------------------------------------------------------- a failed build -- #

@pytest.mark.parametrize('how', ['missing_compiler', 'compile_error'])
def test_failed_build_raises(tmp_path, monkeypatch, how):
    """The port has no silent fallback for its own decoder: a build that
    fails raises with the compiler's message, from decode_png and from
    load_rgb alike (JAX instead falls back to PIL for the process)."""
    monkeypatch.setattr(native_io, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native_io, '_lib', None)
    if how == 'missing_compiler':
        monkeypatch.setattr(native_io, 'CXX',
                            str(tmp_path / 'no' / 'such' / 'g++'))
        want = 'No such file'
    else:
        bad = tmp_path / 'dataio.cpp'
        bad.write_text('extern "C" int png_dims( {\n')
        monkeypatch.setattr(native_io, 'SOURCE', bad)
        want = 'error'
    p = str(tmp_path / 'x.png')
    Image.fromarray(_raw(2, 4, 4, 13)).save(p)
    with pytest.raises(RuntimeError, match='could not be built') as e:
        native_io.decode_png(p)
    assert want in str(e.value)
    transforms._NATIVE_IO = True
    with pytest.raises(RuntimeError, match='could not be built'):
        transforms.load_rgb(p)
    assert not list((tmp_path / 'build').glob('*.so*'))


def test_library_named_by_source_and_flags(monkeypatch, tmp_path):
    """The library's name changes with the source and with the flags, and
    lives in the package's build directory."""
    base = native_io.library_path()
    assert base.parent == native_io.PKG_DIR / 'build'
    assert base.name.startswith('libdataio-') and base.suffix == '.so'
    monkeypatch.setattr(native_io, 'CXX_FLAGS', ('-O2', '-shared', '-fPIC'))
    assert native_io.library_path() != base
    monkeypatch.undo()
    edited = tmp_path / 'dataio.cpp'
    edited.write_bytes(native_io.SOURCE.read_bytes() + b'\n')
    monkeypatch.setattr(native_io, 'SOURCE', edited)
    assert native_io.library_path() != base


# ------------------------------------------------------------ the loader -- #

def _loader_set(tmp_path):
    """8 RGB PNGs of 80 x 72 (one PIL writes, the rest by hand with every
    filter), a grey one and a palette one, in <root>/train."""
    root = tmp_path / 'data'
    d = root / 'train'
    os.makedirs(d, exist_ok=True)
    Image.fromarray(_raw(2, 72, 80, 20)).save(str(d / '000.png'))
    for i in range(1, 8):
        write_png(str(d / ('%03d.png' % i)), _raw(2, 72, 80, 20 + i), 2,
                  [i % 5, (i + 2) % 5])
    write_png(str(d / '008.png'), _raw(0, 72, 80, 30), 0, [4, 1])
    write_png(str(d / '009.png'), _raw(3, 72, 80, 31), 3, [3, 2],
              palette=_palette(31))
    return str(root)


def _loader_flags(root):
    return ['--dataroot', root, '--name', 'loader', '--model', 'fcgan',
            '--dataset_mode', 'single', '--which_direction', 'AtoB',
            '--loadSize', '72', '--fineSize', '64', '--batchSize', '3',
            '--which_channel', 'rg_b', '--manualSeed', '3', '--nThreads', '4',
            '--gpu_ids', '-1', '--checkpoints_dir', os.path.join(root, 'ck')]


def _epochs(loader, n=2):
    return [[b for b in loader.load_data()] for _ in range(n)]


def test_loader_batches_native_equal_pil_equal_jax(tmp_path):
    """Two epochs of the port's loader (crop, flip, rotate on; 4 threads)
    bitwise equal with the decoder on and with --no_native_io, and equal
    to the JAX loader's for the same options and seed."""
    root = _loader_set(tmp_path)
    flags = _loader_flags(root)
    transforms._NATIVE_IO = True
    native = _epochs(CreateDataLoader(TrainOptions().parse(flags)))
    assert transforms._NATIVE_IO is True
    pil = _epochs(CreateDataLoader(TrainOptions().parse(
        flags + ['--no_native_io'])))
    assert transforms._NATIVE_IO is False
    jtransforms._NATIVE_IO = True
    jax_ = _epochs(JCreateDataLoader(JTrainOptions().parse(flags)))
    for other in (pil, jax_):
        assert len(other) == len(native) == 2
        for ea, eb in zip(native, other):
            assert len(ea) == len(eb) == 4
            for a, b in zip(ea, eb):
                assert a['A_paths'] == b['A_paths']
                assert a['A'].dtype == np.float32
                np.testing.assert_array_equal(a['A'], b['A'])
