"""The port's image codecs (mhmocap_tpu_torch.io) against PIL, the
library the JAX package reads and writes its images with."""

import numpy as np
import pytest
from PIL import Image

from mhmocap_tpu_torch import io as TIO

# The port's JPEG decoder reconstructs with a float64 IDCT; libjpeg (PIL)
# uses its integer IDCT, and the chroma upsampling and colour conversion
# (both libjpeg's fixed-point arithmetic in the port too) spread a one-
# level difference of a chroma sample to up to 3 levels of a pixel.
JPEG_BOUND = {"max": 3, "mean": 0.1}


def _scene(h, w, rng):
    """A synthetic-frame-like image: flat wall and floor tints with
    sharp coloured splats, plus a smooth gradient band."""
    img = np.full((h, w, 3), 200, np.uint8)
    img[h // 2:] = (160, 170, 180)
    for k in range(25):
        y, x = rng.randint(0, h - 12), rng.randint(0, w - 6)
        img[y:y + 12, x:x + 6] = (60 + 60 * (k % 3), 90, 200 - 50 * (k % 3))
    img[:, : w // 4, 0] = np.linspace(0, 255, h)[:, None].astype(np.uint8)
    return img


def _png_cases(rng):
    yy, xx = np.mgrid[0:37, 0:53]
    smooth16 = ((yy * 900 + xx * 400) % 65536).astype(np.uint16)
    return {
        "L": Image.fromarray((rng.rand(31, 45) * 255).astype(np.uint8)),
        "LA": Image.fromarray((rng.rand(17, 19, 2) * 255).astype(np.uint8),
                              "LA"),
        "RGB": Image.fromarray(_scene(40, 56, rng)),
        "RGBA": Image.fromarray((rng.rand(20, 23, 4) * 255).astype(
            np.uint8)),
        "I;16 noise": Image.fromarray((rng.rand(30, 31) * 65535).astype(
            np.uint16)),
        "I;16 smooth": Image.fromarray(smooth16),
    }


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16 noise",
                                  "I;16 smooth"])
def test_png_read_is_bit_exact(tmp_path, mode):
    """Every mode the port reads, PIL-written (adaptive filters, so all
    five row filters occur): equal to np.asarray(Image.open(p)), dtype
    included."""
    im = _png_cases(np.random.RandomState(0))[mode]
    p = str(tmp_path / "x.png")
    im.save(p)
    ref = np.asarray(Image.open(p))
    got = TIO.read_png(p)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_png_read_palette_indices(tmp_path, colors):
    """Palette PNGs (PIL writes 1, 2, 4 or 8 bits per index by palette
    size) read back as their indices, as np.asarray of a 'P' image."""
    rng = np.random.RandomState(colors)
    im = Image.fromarray((rng.rand(17, 23) * colors).astype(np.uint8), "P")
    im.putpalette([v % 256 for v in range(3 * colors)])
    p = str(tmp_path / "p.png")
    im.save(p)
    np.testing.assert_array_equal(TIO.read_png(p), np.asarray(Image.open(p)))


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I;16"])
def test_png_write_reads_back_in_pil(tmp_path, kind):
    rng = np.random.RandomState(1)
    arr = {"L": (rng.rand(21, 34) * 255).astype(np.uint8),
           "RGB": _scene(24, 40, rng),
           "RGBA": (rng.rand(9, 11, 4) * 255).astype(np.uint8),
           "I;16": (rng.rand(19, 26) * 65535).astype(np.uint16)}[kind]
    p = str(tmp_path / "w.png")
    TIO.write_png(p, arr)
    back = np.asarray(Image.open(p))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(TIO.read_png(p), arr)


@pytest.mark.parametrize("case", ["420", "444", "422", "gray", "restart",
                                  "odd size"])
def test_jpeg_read_matches_pil(tmp_path, case):
    """PIL-written q=92 JPEGs (4:2:0 is PIL's default; 4:4:4, 4:2:2,
    grayscale, restart intervals, a size that is no multiple of the MCU)
    decode within JPEG_BOUND of PIL's own decode."""
    rng = np.random.RandomState(2)
    img = _scene(96, 112, rng)
    kw = {"444": {"subsampling": 0}, "422": {"subsampling": 1},
          "restart": {"restart_marker_blocks": 3}}.get(case, {})
    if case == "gray":
        img = img[..., 1]
    if case == "odd size":
        img = img[:61, :83]
    p = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(p, quality=92, **kw)
    ref = np.asarray(Image.open(p)).astype(int)
    got = TIO.read_jpeg(p)
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - ref)
    assert d.max() <= JPEG_BOUND["max"] and d.mean() <= JPEG_BOUND["mean"], \
        (d.max(), d.mean())


def test_jpeg_read_batches_frames(tmp_path):
    """read_jpegs reconstructs frames of one geometry in one batch: the
    same pixels as one frame at a time."""
    rng = np.random.RandomState(3)
    paths = []
    for k in range(3):
        p = str(tmp_path / f"{k}.jpg")
        Image.fromarray(_scene(48, 64, rng)).save(p, quality=92)
        paths.append(p)
    batch = TIO.read_jpegs(paths)
    for p, b in zip(paths, batch):
        np.testing.assert_array_equal(b, TIO.read_jpeg(p))


@pytest.mark.parametrize("shape,quality", [((96, 96), 92), ((61, 83), 92),
                                           ((40, 56), 75), ((33, 47), 30)])
def test_jpeg_write_is_pils_file(tmp_path, shape, quality):
    """The port's writer emits the bytes PIL writes for the same array
    and quality (libjpeg's colour conversion, edge expansion, h2v2
    downsampling, islow DCT, reciprocal quantization, Annex K Huffman
    tables), so PIL reads it as its own file; and the port's decoder
    reads it within JPEG_BOUND of PIL."""
    rng = np.random.RandomState(4)
    img = _scene(*shape, rng)
    if quality == 75:
        img = (rng.rand(*shape, 3) * 255).astype(np.uint8)   # noise
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "pil.jpg")
    TIO.write_jpeg(ours, img, quality=quality)
    Image.fromarray(img).save(theirs, quality=quality)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    ref = np.asarray(Image.open(ours)).astype(int)
    d = np.abs(TIO.read_jpeg(ours).astype(int) - ref)
    assert d.max() <= JPEG_BOUND["max"] and d.mean() <= JPEG_BOUND["mean"]


def test_progressive_jpeg_raises(tmp_path):
    p = str(tmp_path / "prog.jpg")
    Image.fromarray(_scene(32, 32, np.random.RandomState(5))).save(
        p, quality=90, progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        TIO.read_jpeg(p)


def test_interlaced_png_raises(tmp_path):
    """(PIL writes no Adam7 files: the interlace flag is set in the
    header of a port-written one.)"""
    import struct
    import zlib
    p = str(tmp_path / "i.png")
    TIO.write_png(p, np.zeros((16, 16), np.uint8))
    with open(p, "rb") as f:
        data = bytearray(f.read())
    data[28] = 1                                   # IHDR interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with open(p, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        TIO.read_png(p)
