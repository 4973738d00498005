"""The port's host C++ codecs (mhmocap_tpu_torch/native/codecs.cpp,
built with g++ at first use) against their plain Python versions in
mhmocap_tpu_torch/io.py (`_decode_scan`, `_png_unfilter`): coefficients,
pixels and unfiltered rows bit for bit, and the same error on corrupted
input; the order-preserving
thread map the files are decoded on; the build; and that no path falls
back to the Python decoders."""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image

from test_torch_codecs import _png_cases, _scene

from mhmocap_tpu_torch import io as TIO, native
from mhmocap_tpu_torch.data import ingestion as TI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# The two decoders behind `io._parse_jpeg`
# ---------------------------------------------------------------------------

_NATIVE_SCAN = TIO._scan
_TUPLES = {}
_READS_PAST_PADDING = []


def _plain_scan(segments, comps, frame, tables, restart_interval):
    """`io._scan`'s plain counterpart: `_decode_scan` on the tables as
    `_huff_lut` gives them (tuples). The plain decoder meets the end of
    the data as an IndexError of its bytes once it reads past their 4
    bytes of zero padding; the native decoder reports that as the
    overrun (each such read is counted in _READS_PAST_PADDING)."""
    luts = ({}, {})
    for (tc, th), t in tables.items():
        if id(t) not in _TUPLES:
            _TUPLES[id(t)] = (t, (tuple(t[0].tolist()), tuple(t[1].tolist())))
        luts[tc][th] = _TUPLES[id(t)][1]
    try:
        TIO._decode_scan(segments, comps, frame, *luts, restart_interval)
    except IndexError as e:
        if str(e) != "index out of range":
            raise
        _READS_PAST_PADDING.append(1)
        raise ValueError("JPEG entropy data overrun") from None


def _parse(monkeypatch, data, plain, mutate=None):
    """`_parse_jpeg(data)` with one decoder, each scan's segments first
    passed through `mutate`: the frame, or (exception type, message)."""
    scan = _plain_scan if plain else _NATIVE_SCAN

    def run(segments, *args):
        scan(mutate(segments) if mutate else segments, *args)
    with monkeypatch.context() as m:
        m.setattr(TIO, "_scan", run)
        try:
            return TIO._parse_jpeg(data)
        except Exception as e:            # the outcome under comparison
            return type(e).__name__, str(e)


def _same_outcome(monkeypatch, data, mutate=None):
    """Both decoders give the same coefficients or the same error;
    returns the native outcome."""
    nat = _parse(monkeypatch, data, False, mutate)
    ref = _parse(monkeypatch, data, True, mutate)
    if isinstance(ref, tuple):
        assert nat == ref
    else:
        assert not isinstance(nat, tuple), nat
        for a, b in zip(nat.components, ref.components):
            assert a.coefs.dtype == b.coefs.dtype == np.int32
            np.testing.assert_array_equal(a.coefs, b.coefs)
    return nat


# ---------------------------------------------------------------------------
# A non-interleaved baseline file (one scan per component), written from
# the coefficients of an interleaved one with the Annex K tables
# ---------------------------------------------------------------------------

def _non_interleaved(data, restart=0):
    frame = TIO._parse_jpeg(data)
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    codes = {k: {s: (code, n) for s, code, n in TIO._huff_codes(*v)}
             for k, v in TIO._STD_HUFF.items()}
    head = data[:data.index(b"\xff\xda")]           # SOI .. DHT
    if restart:
        head += b"\xff\xdd\x00\x04" + restart.to_bytes(2, "big")
    out = bytearray(head)
    for ci, c in enumerate(frame.components):
        t = 0 if ci == 0 else 1
        bw = TIO._ceil(TIO._ceil(frame.width * c.h, hmax), 8)
        bh = TIO._ceil(TIO._ceil(frame.height * c.v, vmax), 8)
        out += b"\xff\xda\x00\x08\x01" + bytes([c.cid, t << 4 | t, 0, 63, 0])
        bits, pred, rst = TIO._BitWriter(), 0, 0
        for m in range(bw * bh):
            if restart and m and m % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst % 8])
                rst, pred = rst + 1, 0
            zz = c.coefs[m // bw, m % bw][TIO.ZIGZAG]
            TIO._put_value(bits, codes[0, t], 0, int(zz[0]) - pred)
            pred = int(zz[0])
            last = 0
            for k in (np.flatnonzero(zz[1:]) + 1).tolist():
                run = k - last - 1
                while run > 15:
                    bits.put(*codes[1, t][0xF0])
                    run -= 16
                TIO._put_value(bits, codes[1, t], run << 4, int(zz[k]))
                last = k
            if last != 63:
                bits.put(*codes[1, t][0x00])
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


def _jpeg(case, tmp_path):
    rng = np.random.RandomState(2)
    img = _scene(96, 112, rng)
    p = str(tmp_path / "x.jpg")
    if case == "2048 write_jpeg":
        TIO.write_jpeg(p, _scene(2048, 2048, rng), quality=92)
        return p
    kw = {"444": {"subsampling": 0}, "422": {"subsampling": 1},
          "restart": {"restart_marker_blocks": 3},
          "restart uneven": {"restart_marker_blocks": 5}}.get(case, {})
    if case == "gray":
        img = img[..., 1]
    if case in ("odd size", "non-interleaved", "non-interleaved restart"):
        img = img[:61, :83]
    Image.fromarray(img).save(p, quality=92, **kw)
    if case.startswith("non-interleaved"):
        with open(p, "rb") as f:
            data = f.read()
        p = str(tmp_path / "y.jpg")
        with open(p, "wb") as f:
            f.write(_non_interleaved(data, 7 if "restart" in case else 0))
    return p


JPEG_CASES = ["420", "444", "422", "gray", "restart", "restart uneven",
              "odd size", "non-interleaved", "non-interleaved restart",
              "2048 write_jpeg"]


@pytest.mark.parametrize("case", JPEG_CASES)
def test_jpeg_native_is_bit_identical(tmp_path, monkeypatch, case):
    """Every JPEG case of test_torch_codecs (4:2:0, 4:4:4, 4:2:2, gray,
    restart intervals, a size that is no multiple of the MCU), a restart
    interval that does not divide the MCU count (42 MCUs, 5 a segment),
    non-interleaved baseline files (one scan per component, 61x83 at
    4:2:0, so the luma scan covers 11 of the 12 block columns the MCUs
    span; with and without restarts) and a 2048x2048 frame from the
    port's write_jpeg: the same coefficients from both decoders, and the
    same pixels."""
    p = _jpeg(case, tmp_path)
    with open(p, "rb") as f:
        data = f.read()
    nat = _same_outcome(monkeypatch, data)
    ref = _parse(monkeypatch, data, True)
    pix = [TIO._reconstruct([fr], "cpu") for fr in (nat, ref)]
    assert torch.equal(*pix)
    if case.startswith("non-interleaved"):
        # the pixels of the interleaved file it was written from; PIL
        # reads it within the decoders' bound
        assert len(data.split(b"\xff\xda")) == 4
        assert torch.equal(pix[0][0], torch.as_tensor(
            TIO.read_jpeg(str(tmp_path / "x.jpg"))))
        img = np.asarray(Image.open(p)).astype(int)
        assert np.abs(pix[0][0].numpy().astype(int) - img).max() <= 3


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

def _small_jpeg(tmp_path, restart=0, gray=False):
    img = _scene(40, 56, np.random.RandomState(9))
    p = str(tmp_path / "s.jpg")
    Image.fromarray(img[..., 0] if gray else img).save(
        p, quality=92, **({"restart_marker_blocks": restart} if restart
                          else {}))
    with open(p, "rb") as f:
        return f.read()


def _ac_run_past_63():
    """One luma block: DC 0, three ZRLs (k = 49), then run 15, size 1:
    k = 64."""
    codes = {k: {s: (code, n) for s, code, n in TIO._huff_codes(*v)}
             for k, v in TIO._STD_HUFF.items()}
    bits = TIO._BitWriter()
    bits.put(*codes[0, 0][0])
    for _ in range(3):
        bits.put(*codes[1, 0][0xF0])
    bits.put(*codes[1, 0][0xF1])
    bits.put(1, 1)
    bits.flush()
    return bytes(bits.out)


@pytest.mark.parametrize("error", ["bad JPEG Huffman code",
                                   "JPEG AC run past coefficient 63",
                                   "JPEG scan ends before its last MCU",
                                   "JPEG entropy data overrun"])
def test_scan_errors_match(tmp_path, monkeypatch, error):
    """Each error `_decode_scan` raises, on a scan corrupted to raise it:
    all-ones data (no code), a block whose AC run passes coefficient 63,
    a restart scan without its last segment, and the last segment cut
    short by each of 1..40 bytes (some cuts end past the data, some run
    out of padding first): the native decoder raises the same."""
    data = _small_jpeg(tmp_path, restart=2 if "ends" in error else 0,
                       gray="AC run" in error)
    if error == "bad JPEG Huffman code":
        mutates = [lambda s: [b"\xff" * len(x) for x in s]]
    elif error == "JPEG AC run past coefficient 63":
        mutates = [lambda s: [_ac_run_past_63() + x for x in s]]
    elif error == "JPEG scan ends before its last MCU":
        mutates = [lambda s: s[:-1]]
    else:
        mutates = [lambda s, k=k: s[:-1] + [s[-1][:-k]] for k in range(1, 41)]
    seen = set()
    for mutate in mutates:
        _READS_PAST_PADDING.clear()
        out = _same_outcome(monkeypatch, data, mutate)
        if isinstance(out, tuple):
            seen.add(out + (len(_READS_PAST_PADDING),))
    assert ("ValueError", error, 0) in seen
    if "overrun" in error:      # both ways the data can run out
        assert ("ValueError", error, 1) in seen


def _regions(data):
    """Byte ranges of the DHT, DRI and SOS segments (length and body)
    and of the entropy-coded data (a flip in the frame header could ask
    for a frame of 65535x65535 samples)."""
    out, pos = [], 2
    while pos < len(data) - 1:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker in (0xC4, 0xDD, 0xDA):
            out.append((pos + 2, pos + 2 + length))
        if marker == 0xDA:
            out.append((pos + 2 + length, len(data) - 2))
            break
        pos += 2 + length
    return out


_FLIP_DATA = {}


@settings(derandomize=True, max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(flips=st.lists(st.tuples(st.integers(0, 1 << 20),
                                st.integers(1, 255)), min_size=1,
                      max_size=4))
def test_flipped_bytes_same_outcome(tmp_path, monkeypatch, flips):
    """A seeded 4:2:0 file with a restart interval that does not divide
    its MCU count, 1-4 bytes flipped in its Huffman tables, restart
    interval, scan header or entropy-coded data: both decoders give the
    same coefficients or raise the same error."""
    if "data" not in _FLIP_DATA:
        _FLIP_DATA["data"] = _small_jpeg(tmp_path, restart=4)
        _FLIP_DATA["at"] = np.concatenate(
            [np.arange(a, b) for a, b in _regions(_FLIP_DATA["data"])])
    data, at = bytearray(_FLIP_DATA["data"]), _FLIP_DATA["at"]
    for i, x in flips:
        data[at[i % len(at)]] ^= x
    _same_outcome(monkeypatch, bytes(data))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_raw(path):
    """(raw filtered bytes, rows, rowbytes, bpp) of a PNG, as read_png
    hands them to the unfilter."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    chunks = dict()
    idat = []
    for kind, body in TIO._png_chunks(data):
        chunks[kind] = body
        if kind == b"IDAT":
            idat.append(body)
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    bits = depth * TIO._PNG_CHANNELS[ctype]
    rowbytes = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw[:h * (rowbytes + 1)], h, rowbytes, max(1, bits // 8)


PNG_CASES = (["L", "LA", "RGB", "RGBA", "I;16 noise", "I;16 smooth"]
             + [f"P{c}" for c in (2, 4, 16, 200)] + ["L 301x300"])


@pytest.mark.parametrize("case", PNG_CASES)
def test_png_native_is_bit_identical(tmp_path, monkeypatch, case):
    """PIL-written PNGs (adaptive filters) of every mode of
    test_torch_codecs, palettes of 1, 2, 4 and 8 bits an index (bpp 1,
    sub-byte rows; unfiltered), and a larger noisy L image: the native
    unfilter gives the plain one's bytes, and read_png the same array."""
    rng = np.random.RandomState(0)
    if case.startswith("P"):
        colors = int(case[1:])
        im = Image.fromarray((rng.rand(17, 23) * colors).astype(np.uint8),
                             "P")
        im.putpalette([v % 256 for v in range(3 * colors)])
    elif case == "L 301x300":
        yy, xx = np.mgrid[0:301, 0:300]
        im = Image.fromarray(((yy + xx + rng.rand(301, 300) * 40) % 256)
                             .astype(np.uint8))
    else:
        im = _png_cases(rng)[case]
    p = str(tmp_path / "x.png")
    im.save(p)
    raw, rows, rowbytes, bpp = _png_raw(p)
    if not case.startswith("P"):          # PIL filters no palette image
        assert set(raw.reshape(rows, -1)[:, 0].tolist()) - {0}
    np.testing.assert_array_equal(
        native.png_unfilter(raw, rows, rowbytes, bpp),
        TIO._png_unfilter(raw, rows, rowbytes, bpp))
    got = TIO.read_png(p)
    with monkeypatch.context() as m:
        m.setattr(native, "png_unfilter", TIO._png_unfilter)
        ref = TIO.read_png(p)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_every_filter_and_bpp(bpp):
    """Seeded rows of every filter type at every bpp a PNG can have,
    with bytes from a narrow range (frequent Paeth ties) and the full
    one (wrap-around): the native unfilter gives the plain one's
    bytes."""
    rng = np.random.RandomState(bpp)
    rows, rowbytes = 40, 7 * bpp
    for high in (4, 256):
        raw = rng.randint(0, high, (rows, rowbytes + 1)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, rows)
        raw[:5, 0] = range(5)
        np.testing.assert_array_equal(
            native.png_unfilter(raw.ravel(), rows, rowbytes, bpp),
            TIO._png_unfilter(raw.ravel(), rows, rowbytes, bpp))


@pytest.mark.parametrize("ftype", [5, 255])
def test_png_bad_filter_type(ftype):
    raw = np.zeros((3, 5), np.uint8)
    raw[1, 0] = 2
    raw[2, 0] = ftype
    for fn in (native.png_unfilter, TIO._png_unfilter):
        with pytest.raises(ValueError, match=f"bad PNG filter type {ftype}$"):
            fn(raw.ravel(), 3, 4, 1)


# ---------------------------------------------------------------------------
# The thread map
# ---------------------------------------------------------------------------

def test_host_map_keeps_order_and_runs_one_item_inline(monkeypatch):
    assert TI._host_map is TIO._host_map
    assert TIO.HOST_WORKERS == min(16, os.cpu_count() or 4)
    monkeypatch.setattr(TIO, "HOST_WORKERS", 16)

    def slow(x):
        time.sleep(0.001 * (9 - x % 10))     # later items finish first
        return x * x
    assert TIO._host_map(slow, range(40)) == [x * x for x in range(40)]
    me = threading.get_ident()
    assert TIO._host_map(lambda _: threading.get_ident(), [0]) == [me]
    assert TIO._host_map(slow, []) == []
    barrier = threading.Barrier(4, timeout=30)   # 4 items at once
    assert TIO._host_map(lambda x: barrier.wait() * 0 + x,
                         range(4)) == [0, 1, 2, 3]


def test_read_jpegs_on_many_threads(tmp_path, monkeypatch):
    """32 threads (more than the cores), a short switch interval and the
    library loaded by whichever thread comes first: frames of three
    geometries, interleaved, decode to what one worker gives, in order."""
    rng = np.random.RandomState(11)
    paths = []
    for k in range(12):
        shape = [(40, 56), (61, 83), (48, 48)][k % 3]
        p = str(tmp_path / f"{k}.jpg")
        Image.fromarray(_scene(*shape, rng)).save(p, quality=92)
        paths.append(p)
    paths = paths * 4
    monkeypatch.setattr(TIO, "HOST_WORKERS", 1)
    ref = TIO.read_jpegs(paths)
    monkeypatch.setattr(TIO, "HOST_WORKERS", 32)
    monkeypatch.setattr(native, "_LIB", [])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = TIO.read_jpegs(paths)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from mhmocap_tpu_torch.data.synthetic import generate_sequence
    from mhmocap_tpu_torch.models.synthetic import make_synthetic_smpl
    root = str(tmp_path_factory.mktemp("tree") / "TS1")
    generate_sequence(root, num_frames=10, num_people=2, image_size=(64, 48),
                      model=make_synthetic_smpl(num_vertices=512), seed=3)
    names = sorted(os.listdir(os.path.join(root, "images")))
    names = [os.path.splitext(n)[0] for n in names if n.endswith(".jpg")]
    return {sub: [os.path.join(root, sub, n + ext) for n in names]
            for sub, ext in (("images", ".jpg"),
                             ("DPT_large_monodepth", ".png"),
                             ("Mask2Former_Instances", ".png"))}


@pytest.mark.parametrize("loader", ["load_images", "load_disparity_maps",
                                    "load_segmentation_maps"])
def test_loaders_same_on_1_and_16_workers(tree, monkeypatch, loader):
    """The three frame loaders on a 10-frame tree (two IMAGE_BLOCKs):
    the same arrays from 1 worker and from 16."""
    run = {"load_images": lambda: TI.load_images(tree["images"], 0.5),
           "load_disparity_maps": lambda: TI.load_disparity_maps(
               tree["DPT_large_monodepth"], (32, 24)),
           "load_segmentation_maps": lambda: TI.load_segmentation_maps(
               tree["Mask2Former_Instances"], (32, 24))}[loader]
    outs = []
    for workers in (1, 16):
        monkeypatch.setattr(TIO, "HOST_WORKERS", workers)
        outs.append(run())
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs)):
        assert a.dtype == b.dtype and a.shape[0] == 10
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    import numpy as np
    from mhmocap_tpu_torch import native
    native.build_dir = lambda: Path({out!r})
    lib, _ = native.build_library()
    raw = np.array([1, 5, 5], np.uint8)
    print(lib.name, native.png_unfilter(raw, 1, 2, 1).tolist())
""")


def test_two_concurrent_builds_into_a_fresh_dir(tmp_path):
    """Two processes build the library into one empty directory at
    once: both succeed, with one library and no temporary file left."""
    out = tmp_path / "build"
    script = BUILD.format(repo=REPO, out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    res = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se
    lines = {so.strip() for so, _ in res}
    assert len(lines) == 1
    name, rows = lines.pop().split(" ", 1)
    assert rows == "[[5, 10]]"
    assert sorted(f.name for f in out.iterdir()) == [name]


def test_build_failures_raise(tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: RuntimeError,
    with the compiler's output."""
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build_library()
    monkeypatch.undo()
    bad = tmp_path / "codecs.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="(?s)g.. failed.*error"):
        native.build_library()


def test_no_fallback_to_the_python_decoders(tmp_path, monkeypatch):
    """With the library made to fail to load, read_jpeg and read_png
    raise; neither reaches its Python decoder."""
    jpg, png = str(tmp_path / "x.jpg"), str(tmp_path / "x.png")
    Image.fromarray(_scene(24, 24, np.random.RandomState(1))).save(jpg)
    Image.fromarray(_scene(24, 24, np.random.RandomState(1))).save(png)

    def fail():
        raise OSError("libmhmocap_codecs: cannot load")

    def reached(*_):
        raise AssertionError("a Python decoder was reached")
    monkeypatch.setattr(native, "_library", fail)
    monkeypatch.setattr(TIO, "_decode_scan", reached)
    monkeypatch.setattr(TIO, "_png_unfilter", reached)
    for read, p in ((TIO.read_jpeg, jpg), (TIO.read_png, png)):
        with pytest.raises(OSError, match="cannot load"):
            read(p)
