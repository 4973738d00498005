"""Image codecs without PIL: PNG read/write and baseline JPEG read/write.

Counterpart of `mhmocap_tpu/io.py`, which wraps PIL. The machine with
the GPU has no PIL, so the port reads and writes its images itself:

* PNG (lossless): 8-bit grayscale, grayscale + alpha, palette (1-8 bit),
  RGB and RGBA, 16-bit grayscale; non-interlaced, all five row filters.
  `read_png` returns what `np.asarray(Image.open(path))` returns, bit for
  bit (palette images give their indices, 16-bit grayscale uint16).
* JPEG read: baseline and extended sequential Huffman, 8-bit, grayscale
  or YCbCr, sampling 4:4:4, 4:2:2 or 4:2:0, restart markers. The entropy
  decode is a table-driven host loop in C++ (`native/codecs.cpp`, held
  bit for bit to its plain Python version `_decode_scan`), files parsed
  and decoded on a thread pool (`_host_map`); dequantisation, the 8x8
  IDCT (one batched float64 matmul), libjpeg's "fancy" chroma
  upsampling and its fixed-point YCbCr->RGB conversion run as batched
  torch ops on the given device. libjpeg (PIL) uses an integer IDCT
  instead, so pixels differ from PIL's by a level or two (bounds in
  tests/test_torch_codecs.py).
* JPEG write: RGB at 4:2:0 (PIL's default) with libjpeg's fixed-point
  colour conversion and downsampling, the IJG quality scaling of the
  Annex K tables and the Annex K Huffman tables. It emits PIL's exact
  bytes, libjpeg's integer (islow) forward DCT and libjpeg-turbo's
  reciprocal quantization included, so that a synthetic tree written by
  the port is the JAX writer's tree file for file: the port's accuracy
  sweep then reads the very pixels the JAX sweep reads. A float DCT with
  round(x / q) would not do: its quantized coefficients differ from
  libjpeg's near half steps, which moves decoded pixels by 6-10 levels
  at q=92 (up to 16 at q=75) from PIL's file, beyond the decoder's
  bound of 3.
* The PNG row unfilter runs in C++ too (`native/codecs.cpp`; plain
  version `_png_unfilter`). The plain versions are the tests' reference;
  no path falls back to them.
* `io_mkdir` and `save_image`, the JAX module's two helpers: mkdir -p,
  and an image array written as PNG or JPEG by its file suffix.
"""

from __future__ import annotations

import functools
import os
import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from . import native

# threads of `_host_map`, the JAX package's min(16, cpu_count)
HOST_WORKERS = min(16, os.cpu_count() or 4)


def _host_map(fn, items):
    """Order-preserving threaded map for per-file host decoding, the
    JAX package's `data/ingestion._host_map` (after the reference's
    DataLoader(num_workers=4)): the native codecs and zlib release the
    GIL, so files decode in parallel on HOST_WORKERS threads. A single
    item runs inline."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(HOST_WORKERS) as ex:
        return list(ex.map(fn, items))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG file")


def _png_unfilter(raw: np.ndarray, rows: int, rowbytes: int,
                  bpp: int) -> np.ndarray:
    """Undo the per-row filters. A byte's left neighbour is `bpp` bytes
    back, so the image is swept as an anti-diagonal wavefront over
    (row, bpp-byte unit): every unit of a diagonal depends only on the
    two diagonals before it. The units are stored skewed (diagonal d of
    row r at column d + 2), so each step updates every row, whatever
    its filter, through plain slices."""
    lines = raw.reshape(rows, rowbytes + 1)
    ftype = lines[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return lines[:, 1:].copy()
    units = rowbytes // bpp
    x = lines[:, 1:].reshape(rows, units, bpp).astype(np.int16)
    diags = rows + units - 1
    r = np.arange(rows)[:, None]
    d = r + np.arange(units)[None, :]
    xs = np.zeros((rows, diags, bpp), np.int16)
    xs[r, d] = x
    # row 0 and columns 0-1 stay zero: the image's zero border
    s = np.zeros((rows + 1, diags + 2, bpp), np.int16)
    f = ftype.astype(np.intp)[:, None, None]
    zero = np.zeros((rows, 1, bpp), np.int16)
    for k in range(diags):
        r0, r1 = max(0, k - units + 1), min(rows, k + 1)
        a = s[r0 + 1:r1 + 1, k + 1:k + 2]      # left
        b = s[r0:r1, k + 1:k + 2]              # up
        c = s[r0:r1, k:k + 1]                  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(f[r0:r1], (zero[r0:r1], a, b, (a + b) >> 1, paeth))
        s[r0 + 1:r1 + 1, k + 2:k + 3] = (xs[r0:r1, k:k + 1] + pred) & 0xFF
    return s[r + 1, d + 2].reshape(rows, rowbytes).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to a numpy array (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat, palette = None, [], None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = body
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: bad PNG colour type {ctype}")
    ch = _PNG_CHANNELS[ctype]
    if not ((depth == 8) or (depth == 16 and ctype == 0)
            or (depth in (1, 2, 4) and ctype == 3)):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bits = depth * ch
    rowbytes = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (rowbytes + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = native.png_unfilter(raw[:h * (rowbytes + 1)], h, rowbytes,
                               max(1, bits // 8))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w)
    if depth < 8:
        vals = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (vals * weights).sum(-1).astype(np.uint8)[:, :w]
    img = rows.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write uint8 (H, W) / (H, W, 3) / (H, W, 4) or uint16 (H, W) as a
    PNG (filter 0 on every row, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth, rows = 0, 16, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth, rows = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        ctype, depth = (2 if img.shape[2] == 3 else 6), 8
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_png: unsupported array {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = rows.reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    body = (_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(_PNG_SIG + body)


# ---------------------------------------------------------------------------
# JPEG tables
# ---------------------------------------------------------------------------

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 quantization tables, natural order
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
              55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87,
              80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81,
              104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95,
              98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
              99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99,
              99, 99] + [99] * 32),
)

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
_STD_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             bytes(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
             bytes.fromhex(
                 "01020300041105122131410613516107227114328191a1082342b1c1"
                 "1552d1f02433627282090a161718191a25262728292a343536373839"
                 "3a434445464748494a535455565758595a636465666768696a737475"
                 "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                 "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                 "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291a1b1c109"
                 "233352f0156272d10a162434e125f11718191a262728292a353637"
                 "38393a434445464748494a535455565758595a636465666768696a73"
                 "7475767778797a82838485868788898a92939495969798999aa2a3a4"
                 "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
                 "d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _idct_basis() -> np.ndarray:
    """kron(C, C) of the orthonormal 8-point DCT-II basis C[u, x]:
    natural-order coefficients (N, 64) @ basis -> pixels (N, 64)."""
    x = np.arange(8)
    c = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2.0)
    return np.kron(c, c)


_BASIS = _idct_basis()


def _huff_codes(counts: Sequence[int], symbols: bytes):
    """Canonical Huffman (Annex C): [(symbol, code, length)]."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out.append((symbols[k], code, length))
            code += 1
            k += 1
        code <<= 1
    return out


@functools.lru_cache(maxsize=64)
def _huff_lut(counts: bytes, symbols: bytes):
    """16-bit peek -> (symbol, code length) lookup tuples, cached by the
    table's content (every frame of a sequence carries the same
    tables)."""
    sym = np.zeros(1 << 16, np.int32)
    length = np.zeros(1 << 16, np.int32)
    for s, code, n in _huff_codes(counts, symbols):
        lo = code << (16 - n)
        hi = (code + 1) << (16 - n)
        sym[lo:hi] = s
        length[lo:hi] = n
    return tuple(sym.tolist()), tuple(length.tolist())


@functools.lru_cache(maxsize=64)
def _huff_lut_array(counts: bytes, symbols: bytes) -> np.ndarray:
    """`_huff_lut` as the native decoder's (2, 65536) int32 table
    (symbols, code lengths), read-only since every caller shares it."""
    lut = np.array(_huff_lut(counts, symbols), np.int32)
    lut.flags.writeable = False
    return lut


# ---------------------------------------------------------------------------
# JPEG read
# ---------------------------------------------------------------------------

def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.coefs = None        # (rows, cols, 64) int32, natural order


class _JpegFrame:
    """Parsed geometry and entropy-decoded coefficients of one image."""

    def __init__(self):
        self.width = self.height = 0
        self.components: List[_Component] = []
        self.qtables = {}

    def geometry(self):
        return (self.height, self.width,
                tuple((c.h, c.v) for c in self.components))


def _decode_scan(segments, comps, frame, dc_luts, ac_luts,
                 restart_interval):
    """Entropy-decode one scan: `segments` are the unstuffed restart
    intervals, each restarting the DC predictors."""
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    if len(comps) == 1:
        c = comps[0][0]
        bw = _ceil(_ceil(frame.width * c.h, hmax), 8)
        bh = _ceil(_ceil(frame.height * c.v, vmax), 8)
        mcus = [[(0, r, q)] for r in range(bh) for q in range(bw)]
    else:
        mw = _ceil(frame.width, 8 * hmax)
        mh = _ceil(frame.height, 8 * vmax)
        mcus = []
        for my in range(mh):
            for mx in range(mw):
                mcus.append([(i, my * c.v + y, mx * c.h + x)
                             for i, (c, _, _) in enumerate(comps)
                             for y in range(c.v) for x in range(c.h)])
    zz = ZIGZAG.tolist()
    per = restart_interval or len(mcus)
    seg_iter = iter(segments)
    for start in range(0, len(mcus), per):
        try:
            data = next(seg_iter)
        except StopIteration:
            raise ValueError("JPEG scan ends before its last MCU") from None
        d = data + b"\x00\x00\x00\x00"
        nbits = 8 * len(data)
        pos = 0
        preds = [0] * len(comps)
        # each read takes the 32-bit window at byte pos >> 3 (inlined:
        # this loop runs once per coded symbol)
        for mcu in mcus[start:start + per]:
            for ci, r, q in mcu:
                comp, dct, act = comps[ci]
                dsym, dlen = dc_luts[dct]
                asym, alen = ac_luts[act]
                blk = comp.coefs[r, q]
                i = pos >> 3
                w = (d[i] << 24) | (d[i + 1] << 16) | (d[i + 2] << 8) \
                    | d[i + 3]
                peek = (w >> (16 - (pos & 7))) & 0xFFFF
                n = dlen[peek]
                if n == 0:
                    raise ValueError("bad JPEG Huffman code")
                s = dsym[peek]
                pos += n
                diff = 0
                if s:
                    i = pos >> 3
                    w = (d[i] << 24) | (d[i + 1] << 16) | (d[i + 2] << 8) \
                        | d[i + 3]
                    diff = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                preds[ci] += diff
                blk[0] = preds[ci]
                k = 1
                while k < 64:
                    i = pos >> 3
                    w = (d[i] << 24) | (d[i + 1] << 16) | (d[i + 2] << 8) \
                        | d[i + 3]
                    peek = (w >> (16 - (pos & 7))) & 0xFFFF
                    n = alen[peek]
                    if n == 0:
                        raise ValueError("bad JPEG Huffman code")
                    rs = asym[peek]
                    pos += n
                    s = rs & 15
                    if s == 0:
                        if rs != 0xF0:
                            break
                        k += 16
                        continue
                    k += rs >> 4
                    if k > 63:
                        raise ValueError("JPEG AC run past coefficient 63")
                    i = pos >> 3
                    w = (d[i] << 24) | (d[i + 1] << 16) | (d[i + 2] << 8) \
                        | d[i + 3]
                    v = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    blk[zz[k]] = v
                    k += 1
        if pos > nbits + 8:
            raise ValueError("JPEG entropy data overrun")


def _scan(segments, comps, frame, tables, restart_interval):
    """Entropy-decode one scan with the native decoder, on the MCU grid
    of `_decode_scan`; `tables` maps (class, id), class 0 for DC and 1
    for AC, to the table's `_huff_lut_array`."""
    hmax = max(c.h for c in frame.components)
    vmax = max(c.v for c in frame.components)
    if len(comps) == 1:
        c = comps[0][0]
        grid = (_ceil(_ceil(frame.width * c.h, hmax), 8),
                _ceil(_ceil(frame.height * c.v, vmax), 8))
    else:
        grid = (_ceil(frame.width, 8 * hmax), _ceil(frame.height, 8 * vmax))
    native.jpeg_decode_scan(
        segments, [(c.coefs, c.h, c.v, dct, act) for c, dct, act in comps],
        tables, len(comps) != 1, grid, restart_interval)


_MARKER = re.compile(rb"\xff[\xd0-\xd7]")


def _parse_jpeg(data: bytes) -> _JpegFrame:
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    frame = _JpegFrame()
    tables = {}
    restart_interval = 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG marker stream")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:                      # fill byte
            pos -= 1
            continue
        if marker == 0xD9:                      # EOI
            break
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if marker in (0xC0, 0xC1):              # baseline / extended seq.
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported")
            if nc not in (1, 3):
                raise ValueError(f"JPEG with {nc} components is not "
                                 f"supported")
            frame.height, frame.width = h, w
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                frame.components.append(_Component(cid, hv >> 4, hv & 15,
                                                   tq))
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = "progressive" if marker in (0xC2, 0xC6, 0xCA) else \
                "lossless or arithmetic-coded"
            raise ValueError(f"{kind} JPEG (SOF{marker - 0xC0}) is not "
                             f"supported; only baseline sequential")
        elif marker == 0xC4:                    # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                syms = body[i + 17:i + 17 + sum(counts)]
                tables[int(tc != 0), th] = _huff_lut_array(bytes(counts),
                                                           syms)
                i += 17 + sum(counts)
        elif marker == 0xDB:                    # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                frame.qtables[tq] = q
                i += 1 + n
        elif marker == 0xDD:                    # DRI
            restart_interval = struct.unpack(">H", body[:2])[0]
        elif marker == 0xDA:                    # SOS
            if not frame.components:
                raise ValueError("JPEG scan before its frame header")
            if frame.components[0].coefs is None:
                hmax = max(c.h for c in frame.components)
                vmax = max(c.v for c in frame.components)
                mh = _ceil(frame.height, 8 * vmax)
                mw = _ceil(frame.width, 8 * hmax)
                for c in frame.components:
                    c.coefs = np.zeros((mh * c.v, mw * c.h, 64), np.int32)
            ns = body[0]
            by_id = {c.cid: c for c in frame.components}
            comps = [(by_id[body[1 + 2 * i]], body[2 + 2 * i] >> 4,
                      body[2 + 2 * i] & 15) for i in range(ns)]
            end = pos
            while True:
                end = data.index(b"\xff", end)
                nxt = data[end + 1]
                if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
                    end += 2
                    continue
                if nxt == 0xFF:                 # fill before a marker
                    end += 1
                    continue
                break
            segments = [s.replace(b"\xff\x00", b"\xff")
                        for s in _MARKER.split(data[pos:end])]
            _scan(segments, comps, frame, tables, restart_interval)
            pos = end
        # APPn, COM and the rest carry nothing the decoder needs
    if not frame.components or frame.components[0].coefs is None:
        raise ValueError("JPEG without image data")
    return frame


def _fancy_up(x: torch.Tensor, v: bool) -> torch.Tensor:
    """libjpeg's triangle ("fancy") upsampling of int planes (B, H, W),
    2x across and, with `v`, 2x down: each output sample is 3/4 of the
    nearer and 1/4 of the farther input sample, edges replicated, with
    libjpeg's rounding (h2v1 / h2v2_fancy_upsample)."""
    def nb(t, dim, step):
        n = t.shape[dim]
        idx = torch.clamp(torch.arange(n, device=t.device) + step, 0, n - 1)
        return t.index_select(dim, idx)

    if v:
        # column sums 3*near + far (scaled by 4), rows interleaved
        up, dn = 3 * x + nb(x, 1, -1), 3 * x + nb(x, 1, 1)
        x = torch.stack([up, dn], dim=2).reshape(x.shape[0], -1,
                                                 x.shape[2])
    shift, (blo, bhi) = (4, (8, 7)) if v else (2, (1, 2))
    lo = (3 * x + nb(x, 2, -1) + blo) >> shift
    hi = (3 * x + nb(x, 2, 1) + bhi) >> shift
    return torch.stack([lo, hi], dim=3).reshape(x.shape[0], x.shape[1], -1)


def _ycc_to_rgb(y, cb, cr):
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c), int64 planes."""
    def fix(a):
        return int(a * 65536 + 0.5)
    half = 1 << 15
    cb = cb - 128
    cr = cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255)


def _reconstruct(frames: List[_JpegFrame], device) -> torch.Tensor:
    """Pixels of frames with one geometry -> (B, H, W[, 3]) uint8."""
    f0 = frames[0]
    H, W = f0.height, f0.width
    hmax = max(c.h for c in f0.components)
    vmax = max(c.v for c in f0.components)
    basis = torch.as_tensor(_BASIS, dtype=torch.float64, device=device)
    planes = []
    for ci, c in enumerate(f0.components):
        coefs = torch.as_tensor(np.stack([f.components[ci].coefs
                                          for f in frames]), device=device)
        q = torch.as_tensor(np.stack([f.qtables[f.components[ci].tq]
                                      for f in frames]), device=device)
        B, rows, cols, _ = coefs.shape
        deq = (coefs.to(torch.float64) * q[:, None, None, :]).reshape(-1, 64)
        pix = torch.round(deq @ basis + 128.0).clamp(0, 255).to(torch.int64)
        plane = pix.reshape(B, rows, cols, 8, 8).permute(0, 1, 3, 2, 4) \
            .reshape(B, rows * 8, cols * 8)
        ch = _ceil(H * c.v, vmax)
        cw = _ceil(W * c.h, hmax)
        plane = plane[:, :ch, :cw]
        fh, fv = hmax // c.h, vmax // c.v
        if (fh, fv) != (1, 1):
            if (fh, fv) not in ((2, 2), (2, 1)) or hmax % c.h or vmax % c.v:
                raise ValueError(f"JPEG sampling {c.h}x{c.v} of "
                                 f"{hmax}x{vmax} is not supported")
            plane = _fancy_up(plane, fv == 2)
        planes.append(plane[:, :H, :W])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)
    return _ycc_to_rgb(*planes).to(torch.uint8)


def _read_jpeg_file(path: str) -> _JpegFrame:
    with open(path, "rb") as f:
        return _parse_jpeg(f.read())


def read_jpegs(paths: Sequence[str], device="cpu") -> List[np.ndarray]:
    """Decode JPEG files: each parsed and entropy-decoded on the host
    thread map, then the frames of one geometry reconstructed in one
    batch on `device`. Returns uint8 (H, W, 3) or (H, W), in order."""
    frames = _host_map(_read_jpeg_file, paths)
    out: List[np.ndarray] = [None] * len(frames)
    groups = {}
    for i, fr in enumerate(frames):
        groups.setdefault(fr.geometry(), []).append(i)
    for idx in groups.values():
        pix = _reconstruct([frames[i] for i in idx], device).cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = pix[k]
    return out


def read_jpeg(path: str, device="cpu") -> np.ndarray:
    return read_jpegs([path], device)[0]


# ---------------------------------------------------------------------------
# JPEG write
# ---------------------------------------------------------------------------

def quality_tables(quality: int):
    """IJG quality scaling of the Annex K tables (jcparam.c), clamped to
    the baseline range [1, 255]; natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in _STD_QUANT)


def _rgb_to_ycc(rgb: np.ndarray):
    """libjpeg's fixed-point RGB -> YCbCr (jccolor.c)."""
    def fix(a):
        return int(a * 65536 + 0.5)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b
         + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


# jfdctint.c constants, CONST_BITS = 13
_F = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270,
      "0_899": 7373, "1_175": 9633, "1_501": 12299, "1_847": 15137,
      "1_961": 16069, "2_053": 16819, "2_562": 20995, "3_072": 25172}


def _fdct_islow_1d(d, axis, shift_even, shift_odd):
    """One pass of libjpeg's integer forward DCT (jpeg_fdct_islow) along
    `axis` (length 8) of an int64 array."""
    x = [np.take(d, i, axis=axis) for i in range(8)]
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2

    def desc(v, n):
        return (v + (1 << (n - 1))) >> n if n else v

    out = [None] * 8
    if shift_even:
        out[0] = desc(t10 + t11, shift_even)
        out[4] = desc(t10 - t11, shift_even)
    else:
        out[0] = (t10 + t11) << 2
        out[4] = (t10 - t11) << 2
    z1 = (t12 + t13) * _F["0_541"]
    out[2] = desc(z1 + t13 * _F["0_765"], shift_odd)
    out[6] = desc(z1 - t12 * _F["1_847"], shift_odd)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F["1_175"]
    t4, t5 = t4 * _F["0_298"], t5 * _F["2_053"]
    t6, t7 = t6 * _F["3_072"], t7 * _F["1_501"]
    z1, z2 = z1 * -_F["0_899"], z2 * -_F["2_562"]
    z3, z4 = z3 * -_F["1_961"] + z5, z4 * -_F["0_390"] + z5
    out[7] = desc(t4 + z1 + z3, shift_odd)
    out[5] = desc(t5 + z2 + z4, shift_odd)
    out[3] = desc(t6 + z2 + z3, shift_odd)
    out[1] = desc(t7 + z1 + z4, shift_odd)
    return np.stack(out, axis=axis)


def _reciprocal(div: int):
    """libjpeg-turbo's compute_reciprocal (jcdctmgr.c, 16-bit DCTELEM):
    (reciprocal, rounding correction, shift) with which
    ((|x| + corr) * recip) >> shift is its quantized |x| / div."""
    if div == 1:
        return 1, 0, 0
    r = 16 + div.bit_length() - 1
    fq, fr = divmod(1 << r, div)
    c = div // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= div // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def _fdct_quantize(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's islow forward DCT of (..., 8, 8) centred samples and
    libjpeg-turbo's reciprocal quantization by 8 q; natural-order
    (..., 64) int64."""
    d = _fdct_islow_1d(blocks.astype(np.int64), -1, 0, 11)   # rows
    d = _fdct_islow_1d(d, -2, 2, 15)                          # columns
    d = d.reshape(d.shape[:-2] + (64,))
    recip, corr, shift = (np.array(v, np.int64) for v in zip(
        *[_reciprocal(8 * int(v)) for v in q]))
    return np.sign(d) * (((np.abs(d) + corr) * recip) >> shift)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H8, W8) plane -> (H8/8, W8/8, 64) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 8, w // 8, 64)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 92):
    """Write a uint8 (H, W, 3) RGB image as a baseline 4:2:0 JFIF file,
    byte for byte what PIL (libjpeg, islow DCT, standard Huffman tables)
    writes for `Image.fromarray(rgb).save(path, quality=quality)`."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_jpeg: expected uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    # libjpeg's edge expansion: columns replicated to whole MCUs before
    # downsampling; rows only to the 2-row group, and the downsampled
    # chroma rows are then replicated to whole MCUs
    ph, pw = _ceil(H, 16) * 16, _ceil(W, 16) * 16
    padded = np.pad(rgb, ((0, _ceil(H, 2) * 2 - H), (0, pw - W), (0, 0)),
                    mode="edge")
    y, cb, cr = _rgb_to_ycc(padded)
    # h2v2 downsampling with libjpeg's alternating 1, 2 rounding bias
    bias = np.tile([1, 2], pw // 4)[None, :]

    def down(p):
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        return np.pad((s + bias) >> 2, ((0, ph // 2 - len(s)), (0, 0)),
                      mode="edge")

    qt = quality_tables(quality)
    planes = [(np.pad(y, ((0, ph - len(y)), (0, 0)), mode="edge"), 0),
              (down(cb), 1), (down(cr), 1)]
    ctab = {k: {s: (code, n) for s, code, n in _huff_codes(*v)}
            for k, v in _STD_HUFF.items()}
    coefs = []
    for plane, t in planes:
        blk = _blocks(plane - 128)
        coefs.append(_fdct_quantize(blk.reshape(blk.shape[:2] + (8, 8)),
                                    qt[t])[..., ZIGZAG])
    # libjpeg codes the luma blocks of a partial MCU past the image as
    # dummies: zero AC, the DC of the previous block in the MCU
    y_zz = coefs[0]
    bw_, bh_ = _ceil(W, 8), _ceil(H, 8)
    if bw_ % 2:
        y_zz[:, bw_] = 0
        y_zz[:, bw_, 0] = y_zz[:, bw_ - 1, 0]
    if bh_ % 2:
        y_zz[bh_] = 0
        y_zz[bh_, :, 0] = y_zz[bh_ - 1, 1::2, 0].repeat(2)

    bw = _BitWriter()
    preds = [0, 0, 0]
    for my in range(ph // 16):
        for mx in range(pw // 16):
            units = [(0, 2 * my + dy, 2 * mx + dx)
                     for dy in (0, 1) for dx in (0, 1)]
            units += [(1, my, mx), (2, my, mx)]
            for ci, r, c in units:
                t = planes[ci][1]
                zz = coefs[ci][r, c]
                dc_tab, ac_tab = ctab[(0, t)], ctab[(1, t)]
                diff = int(zz[0]) - preds[ci]
                preds[ci] = int(zz[0])
                _put_value(bw, dc_tab, 0, diff)
                nz = np.flatnonzero(zz[1:]) + 1
                last = 0
                for k in nz.tolist():
                    run = k - last - 1
                    while run > 15:
                        bw.put(*ac_tab[0xF0])
                        run -= 16
                    _put_value(bw, ac_tab, run << 4, int(zz[k]))
                    last = k
                if last != 63:
                    bw.put(*ac_tab[0x00])
    bw.flush()

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = bytearray(b"\xff\xd8")
    out += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in (0, 1):
        out += seg(0xDB, bytes([t]) + bytes(
            qt[t][ZIGZAG].astype(np.uint8).tolist()))
    out += seg(0xC0, struct.pack(">BHHB", 8, H, W, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (tc, th), (counts, syms) in sorted(_STD_HUFF.items(),
                                           key=lambda kv: kv[0][::-1]):
        out += seg(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + syms)
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += bw.out + b"\xff\xd9"
    with open(path, "wb") as f:
        f.write(bytes(out))


def _put_value(bw: _BitWriter, table, run_bits: int, value: int):
    """Huffman symbol (run << 4 | size) followed by the value's bits."""
    mag = abs(value)
    size = mag.bit_length()
    bw.put(*table[run_bits | size])
    if size:
        bw.put(value if value > 0 else value + (1 << size) - 1, size)


# ---------------------------------------------------------------------------
# The JAX module's helpers
# ---------------------------------------------------------------------------

def io_mkdir(newpath: str):
    """mkdir -p."""
    Path(newpath).mkdir(parents=True, exist_ok=True)


def save_image(img, filename: str):
    """Save a [0, 1] float array, stored as (255.9 * clip).astype(uint8),
    or a uint8 array: (H, W) grayscale, (H, W, 3) RGB or (H, W, 4) RGBA
    as PNG (`.png`), RGB as JPEG at PIL's default quality of 75
    (`.jpg`, `.jpeg`). Any other suffix raises ValueError."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (255.9 * np.clip(img, 0.0, 1.0)).astype(np.uint8)
    suffix = Path(filename).suffix.lower()
    if suffix == ".png":
        write_png(filename, img)
    elif suffix in (".jpg", ".jpeg"):
        write_jpeg(filename, img, quality=75)
    else:
        raise ValueError(f"save_image: unsupported file suffix {suffix!r} "
                         f"(.png, .jpg or .jpeg)")
