"""PNG reading in numpy, zlib and the host core, for the NOCS reader's
depth and mask images (no OpenCV: the readers need only these two reads).

`read_png(path, unchanged=True)` returns what `cv2.imread(path, -1)`
returns and `read_png(path)` what `cv2.imread(path)` returns:

- unchanged: the stored bit depth (uint8 or uint16); grey -> [H, W], grey
  with alpha -> [H, W, 4] (grey, grey, grey, alpha), RGB -> [H, W, 3] in
  BGR order, RGBA -> [H, W, 4] in BGRA order;
- colour (the default): uint8 [H, W, 3] in BGR order, 16-bit samples
  shifted right by 8, grey replicated, alpha dropped.

It reads non-interlaced images of bit depth 8 or 16 in colour types 0
(grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA), with filters 0-4 (undone
by the host core, `native.png_unfilter`).  Any other image (a palette, an
interlaced one, other bit depths, a tRNS chunk, a bad CRC or a truncated
file) raises `ValueError` naming the file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from captra_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # colour type -> samples a pixel


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _decode(path: str) -> tuple[np.ndarray, int]:
    """The image's samples as stored: [H, W, C] uint8 or uint16 (grey,
    grey-alpha, RGB or RGBA order), and its colour type."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype in (b"PLTE", b"tRNS"):
            raise ValueError(f"{path}: PNG chunk {ctype.decode()} is not "
                             "supported")
        elif ctype[0] & 0x20 == 0 and ctype != b"IEND":
            raise ValueError(f"{path}: unknown critical PNG chunk {ctype!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    W, H, bits, color, compression, filt, interlace = header
    if color not in CHANNELS or bits not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {color} at bit depth "
                         f"{bits} is not supported (types 0, 2, 4, 6 at 8 "
                         "or 16 bits)")
    if interlace != 0 or compression != 0 or filt != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG "
                         f"(interlace {interlace}, compression "
                         f"{compression}, filter method {filt})")
    C = CHANNELS[color]
    bpp = C * bits // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise ValueError(f"{path}: corrupt PNG image data ({err})") from None
    try:
        rows = native.png_unfilter(raw, H, W * bpp, bpp)
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
    if bits == 16:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    return samples.reshape(H, W, C), color


def read_png(path: str, unchanged: bool = False) -> np.ndarray:
    """`cv2.imread(path, -1)` (unchanged=True) or `cv2.imread(path)` of a
    PNG file; see the module docstring."""
    samples, color = _decode(path)
    if color in (0, 4):                        # grey [+ alpha]
        grey = samples[..., :1]
        bgr = np.concatenate([grey, grey, grey], axis=-1)
        alpha = samples[..., 1:] if color == 4 else None
    else:                                      # RGB [+ alpha]
        bgr = samples[..., 2::-1]
        alpha = samples[..., 3:] if color == 6 else None
    if unchanged:
        if color == 0:
            return np.ascontiguousarray(samples[..., 0])
        if alpha is None:
            return np.ascontiguousarray(bgr)
        return np.concatenate([bgr, alpha], axis=-1)
    if samples.dtype == np.uint16:
        bgr = bgr >> 8
    return np.ascontiguousarray(bgr, dtype=np.uint8)
