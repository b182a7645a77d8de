"""`captra_tpu_torch/data/image_io.py` against OpenCV: `read_png(p,
unchanged=True)` equals `cv2.imread(p, -1)` and `read_png(p)` equals
`cv2.imread(p)`, value for value and in dtype and shape, on PNGs written by
OpenCV and on PNGs of every supported colour type and bit depth written
with each scanline filter (0-4), the chip script's fixture writer's
included.  Unsupported or broken files raise."""
import struct
import zlib

import numpy as np
import pytest

from captra_tpu_torch.data.image_io import CHANNELS, read_png
from tests.torch_port_helpers import png_filter_row

cv2 = pytest.importorskip("cv2")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(samples: np.ndarray, color: int, bits: int,
               filters=(0, 1, 2, 3, 4), interlace: int = 0) -> bytes:
    """samples [H, W, C] in the file's channel order -> PNG bytes, row r
    filtered with filters[r % len(filters)]."""
    H, W, C = samples.shape
    flat = samples.reshape(H, W * C)
    raw = (flat.astype(">u2").view(np.uint8).reshape(H, -1) if bits == 16
           else flat.astype(np.uint8))
    bpp = C * bits // 8
    prev, body = bytes(raw.shape[1]), b""
    for r in range(H):
        kind = filters[r % len(filters)]
        cur = raw[r].tobytes()
        body += bytes([kind]) + png_filter_row(kind, cur, prev, bpp)
        prev = cur
    header = struct.pack(">IIBBBBB", W, H, bits, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


def _assert_as_cv2(path):
    for unchanged, flag in ((True, -1), (False, cv2.IMREAD_COLOR)):
        got, want = read_png(str(path), unchanged), cv2.imread(str(path), flag)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color", sorted(CHANNELS))
@pytest.mark.parametrize("bits", [8, 16])
def test_every_colour_type_and_filter_reads_as_cv2(tmp_path, color, bits):
    rng = np.random.RandomState(color * 100 + bits)
    samples = rng.randint(0, 1 << bits, (11, 9, CHANNELS[color]))
    samples[4:7] = samples[3]            # flat runs: filters predict exactly
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(samples, color, bits))
    _assert_as_cv2(path)


@pytest.mark.parametrize("shape,dtype", [
    ((48, 64), np.uint16), ((48, 64), np.uint8), ((48, 64, 3), np.uint8),
    ((48, 64, 4), np.uint8), ((48, 64, 3), np.uint16)])
def test_cv2_written_images_read_as_cv2(tmp_path, shape, dtype):
    """What the NOCS reader meets: 16-bit depth, 8-bit colour masks."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, np.iinfo(dtype).max, shape).astype(dtype)
    img[10:30, 20:40] = img[10, 20]
    path = tmp_path / "x.png"
    cv2.imwrite(str(path), img)
    _assert_as_cv2(path)


@pytest.mark.parametrize("shape,dtype", [((21, 13), np.uint16),
                                         ((21, 13, 3), np.uint8)])
def test_chip_script_pngs_read_as_cv2(tmp_path, shape, dtype):
    """The data phase's depth and mask images (`chip_smoke.png_bytes`): rows
    filtered in turn with filters 0-4, as the specification writes them,
    read back as the image by `read_png` and OpenCV alike."""
    import chip_smoke
    rng = np.random.RandomState(1)
    img = rng.randint(0, np.iinfo(dtype).max, shape).astype(dtype)
    img[5:9] = img[4]
    path = tmp_path / "x.png"
    path.write_bytes(chip_smoke.png_bytes(img))
    _assert_as_cv2(path)
    np.testing.assert_array_equal(read_png(str(path), unchanged=True), (
        img if dtype == np.uint16 else img[..., ::-1]))
    rows = (img.astype(">u2").view(np.uint8).reshape(len(img), -1)
            if dtype == np.uint16 else img.reshape(len(img), -1))
    bpp = 2 if dtype == np.uint16 else 3
    data = chip_smoke.png_filter(rows, bpp)
    prev = bytes(rows.shape[1])
    for r, row in enumerate(rows):
        assert data[r, 0] == r % 5
        assert data[r, 1:].tobytes() == png_filter_row(
            r % 5, row.tobytes(), prev, bpp)
        prev = row.tobytes()


def _bad(tmp_path, data: bytes):
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    return str(path)


def test_unsupported_and_broken_files_raise(tmp_path):
    grey = np.zeros((4, 4, 1), np.uint8)
    good = encode_png(grey, 0, 8)
    cases = {
        "colour type 3": (good[:8] + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)) + good[33:]),
        "interlaced": encode_png(grey, 0, 8, interlace=1),
        "bit depth 4": (good[:8] + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 4, 4, 4, 0, 0, 0, 0)) + good[33:]),
        "not a PNG": b"GIF89a" + good[6:],
        "bad CRC": good[:29] + bytes([good[29] ^ 1]) + good[30:],
        "truncated": good[:-20],
        "tRNS": good[:33] + _chunk(b"tRNS", b"\x00\x00") + good[33:],
        "unknown PNG filter": encode_png(grey, 0, 8, filters=(5,)),
    }
    for what, data in cases.items():
        path = _bad(tmp_path, data)
        with pytest.raises(ValueError) as err:
            read_png(path)
        assert path in str(err.value), what
    with pytest.raises(FileNotFoundError):
        read_png(str(tmp_path / "missing.png"))
