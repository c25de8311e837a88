"""Image reading/writing/resizing for the feature pipeline (replaces FreeImage
Bitmap, src/util/bitmap.{h,cc}, and ImageReader resizing,
src/feature/extraction.cc).

Images are decoded with Pillow when it imports. Without it, 8-bit
non-interlaced PNG (grey, grey+alpha, RGB, RGBA, palette) is still read here
with numpy + zlib, so the main path needs no imaging library; that reader
undoes Average/Paeth row filters in a per-byte Python loop, far slower than
Pillow on adaptively filtered files such as libpng writes. Every other format
(JPEG, TIFF, 16-bit or interlaced PNG, ...) needs Pillow and says so. PNG is
always written here (Sub filter), which both readers decode row-vectorised.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel


def _pillow(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading or writing {path} needs Pillow (only 8-bit non-interlaced "
            "PNG is built in)"
        ) from e
    return Image


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec §9) -> [H, W*bpp] uint8."""
    stride = W * bpp
    rows = np.frombuffer(raw, np.uint8)[: H * (stride + 1)].reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, f = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = f.copy()
        elif ftype == 1:  # Sub: running sum along x, per channel, mod 256
            cur = np.cumsum(f.reshape(W, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = f + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential along x
            fl, pr = f.tolist(), prior.tolist()
            cur_l = [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = pr[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, pr[x - bpp] if x >= bpp else 0)
                cur_l[x] = (fl[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _read_png(path: str) -> np.ndarray | None:
    """[H, W] or [H, W, C] uint8 (C = 2/3/4 as stored, palette expanded to
    RGB(A)); None if the file is not a PNG this reader handles."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_PNG_SIG):
        return None
    pos, idat, plte, trns = 8, [], None, None
    W = H = depth = ctype = interlace = None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            W, H, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), H, W, ch).reshape(H, W, ch)
    if ctype == 3:
        lut = plte
        if trns is not None:
            alpha = np.full((plte.shape[0], 1), 255, np.uint8)
            alpha[: len(trns), 0] = trns[: plte.shape[0]]
            lut = np.concatenate([plte, alpha], axis=1)
        return lut[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H,W] grey or [H,W,3|4] RGB(A) uint8 as PNG (Sub filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    H, W = img.shape[:2]
    px = img.reshape(H, W, ch)
    sub = px.copy()
    sub[:, 1:] -= px[:, :-1]  # uint8 wraps mod 256, as the filter wants
    rows = np.concatenate(
        [np.ones((H, 1), np.uint8), sub.reshape(H, W * ch)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(_PNG_SIG)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        fh.write(chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write uint8 grey/RGB(A): PNG built in, other formats via Pillow."""
    if os.path.splitext(path)[1].lower() == ".png":
        write_png(path, img)
    else:
        _pillow(path).fromarray(np.asarray(img, np.uint8)).save(path)


def _luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma, the integer rounding Pillow's "L" conversion uses."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _read(path: str, mode: str) -> np.ndarray:
    """uint8 image in mode "L" ([H,W]) or "RGB" ([H,W,3])."""
    try:
        from PIL import Image
    except ImportError:
        return _read_builtin(path, mode)
    with Image.open(path) as im:
        return np.asarray(im.convert(mode), np.uint8)


def _read_builtin(path: str, mode: str) -> np.ndarray:
    img = _read_png(path)
    if img is None:
        _pillow(path)  # raises: not a PNG this reader handles, and no Pillow
    if img.ndim == 2 or img.shape[2] == 2:  # grey (+ alpha)
        g = img if img.ndim == 2 else img[..., 0]
        return g if mode == "L" else np.repeat(g[..., None], 3, axis=2)
    return _luma(img) if mode == "L" else img[..., :3]


def image_size(path: str) -> tuple[int, int]:
    """(width, height) without decoding the pixels when the file is a PNG."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head.startswith(_PNG_SIG) and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    with _pillow(path).open(path) as im:
        return im.size


def imread_gray(path: str) -> np.ndarray:
    """Read an image as float32 grayscale in [0, 1]."""
    return _read(path, "L").astype(np.float32) / 255.0


def imread_gray_u8(path: str) -> np.ndarray:
    """Read an image as uint8 grayscale — the extraction pipeline ships
    uint8 to the device (4x less host->device traffic than f32) and
    normalizes there."""
    return _read(path, "L")


def imread_rgb(path: str) -> np.ndarray:
    return _read(path, "RGB")


def _lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 3.0, np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _resample_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """(idx, w), each [n_out, K]: antialiased Lanczos-3 taps with the support
    and normalisation of Pillow's ImagingResample (precompute_coeffs).
    Taps past the kernel's support carry weight 0 on a clamped index."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    centers = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    hi = np.minimum((centers + support + 0.5).astype(np.int64), n_in)
    K = int((hi - lo).max())
    x = lo[:, None] + np.arange(K)[None, :]
    w = _lanczos3((x - centers[:, None] + 0.5) / fscale)
    w = np.where(x < hi[:, None], w, 0.0)
    return np.minimum(x, n_in - 1), w / w.sum(axis=1, keepdims=True)


def _resample_axis(arr: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Resample one axis, rounding back to uint8 (Pillow's 8-bit passes)."""
    idx, w = _resample_taps(arr.shape[axis], n_out)
    shape = [1] * arr.ndim
    shape[axis] = n_out
    acc = np.zeros(arr.shape[:axis] + (n_out,) + arr.shape[axis + 1:], np.float64)
    for k in range(idx.shape[1]):
        acc += np.take(arr, idx[:, k], axis=axis) * w[:, k].reshape(shape)
    return np.clip(np.round(acc), 0, 255).astype(np.uint8)


def resize_max(img: np.ndarray, max_size: int) -> tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size. Returns (image, scale_factor)
    (SiftExtractionOptions.max_image_size handling, feature/extraction.cc).

    Separable antialiased Lanczos-3, horizontal pass then vertical with 8-bit
    rounding between them, as Pillow's LANCZOS resize does."""
    H, W = img.shape[:2]
    m = max(H, W)
    if m <= max_size:
        return img, 1.0
    scale = max_size / m
    u8 = img.dtype == np.uint8
    arr = img if u8 else np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    out = _resample_axis(_resample_axis(arr, int(W * scale), 1), int(H * scale), 0)
    return (out if u8 else out.astype(np.float32) / 255.0), scale


def pad_to(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Zero-pad to a fixed shape (static-shape batching for the extractor)."""
    out = np.zeros((H, W), img.dtype)
    out[: img.shape[0], : img.shape[1]] = img[:H, :W]
    return out
