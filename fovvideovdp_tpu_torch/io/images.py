"""Image loading: PNG (incl. 16-bit), JPEG, EXR, Radiance .hdr.

Counterpart of ``fovvideovdp_tpu/io/images.py:14-143`` (numpy only, so a
copy).  cv2 and PIL are imported when an image is read, never at import:
a machine without them can still read Radiance .hdr files through the
built-in reader.
"""
from __future__ import annotations

import logging
import os

import numpy as np


def _read_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader returning float32 HxWx3 linear RGB."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if not line.startswith(b"#?"):
            raise RuntimeError(f"{path}: not a Radiance HDR file")
        # header
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise RuntimeError(f"{path}: unsupported HDR orientation")
        H, W = int(dims[1]), int(dims[3])

        data = np.zeros((H, W, 4), dtype=np.uint8)
        for y in range(H):
            head = f.read(4)
            if len(head) < 4:
                raise RuntimeError(f"{path}: truncated HDR file")
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == W:
                # adaptive RLE, per-component
                row = np.zeros((4, W), dtype=np.uint8)
                for c in range(4):
                    x = 0
                    while x < W:
                        b = f.read(1)
                        if not b:
                            raise RuntimeError(f"{path}: truncated HDR file")
                        n = b[0]
                        if n > 128:  # run
                            v = f.read(1)
                            if not v:
                                raise RuntimeError(
                                    f"{path}: truncated HDR file")
                            row[c, x:x + n - 128] = v[0]
                            x += n - 128
                        elif n > 0:  # literal
                            lit = f.read(n)
                            if len(lit) < n:
                                raise RuntimeError(
                                    f"{path}: truncated HDR file")
                            row[c, x:x + n] = np.frombuffer(lit, dtype=np.uint8)
                            x += n
                        else:  # n == 0 never advances x: corrupt stream
                            raise RuntimeError(
                                f"{path}: corrupt HDR RLE (zero-length "
                                f"literal)")
                data[y] = row.T
            else:  # flat row
                rest = f.read(4 * W - 4)
                data[y] = np.frombuffer(head + rest, dtype=np.uint8).reshape(W, 4)

    rgbe = data.astype(np.float32)
    exp = np.ldexp(1.0, data[:, :, 3].astype(np.int32) - 136)  # 128 + 8
    rgb = rgbe[:, :, :3] * exp[:, :, None]
    rgb[data[:, :, 3] == 0] = 0.0
    return rgb.astype(np.float32)


def _read_exr(path: str) -> np.ndarray:
    try:
        import OpenEXR  # noqa
        import Imath  # noqa
    except ImportError:
        try:
            import imageio.v2 as io
            return np.asarray(io.imread(path))
        except Exception as e:
            raise RuntimeError(
                f"Reading {path} requires OpenEXR or imageio with an EXR plugin") from e
    f = OpenEXR.InputFile(path)
    dw = f.header()["dataWindow"]
    W = dw.max.x - dw.min.x + 1
    H = dw.max.y - dw.min.y + 1
    pt = Imath.PixelType(Imath.PixelType.FLOAT)
    chans = [np.frombuffer(f.channel(c, pt), dtype=np.float32).reshape(H, W)
             for c in ("R", "G", "B")]
    return np.stack(chans, axis=-1)


def _read_with_cv2(imgfile: str):
    try:
        import cv2
    except ImportError:
        return None
    img = cv2.imread(imgfile, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH
                     | cv2.IMREAD_ANYCOLOR)
    if img is None:
        return None
    if img.ndim == 3 and img.shape[2] >= 3:  # BGR(A) -> RGB(A)
        img = img[:, :, [2, 1, 0] + list(range(3, img.shape[2]))]
    return img


def load_image_as_array(imgfile: str) -> np.ndarray:
    """Load an image as HxWxC numpy array, preserving bit depth
    (uint8 / uint16 for LDR, float32 for HDR formats).

    Uses cv2 when available (full 16-bit PNG support — PIL/imageio silently
    downconvert 48-bit PNGs to uint8); falls back to PIL / builtin readers.
    """
    ext = os.path.splitext(imgfile)[1].lower()
    if ext == ".exr":
        img = _read_exr(imgfile)
    elif ext == ".hdr":
        img = _read_with_cv2(imgfile)
        if img is None:
            img = _read_radiance_hdr(imgfile)
    else:
        img = _read_with_cv2(imgfile)
    if img is None:
        from PIL import Image
        with Image.open(imgfile) as im:
            if im.mode in ("I;16", "I;16B", "I;16L", "I"):
                img = np.asarray(im, dtype=np.uint16)
            else:
                if im.mode not in ("RGB", "L"):
                    im = im.convert("RGB")
                img = np.asarray(im)

    if img.ndim == 3 and img.shape[2] > 3:
        logging.warning(
            f"Input image {imgfile} has more than 3 channels (alpha?). "
            "Ignoring the extra channels.")
        img = img[:, :, :3]
    if img.ndim == 2:
        img = img[:, :, np.newaxis]
    return img
