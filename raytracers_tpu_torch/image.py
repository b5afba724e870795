"""L4 image handling: colour -> packed-pixel quantization, PPM and PNG I/O.

Counterpart of ``raytracers_tpu.image``: each channel is ``int(255.99 * c)``
(truncation toward zero, no clamp) packed as ``(r<<16)|(g<<8)|b`` in one
int32 (futhark/ray.fut:156-162); the PPM is the reference program's plain
"P3" text format (futhark/main.c:10-24).
"""
from __future__ import annotations

import numpy as np
import torch


def colour_to_pixel(c: torch.Tensor) -> torch.Tensor:
    """(..., 3) float colour -> (...) int32 packed 0x00RRGGBB."""
    q = (255.99 * c).to(torch.int32)
    return (q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]


def pixel_to_rgb(p) -> np.ndarray:
    """(...) int32 packed -> (..., 3) uint8."""
    p = np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF],
                    axis=-1).astype(np.uint8)


def image_to_ppm_bytes(img) -> bytes:
    """Packed int32 (h, w) image -> P3 PPM file contents."""
    rgb = pixel_to_rgb(img)
    h, w = rgb.shape[:2]
    header = f"P3\n{w} {h}\n255\n"
    body = "\n".join(f"{r} {g} {b}" for r, g, b in rgb.reshape(-1, 3)) + "\n"
    return (header + body).encode()


def write_ppm(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(image_to_ppm_bytes(img))


def write_png(path: str, img) -> None:
    """PNG output (the reference's Haskell variant writes PNG,
    haskell/ray.hs:25); requires PIL."""
    from PIL import Image
    Image.fromarray(pixel_to_rgb(img)).save(path)


def write_image(path: str, img) -> None:
    """Write PPM or PNG by the file extension."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        write_ppm(path, img)


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM into an (h, w) packed-int32 numpy image."""
    with open(path, "rb") as f:
        tokens = f.read().split()
    if tokens[0] != b"P3" or int(tokens[3]) != 255:
        raise ValueError(f"{path}: only plain P3 PPM with maxval 255 is read")
    w, h = int(tokens[1]), int(tokens[2])
    vals = np.array(tokens[4:4 + 3 * w * h], dtype=np.int64).astype(np.int32)
    rgb = vals.reshape(h, w, 3)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
