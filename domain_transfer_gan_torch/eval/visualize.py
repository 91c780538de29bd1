"""Image grids as PNG files, with the upstream
``torchvision.utils.save_image(normalize=True, range=(-1, 1), nrow=...)``
contract and the JAX package's ``eval/visualize.py`` pixels: grey (128)
padding of 2, values mapped from [-1, 1] to uint8 with round-half-up.

The PNG is written with the standard library (``zlib`` + ``struct``: IHDR,
one IDAT of filter-0 scanlines, IEND; 8-bit RGB).

All images are NHWC numpy arrays or tensors (tensors are copied to the
host here).
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def one_to_three_channels(img) -> np.ndarray:
    """Pad 1-channel images to 3 with zero channels."""
    img = to_numpy(img)
    if img.shape[-1] == 1:
        zeros = np.zeros_like(img)
        return np.concatenate([img, zeros, zeros], axis=-1)
    return img


def _to_uint8(img: np.ndarray, lo: float = -1.0, hi: float = 1.0
              ) -> np.ndarray:
    img = np.clip((np.asarray(img, dtype=np.float32) - lo) / (hi - lo), 0, 1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("write_png takes (H, W, 3) uint8, got %r"
                         % (rgb.shape,))
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def grid_pixels(images, nrow: int = 8, padding: int = 2,
                value_range=(-1.0, 1.0)) -> np.ndarray:
    """The (H', W', 3) uint8 grid: ``nrow`` images per row, grey padding."""
    images = to_numpy(images)
    if images.ndim == 3:
        images = images[None]
    images = one_to_three_channels(images[..., :3])
    n, h, w, _ = images.shape
    nrows = (n + nrow - 1) // nrow
    grid = np.full((nrows * (h + padding) + padding,
                    nrow * (w + padding) + padding, 3), 128, dtype=np.uint8)
    u8 = _to_uint8(images, *value_range)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = u8[i]
    return grid


def save_image_grid(images, save_path: str, nrow: int = 8, padding: int = 2,
                    value_range=(-1.0, 1.0)):
    """Tile (N, H, W, C) images into a grid PNG."""
    write_png(save_path, grid_pixels(images, nrow, padding, value_range))


def interleave_columns(images: Sequence) -> np.ndarray:
    """Stack k same-shape (N, H, W, C) arrays so sample i's k versions are
    consecutive (the upstream unsqueeze(1) + cat + view layout)."""
    arrs = [to_numpy(a) for a in images]
    n = arrs[0].shape[0]
    stacked = np.stack(arrs, axis=1)  # (N, k, H, W, C)
    return stacked.reshape((n * len(arrs),) + arrs[0].shape[1:])


def visualize_data(opt, data: Sequence, size, save_path: str):
    """Interleaved image-grid PNG, one column per array of ``data``."""
    imgs = [one_to_three_channels(to_numpy(d)[..., :3]) for d in data]
    grid = interleave_columns(imgs)
    save_image_grid(grid, save_path, nrow=len(imgs))


def multi_grid(opt, real_A, model) -> np.ndarray:
    """(real_A | ``num_multi`` samples over one shared z-set) grid body."""
    real_A = model._tensor(real_A)
    n = real_A.shape[0]
    z_set = model.sample_prior_z(opt.num_multi)
    multi_z = z_set.repeat(n, 1)
    multi_fake_B = to_numpy(model.generate_multi(real_A, multi_z))
    multi_fake_B = multi_fake_B.reshape((n, opt.num_multi)
                                        + multi_fake_B.shape[1:])
    cols = [to_numpy(real_A)] + [multi_fake_B[:, i]
                                 for i in range(opt.num_multi)]
    return interleave_columns([one_to_three_channels(c[..., :3])
                               for c in cols])


def inference_grid(opt, real_A, real_B, model):
    """Posterior-z transfer grid (a header row of B's, then one row per A
    decoded with every B's posterior z) and its row length less one."""
    real_A = model._tensor(real_A)
    real_B = model._tensor(real_B)[:opt.num_multi]
    n = real_A.shape[0]
    num = real_B.shape[0]  # may be < num_multi on small dev sets
    multi_fake_B = to_numpy(model.inference_multi(real_A, real_B))
    multi_fake_B = multi_fake_B.reshape((n, num) + multi_fake_B.shape[1:])
    cols = [to_numpy(real_A)] + [multi_fake_B[:, i] for i in range(num)]
    body = interleave_columns([one_to_three_channels(c[..., :3])
                               for c in cols])
    header = np.concatenate(
        [np.ones((1,) + body.shape[1:], body.dtype),
         one_to_three_channels(to_numpy(real_B)[..., :3])], axis=0)
    return np.concatenate([header, body], axis=0), num


def cycle_B_multi_grid(opt, real_B, model) -> np.ndarray:
    """(real_B | fake_A | ``num_multi`` B's decoded from fake_A over one
    shared z-set) grid body."""
    real_B = model._tensor(real_B)
    n = real_B.shape[0]
    multi_z = model.sample_prior_z(opt.num_multi).repeat(n, 1)
    fake_A, multi_fake_B = model.generate_cycle_B_multi(real_B, multi_z)
    multi_fake_B = to_numpy(multi_fake_B)
    multi_fake_B = multi_fake_B.reshape((n, opt.num_multi)
                                        + multi_fake_B.shape[1:])
    cols = [to_numpy(real_B), to_numpy(fake_A)] + \
        [multi_fake_B[:, i] for i in range(opt.num_multi)]
    return interleave_columns([one_to_three_channels(c[..., :3])
                               for c in cols])


def multi_cycle_grid(real_B, model, steps: int = 4) -> np.ndarray:
    """(B | A1 | B1 | ... | A_steps | B_steps) grid body of
    ``generate_multi_cycle``."""
    images = model.generate_multi_cycle(model._tensor(real_B), steps=steps)
    return interleave_columns([one_to_three_channels(to_numpy(im)[..., :3])
                               for im in images])
