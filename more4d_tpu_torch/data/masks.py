"""Random inpainting masks, host-side numpy (the port's copy of
``more4d_tpu/data/masks.py``): ten strategies with the reference's
selection probabilities MASK_PROBS. For the same ``RandomState`` the port
draws the JAX package's masks bit for bit. Returns [F, H, W, 1] uint8
(1 = hole).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MASK_PROBS = [0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.1, 0.05, 0.05]


def _block(rng, mask, h, w, frames=slice(None)):
    cx, cy = rng.randint(0, w), rng.randint(0, h)
    bx = rng.randint(w // 4, w // 4 * 3)
    by = rng.randint(h // 4, h // 4 * 3)
    x0, x1 = max(cx - bx // 2, 0), min(cx + bx // 2, w)
    y0, y1 = max(cy - by // 2, 0), min(cy + by // 2, h)
    mask[frames, y0:y1, x0:x1] = 1
    return mask


def _ellipse(rng, mask, h, w, circle=False):
    cx, cy = rng.randint(0, w), rng.randint(0, h)
    m = min(h, w)
    if circle:
        r = rng.randint(m // 8, m // 4)
        a = b = r
    else:
        a = rng.randint(m // 8, m // 4)
        b = rng.randint(m // 8, m // 4)
    yy, xx = np.mgrid[0:h, 0:w]
    inside = ((yy - cy) ** 2) / (b ** 2) + ((xx - cx) ** 2) / (a ** 2) < 1
    mask[:, inside] = 1
    return mask


def get_random_mask(shape: Tuple[int, int, int], image_start_only=False,
                    rng=None) -> np.ndarray:
    """shape: (f, h, w). Returns [f, h, w, 1] uint8 with 1 = hole."""
    rng = rng or np.random.RandomState()
    f, h, w = shape
    mask = np.zeros((f, h, w), np.uint8)

    if image_start_only:
        if f != 1:
            mask[1:] = 1
        else:
            mask[:] = 1
        return mask[..., None]

    mtype = rng.choice(10, p=MASK_PROBS) if f != 1 \
        else rng.choice([0, 1], p=[0.2, 0.8])

    if mtype == 0:
        mask = _block(rng, mask, h, w)
    elif mtype == 1:
        mask[:] = 1
    elif mtype == 2:                       # temporal suffix
        mask[rng.randint(1, 5):] = 1
    elif mtype == 3:                       # temporal middle
        s = rng.randint(1, 5)
        mask[s:-s] = 1
    elif mtype == 4:                       # spatio-temporal block
        f0 = rng.randint(0, max(f // 2, 1))
        f1 = rng.randint(f // 2, f)
        mask = _block(rng, mask, h, w, frames=slice(f0, f1))
    elif mtype == 5:                       # random noise
        mask = rng.randint(0, 2, (f, h, w)).astype(np.uint8)
    elif mtype == 6:                       # scattered blocks
        n = rng.randint(1, max(f // 2, 1) + 1)
        for i in rng.choice(f, size=n, replace=False):
            bh = rng.randint(1, max(h // 4, 2))
            bw = rng.randint(1, max(w // 4, 2))
            y0 = rng.randint(0, h - bh + 1)
            x0 = rng.randint(0, w - bw + 1)
            mask[i, y0:y0 + bh, x0:x0 + bw] = 1
    elif mtype == 7:
        mask = _ellipse(rng, mask, h, w, circle=False)
    elif mtype == 8:
        mask = _ellipse(rng, mask, h, w, circle=True)
    elif mtype == 9:                       # random frames
        for i in range(f):
            if rng.rand() > 0.5:
                mask[i] = 1
    return mask[..., None]
