"""Aspect-ratio bucketing and resumable sampling, host-side numpy (the
port's copy of ``more4d_tpu/data/buckets.py``).

The ASPECT_RATIO_512 bucket table, a shuffling sampler whose position
(``_pos_start``) goes through a checkpoint so a resumed run continues the
data order, and a batch sampler that groups samples by their closest
aspect bucket. Each bucket shape is its own set of kernel shapes on the
card; the training CLI keeps to a few canonical buckets.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

# the 512-base table of the reference's bucket sampler
ASPECT_RATIO_512 = {
    "0.25": (256, 1024), "0.26": (256, 992), "0.27": (256, 960),
    "0.28": (256, 928), "0.32": (288, 896), "0.33": (288, 864),
    "0.35": (288, 832), "0.4": (320, 800), "0.42": (320, 768),
    "0.48": (352, 736), "0.5": (352, 704), "0.52": (352, 672),
    "0.57": (384, 672), "0.6": (384, 640), "0.68": (416, 608),
    "0.72": (416, 576), "0.78": (448, 576), "0.82": (448, 544),
    "0.88": (480, 544), "0.94": (480, 512), "1.0": (512, 512),
    "1.07": (512, 480), "1.13": (544, 480), "1.21": (544, 448),
    "1.29": (576, 448), "1.38": (576, 416), "1.46": (608, 416),
    "1.67": (640, 384), "1.75": (672, 384), "2.0": (704, 352),
    "2.09": (736, 352), "2.4": (768, 320), "2.5": (800, 320),
    "2.89": (832, 288), "3.0": (864, 288), "3.11": (896, 288),
    "3.62": (928, 256), "3.75": (960, 256), "3.88": (992, 256),
    "4.0": (1024, 256),
}


def closest_bucket(height: int, width: int,
                   table: Dict[str, tuple] = ASPECT_RATIO_512) -> str:
    ratio = height / width
    return min(table, key=lambda k: abs(float(k) - ratio))


class ResumableSampler:
    """Shuffled index stream with a checkpointable position: each epoch
    is a permutation from ``RandomState(seed + epoch)``."""

    def __init__(self, length: int, seed: int = 0, shuffle: bool = True):
        self.length = length
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        self._pos_start = 0

    def state_dict(self):
        return {"epoch": self.epoch, "pos_start": self._pos_start,
                "seed": self.seed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self._pos_start = state["pos_start"]
        self.seed = state.get("seed", self.seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(self.length) if self.shuffle \
                else np.arange(self.length)
            for i in range(self._pos_start, self.length):
                self._pos_start = i + 1
                yield int(order[i])
            self._pos_start = 0
            self.epoch += 1


class AspectRatioBatchSampler:
    """Groups sample indices into per-bucket batches of ``batch_size``,
    each sample in the bucket whose ratio is closest to its own."""

    def __init__(self, sampler: ResumableSampler,
                 aspect_ratios: Sequence[float], batch_size: int,
                 table: Dict[str, tuple] = ASPECT_RATIO_512,
                 drop_last: bool = True):
        self.sampler = sampler
        self.aspect_ratios = aspect_ratios
        self.batch_size = batch_size
        self.table = table
        self.drop_last = drop_last

    def __iter__(self):
        pools: Dict[str, List[int]] = {}
        for idx in self.sampler:
            ratio = self.aspect_ratios[idx]
            key = min(self.table, key=lambda k: abs(float(k) - ratio))
            pool = pools.setdefault(key, [])
            pool.append(idx)
            if len(pool) == self.batch_size:
                yield key, pool[:]
                pool.clear()
