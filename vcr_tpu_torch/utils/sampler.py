"""StreamSampler, a bounded uniform random sample of (hyp, ref, vid_key)
triples for console display, and the sample printer: a copy of
``vcr_tpu/utils/sampler.py``.
"""

from __future__ import annotations

import random
from typing import Any, List


class StreamSampler:
    def __init__(self, num_samples: int, seed: int | None = None):
        self.num_samples = num_samples
        self.samples: List = []
        self._rand = random.Random(seed)

    def draw_key(self) -> float:
        return self._rand.random()

    def would_accept(self, key: float) -> bool:
        """True if an item with this reservoir key would enter the sample.
        Lets callers skip materializing items that won't be kept, which
        saves a device-to-host copy for most batches."""
        return (len(self.samples) < self.num_samples
                or key < self.samples[-1][0])

    def add_with_key(self, key: float, obj: Any) -> None:
        self.samples.append((key, obj))
        self.samples.sort(key=lambda x: x[0])
        if len(self.samples) > self.num_samples:
            self.samples = self.samples[:-1]

    def add(self, obj: Any) -> None:
        self.add_with_key(self.draw_key(), obj)

    def get(self) -> List[Any]:
        return [s[1] for s in self.samples]


def print_sample_sents(tups) -> None:
    print("*" * 33 + " Samples " + "*" * 33)
    for hyp, ref, vk in tups:
        print(f"Video ID   : {vk}")
        print(f"Hypothesis : {hyp}")
        print(f"Reference  : {ref}")
        print("")
    print("*" * 75)
