"""Host-side batch loader.

Counterpart of ``causal_gen_tpu/data/loader.py`` (replaces torch DataLoader and
its workers, reference train_setup.py:16-39): a shuffled index permutation per
epoch and whole-batch numpy augmentation, deterministic given ``seed`` (one
``np.random.Generator`` per loader, advanced per epoch), so that a seed gives
the JAX package's batches. Batches stay numpy; the trainer moves them to the
device. With ``concat_pa=False`` a batch holds each parent under its own
name instead of the concatenated ``pa`` (the PGM trainer's batches).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from causal_gen_tpu_torch.data.datasets import ArrayDataset


class Loader:
    def __init__(self, dataset: ArrayDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, max_batches: Optional[int] = None,
                 concat_pa: bool = True):
        self.ds = dataset
        self.concat_pa = concat_pa
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_batches = max_batches  # cap for smoke runs
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.ds)
        n_b = n // self.bs if self.drop_last else -(-n // self.bs)
        return min(n_b, self.max_batches) if self.max_batches else n_b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.bs) * self.bs if self.drop_last else n
        for k, i in enumerate(range(0, stop, self.bs)):
            if self.max_batches is not None and k >= self.max_batches:
                return
            yield self.ds.batch(order[i: i + self.bs], rng=self._rng, concat_pa=self.concat_pa)


class PrefetchLoader:
    """Assembles the next batches in a background thread while the device
    runs the current step. Order and random draws are the wrapped loader's."""

    def __init__(self, loader: Loader, depth: int = 2):
        self.loader = loader
        self.depth = depth
        self.ds = loader.ds

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
                put(end)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def setup_loaders(datasets: Dict[str, ArrayDataset], batch_size: int, seed: int = 0,
                  max_batches: Optional[int] = None, prefetch: bool = True,
                  concat_pa: bool = True) -> Dict[str, object]:
    def build(split, ds, i):
        loader = Loader(ds, batch_size, shuffle=(split == "train"), drop_last=(split == "train"),
                        seed=seed + i, max_batches=max_batches, concat_pa=concat_pa)
        return PrefetchLoader(loader) if prefetch and split == "train" else loader

    return {split: build(split, ds, i) for i, (split, ds) in enumerate(datasets.items())}
