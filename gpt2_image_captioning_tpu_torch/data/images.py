"""Host-side image loading for embedding extraction — the counterpart of
``gpt2_image_captioning_tpu/data/images.py``.

- :class:`ImageDirectory` — a flat directory's images, sorted, with the
  reference's extension filter.
- :class:`ImageBatchLoader` — decode + preprocess in worker threads feeding
  a bounded set of ready batches of a fixed shape, with a ``valid`` mask on
  the tail, so the device does not wait on PIL.

PIL is imported only where an image is decoded: the machine with the card
has none, and feeds the towers pixels that are already at size.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterator

import numpy as np

VALID_EXTS = {".jpg", ".jpeg", ".png", ".webp"}


class ImageDirectory:
    """Flat-directory image listing, sorted for determinism."""

    def __init__(self, directory: str):
        self.directory = directory
        self.filenames = sorted(f for f in os.listdir(directory)
                                if os.path.splitext(f)[1].lower() in VALID_EXTS)

    def __len__(self) -> int:
        return len(self.filenames)

    def path(self, idx: int) -> str:
        return os.path.join(self.directory, self.filenames[idx])

    def load_rgb(self, idx: int) -> np.ndarray:
        """Decode to uint8 RGB (H, W, 3); greyscale and RGBA are converted as
        the reference's ``Image.open(...).convert("RGB")`` does."""
        from PIL import Image

        with Image.open(self.path(idx)) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)


class ImageBatchLoader:
    """Threaded decode / preprocess → fixed-shape batches, in order.

    ``preprocess(uint8 HWC) -> np.ndarray`` runs in ``num_workers`` threads
    (PIL's decode releases the GIL); at most ``prefetch`` batches of decoded
    images wait.  Yields ``(filenames, batch (B, ...), valid (B,))``; the
    last batch is padded by repeating its last image."""

    def __init__(self, directory: ImageDirectory | str,
                 preprocess: Callable[[np.ndarray], np.ndarray], batch_size: int = 64,
                 num_workers: int = 4, prefetch: int = 4):
        self.dir = ImageDirectory(directory) if isinstance(directory, str) else directory
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return -(-len(self.dir) // self.batch_size)

    def __iter__(self) -> Iterator[tuple[list[str], np.ndarray, np.ndarray]]:
        n = len(self.dir)
        if n == 0:
            return
        results: dict[int, np.ndarray | Exception] = {}
        done = threading.Condition()
        next_idx = [0]
        stop = threading.Event()
        max_backlog = max(1, self.prefetch) * self.batch_size

        def worker():
            while not stop.is_set():
                with done:
                    # check the backlog before claiming an index, so a claimed
                    # image is always delivered
                    while len(results) >= max_backlog and not stop.is_set():
                        done.wait(timeout=1.0)
                    if next_idx[0] >= n or stop.is_set():
                        return
                    i = next_idx[0]
                    next_idx[0] += 1
                try:
                    item = self.preprocess(self.dir.load_rgb(i))
                except Exception as e:  # a decode failure: delivered, raised in order
                    item = e
                with done:
                    results[i] = item
                    done.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for start in range(0, n, self.batch_size):
                idxs = list(range(start, min(start + self.batch_size, n)))
                items = []
                for i in idxs:
                    with done:
                        while i not in results:
                            done.wait(timeout=60.0)
                        item = results.pop(i)
                        done.notify_all()  # wake workers waiting on the backlog
                    if isinstance(item, Exception):
                        raise RuntimeError(f"failed to load {self.dir.filenames[i]}") from item
                    items.append(item)
                valid = np.ones(self.batch_size, dtype=bool)
                valid[len(items):] = False
                items += [items[-1]] * (self.batch_size - len(items))
                yield [self.dir.filenames[i] for i in idxs], np.stack(items), valid
        finally:
            stop.set()
            with done:
                done.notify_all()
