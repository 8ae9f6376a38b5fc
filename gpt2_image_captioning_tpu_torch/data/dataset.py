"""Training batches — the counterpart of ``Batcher`` in
``gpt2_image_captioning_tpu/data/dataset.py``, in plain numpy.

``CocoDataset`` (tokenizer, annotations, embeddings) is not ported yet
(ROADMAP.md, queue 1): the batcher takes any dataset with ``__len__`` and
``gather_batch(indices) → dict of arrays``, which is all the JAX
``Batcher`` uses of it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX


class Batcher:
    """Shuffled fixed-shape training batches with pad-and-mask semantics.

    Every epoch covers all captions exactly once; the permutation is a pure
    function of (seed, epoch), so a resumed run replays the same order.  The
    final partial batch is padded to ``batch_size`` by repeating its last
    index, and the padded rows get -100 labels, so they add nothing to the
    loss.  One process; the JAX package's per-process sharding waits for the
    parallelism item of ROADMAP.md.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._next_epoch = 0

    @property
    def steps_per_epoch(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def epoch(self, epoch_idx: int | None = None) -> Iterator[dict[str, np.ndarray]]:
        if epoch_idx is None:
            epoch_idx = self._next_epoch
            self._next_epoch += 1
        perm = np.random.default_rng([self.seed, epoch_idx]).permutation(len(self.ds))
        bs = self.batch_size
        for start in range(0, len(perm), bs):
            idx = perm[start : start + bs]
            n_real = len(idx)
            if n_real < bs:
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_real)])
            batch = self.ds.gather_batch(idx)
            if n_real < bs:
                batch["labels"] = batch["labels"].copy()
                batch["labels"][n_real:] = IGNORE_INDEX
            yield batch
