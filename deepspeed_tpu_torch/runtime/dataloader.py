"""Data loading (counterpart of deepspeed_tpu/runtime/dataloader.py):
``DeepSpeedDataLoader`` batches host examples into the
[gas, micro_global, ...] stacks ``engine.train_batch`` takes, and
``RepeatingLoader`` restarts an exhausted loader.  Host numpy code; the
engine moves each batch to its device."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


class RepeatingLoader:
    """Wrap an iterable to restart on StopIteration (an endless stream)."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batches host data and yields microbatch stacks shaped for
    ``engine.train_batch`` ([gas, micro_global, ...]).

    dataset: any iterable of per-example trees of numpy arrays.
    """

    def __init__(self, dataset, micro_batch_size_per_gpu: int,
                 gradient_accumulation_steps: int, dp_world_size: int,
                 collate_fn: Optional[Callable] = None, drop_last: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.micro = micro_batch_size_per_gpu
        self.gas = gradient_accumulation_steps
        self.dp_world = dp_world_size
        self.global_batch = self.micro * self.gas * self.dp_world
        self.collate_fn = collate_fn or _default_collate
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[Any]:
        buf = []
        for ex in self.dataset:
            buf.append(ex)
            if len(buf) == self.global_batch:
                yield self._form_batch(buf)
                buf = []
        if buf and not self.drop_last:
            # the trailing partial batch is padded by cycling its own
            # examples (duplicates!) rather than yielded ragged
            logger.warning(
                "padding trailing partial batch of %d to %d by repeating "
                "examples (drop_last=False)", len(buf), self.global_batch)
            i = 0
            while len(buf) < self.global_batch:
                buf.append(buf[i % len(buf)])
                i += 1
            yield self._form_batch(buf)

    def _form_batch(self, examples):
        batch = self.collate_fn(examples)
        micro_global = self.micro * self.dp_world

        def r(x):
            x = np.asarray(x)
            return x.reshape((self.gas, micro_global) + x.shape[1:])
        return tree_map(r, batch)

    def __len__(self):
        try:
            return len(self.dataset) // self.global_batch
        except TypeError:
            raise TypeError("underlying dataset has no __len__")


def _default_collate(examples):
    """Stack a list of example trees into a batch tree."""
    return tree_map(lambda *xs: np.stack(xs), examples[0], *examples[1:])
