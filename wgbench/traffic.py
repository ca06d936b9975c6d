"""The traffic generator: one general reader of a mix's parameters
(``wgbench/workloads/<name>.json``) that turns them and ``--seed`` into
the batches a run feeds the port.

A mix names the split its centres come from, the batch size, whether each
pass over the split is a fresh permutation (``shuffle``) or the split in
order, and drops a short last batch (``drop_last``, the examples' loaders'
default). Pass ``e`` of a shuffled split is drawn from its own generator, so
any pass can be made again alone; the sampler's seed of batch ``i`` is the
run's sampler base plus ``i``, modulo 2^32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .inputs import derive, generator


class Traffic:
    def __init__(self, mix: Dict, seed: int, split_ids: torch.Tensor, labels: torch.Tensor):
        self.mix, self.seed = mix, int(seed)
        self.ids, self.labels = split_ids, labels
        self.batch = int(mix["batch"])
        n = split_ids.shape[0]
        self.per_pass = n // self.batch if mix.get("drop_last", True) else -(-n // self.batch)
        self.sampler_base = derive(self.seed, 0x5A3) & 0xFFFFFFFF

    def sampler_seed(self, i: int) -> int:
        return (self.sampler_base + int(i)) & 0xFFFFFFFF

    def sampler_seeds(self, first: int, count: int, device) -> torch.Tensor:
        return (self.sampler_base + first + torch.arange(count, dtype=torch.int64,
                                                          device=device)) & 0xFFFFFFFF

    def order(self, e: int) -> torch.Tensor:
        """Positions into the split of pass ``e``, ``[per_pass * batch]``."""
        n = self.ids.shape[0]
        dev = self.ids.device
        if self.mix.get("shuffle", False):
            pos = torch.randperm(n, generator=generator(self.seed, "traffic", dev, e), device=dev)
        else:
            pos = torch.arange(n, device=dev)
        need = self.per_pass * self.batch
        if need > n:  # the short last batch wraps to the split's start
            pos = torch.cat([pos, pos[: need - n]])
        return pos[:need]

    def epoch(self, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pass ``e`` as stacked batches: centres and labels ``[S, B]``."""
        c = self.ids[self.order(e)].view(self.per_pass, self.batch)
        return c, self.labels[c.long()]

    def batch_at(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch ``i`` of the run, passes one after another."""
        e, b = divmod(int(i), self.per_pass)
        pos = self.order(e)[b * self.batch:(b + 1) * self.batch] if self.mix.get("shuffle") \
            else (torch.arange(self.batch, device=self.ids.device) + b * self.batch)
        c = self.ids[pos]
        return c, self.labels[c.long()]
