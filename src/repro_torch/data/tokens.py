"""Out-of-core token data pipeline (Helios applied to the LM input stream).

Token shards live on the storage tier; the iterator prefetches through the
async IO stack with a host-side shuffle buffer (inter-batch pipeline), so
device steps never wait on storage.  Iterator state (shard cursor + rng) is
checkpointable for exact resume.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from repro_torch.core.iostack import AsyncIOEngine, FeatureStore


class TokenStore(FeatureStore):
    """Sequences as rows: (n_sequences, seq_len+1) int32."""

    def __init__(self, path: str, n_sequences: int, seq_len: int,
                 vocab: int = 32000, n_shards: int = 4, create: bool = False,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        super().__init__(path, n_sequences, seq_len + 1, dtype=np.int32,
                         n_shards=n_shards, create=False)
        if create:
            rng = np.random.default_rng(seed)
            for s, mm in enumerate(self.shards):
                arr = np.lib.format.open_memmap(
                    os.path.join(path, f"shard_{s}.bin"), mode="r+")
                # Zipf-ish token stream so embedding hotness is skewed
                z = rng.zipf(1.3, size=arr.shape) % vocab
                arr[:] = z.astype(np.int32)
                arr.flush()
            self.shards = [np.lib.format.open_memmap(
                os.path.join(path, f"shard_{s}.bin"), mode="r")
                for s in range(n_shards)]


@dataclass
class IteratorState:
    epoch: int = 0
    cursor: int = 0
    seed: int = 0


class OutOfCoreTokenIterator:
    """Prefetching batch iterator over a TokenStore."""

    def __init__(self, store: TokenStore, batch_size: int,
                 n_microbatches: int = 1, prefetch: int = 2,
                 state: IteratorState | None = None):
        self.store = store
        self.batch = batch_size
        self.n_mb = n_microbatches
        self.prefetch = prefetch
        self.state = state or IteratorState()
        self.io = AsyncIOEngine(store)
        self._order = None
        self._tickets = []
        self._reshuffle()
        for _ in range(prefetch):
            self._submit_next()

    def _reshuffle(self):
        rng = np.random.default_rng(self.state.seed + self.state.epoch)
        self._order = rng.permutation(self.store.n_rows)

    def _submit_next(self):
        st = self.state
        if st.cursor + self.batch > len(self._order):
            st.epoch += 1
            st.cursor = 0
            self._reshuffle()
        ids = self._order[st.cursor:st.cursor + self.batch]
        st.cursor += self.batch
        self._tickets.append(self.io.submit(np.asarray(ids)))

    def __next__(self):
        self._submit_next()
        ticket = self._tickets.pop(0)
        rows, _ = ticket.wait()
        rows = rows.reshape(self.n_mb, self.batch // self.n_mb, -1)
        return {"tokens": rows[:, :, :-1], "labels": rows[:, :, 1:]}

    def __iter__(self):
        return self

    def checkpoint_state(self) -> dict:
        return {"epoch": self.state.epoch, "cursor": self.state.cursor,
                "seed": self.state.seed}

    @classmethod
    def restore_state(cls, d: dict) -> IteratorState:
        return IteratorState(**d)
