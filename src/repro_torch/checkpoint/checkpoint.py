"""Async multi-tier checkpointing with atomic manifests + elastic restore.

Designed for 1000+ node runs:
  * async: the train loop hands the state off to a background writer (device
    -> host snapshot is synchronous and cheap; host -> storage is
    overlapped with subsequent steps, Helios-style tiering);
  * atomic: arrays are written to a staging dir, then a manifest JSON is
    renamed into place — a crash mid-write never corrupts the latest
    checkpoint;
  * elastic: arrays are saved DEVICE-LAYOUT-FREE (full logical value +
    the logical spec names), so restore can place them on any device;
  * keep-k GC + data-iterator state included for exact resume;
  * sharded embedding tables: ``save_embeddings``/``restore_embeddings``
    stream a terabyte-class trainable-embedding ``FeatureStore`` shard by
    shard THROUGH the IO engine's ``submit_write`` path (chunked, striped,
    range-coalesced) instead of materializing one monolithic host array —
    the write-path mirror of the gather stack, with per-shard checksums in
    the manifest.

PyTorch port of ``repro.checkpoint.checkpoint``.  ``save`` snapshots a
tree of tensors (any device) to host numpy; ``restore(device=...)`` puts
the arrays back as tensors on ``device``.  The on-disk format is the
reference's, so a state saved by either package restores in the other to
identical arrays; bfloat16 arrays are stored as their 16-bit patterns
with the dtype named in the manifest, as the reference stores them.  The
embedding half is numpy over the IO stack and unchanged.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def _to_host(tree):
    """A state as host arrays that no later update of the state can
    change, in the same dict/list structure; a bfloat16 tensor stays a
    CPU tensor (numpy has no bfloat16; ``_write`` stores its bits)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        a = tree.detach().to("cpu", copy=True)
        return a if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, state, extra: dict | None = None):
        """Snapshot to host, then write asynchronously."""
        host_state = _to_host(state)
        self.wait()                       # one in-flight write at a time

        def write():
            try:
                self._write(step, host_state, extra or {})
            except Exception as e:        # pragma: no cover
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def _write(self, step: int, host_state, extra: dict):
        stage = os.path.join(self.dir, f".stage_{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        flat = _flatten(host_state)
        names = {}
        for i, (key, arr) in enumerate(flat.items()):
            fn = f"arr_{i}.npy"
            entry = {"file": fn}
            if isinstance(arr, torch.Tensor):       # bfloat16
                entry["dtype"] = "bfloat16"
                arr = arr.view(torch.int16).numpy().view(np.uint16)
            arr = np.asarray(arr)
            if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
                # numpy can't round-trip ml_dtypes: store bit pattern
                entry["dtype"] = str(arr.dtype)
                arr = arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
            np.save(os.path.join(stage, fn), arr)
            names[key] = entry
        manifest = {"step": step, "arrays": names, "extra": extra,
                    "time": time.time()}
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(stage, final)          # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None):
        """Load a checkpoint.  With ``device`` every array comes back as a
        tensor there; without, as host numpy (a bfloat16 array as a CPU
        tensor, since numpy has no bfloat16)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load_one(entry):
            if isinstance(entry, str):            # legacy manifests
                entry = {"file": entry}
            arr = np.load(os.path.join(d, entry["file"]))
            if "dtype" in entry:
                if entry["dtype"] != "bfloat16":
                    raise ValueError(f"unsupported stored dtype "
                                     f"{entry['dtype']!r}")
                return torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            return arr

        flat = {k: load_one(e) for k, e in manifest["arrays"].items()}
        if device is not None:
            dev = resolve_device(device)
            flat = {k: torch.as_tensor(v).to(dev) for k, v in flat.items()}
        state = _unflatten(flat)
        return state, manifest["extra"] | {"step": manifest["step"]}

    # ------------------------------------------------------------------
    # sharded embedding-table checkpoints (streamed through submit_write)
    # ------------------------------------------------------------------
    _EMB_INFLIGHT = 2                   # write tickets kept in flight

    def _inflight_cap(self, eng) -> int:
        """Checkpoint admission honors engine back-pressure: while the
        engine's demand-qwait watermark is engaged
        (``throttled(CHECKPOINT)`` — docs/streams.md), the in-flight
        window shrinks to one ticket so checkpoint traffic trickles
        instead of stacking the shard queues under a demand burst."""
        from repro_torch.core.iostack import StreamClass
        thr = getattr(eng, "throttled", None)
        if thr is not None and thr(StreamClass.CHECKPOINT):
            return 1
        return self._EMB_INFLIGHT

    @staticmethod
    def _file_crc(path: str) -> int:
        crc = 0
        with open(path, "rb") as fh:
            while True:
                block = fh.read(1 << 20)
                if not block:
                    return crc
                crc = zlib.crc32(block, crc)

    def _stream_rows(self, src, dst_engine, chunk_rows: int) -> float:
        """Copy every row of ``src`` into ``dst_engine``'s store through
        chunked ``submit_write`` tickets, a bounded window of them in
        flight — terabyte tables never materialize on the host.  The
        window refills on a ``CompletionQueue`` in COMPLETION order:
        whichever in-flight ticket finishes first frees a slot, so one
        chunk landing on a slow shard never stalls the stream the way a
        FIFO head-of-line wait would.  Returns the summed virtual write
        seconds."""
        from repro_torch.core.iostack import CompletionQueue
        virt, cq = 0.0, CompletionQueue()
        for lo in range(0, src.n_rows, chunk_rows):
            ids = np.arange(lo, min(src.n_rows, lo + chunk_rows))
            dst_engine.submit_write(ids, src.read_rows(ids), tag="ckpt",
                                    cq=cq)
            while cq.pending >= self._inflight_cap(dst_engine):
                virt += cq.pop().wait()[1]      # first-done, not FIFO head
        for tk in cq.drain():
            virt += tk.wait()[1]
        return virt

    def _shard_version_fp(self, versions: np.ndarray,
                          n_shards: int) -> dict:
        """Per-shard fingerprint of the write-version counters: shard ``s``
        holds rows ``s::n_shards`` (round-robin stripe), so its fingerprint
        is the CRC of exactly those rows' versions.  Any write bumps its
        row's version, which moves the owning shard's fingerprint."""
        return {str(s): zlib.crc32(
                    np.ascontiguousarray(versions[s::n_shards],
                                         np.int64).tobytes())
                for s in range(n_shards)}

    def _stream_one_shard(self, store, eng, shard: int, n_shards: int,
                          chunk_rows: int) -> float:
        """Stream only shard ``shard``'s rows (``shard::n_shards``) through
        chunked ``submit_write`` tickets — the delta path copies changed
        shards and nothing else."""
        from repro_torch.core.iostack import CompletionQueue
        virt, cq = 0.0, CompletionQueue()
        gids = np.arange(shard, store.n_rows, n_shards)
        for lo in range(0, len(gids), chunk_rows):
            ids = gids[lo:lo + chunk_rows]
            eng.submit_write(ids, store.read_rows(ids), tag="ckpt", cq=cq)
            while cq.pending >= self._inflight_cap(eng):
                virt += cq.pop().wait()[1]
        for tk in cq.drain():
            virt += tk.wait()[1]
        return virt

    def save_embeddings(self, step: int, store, chunk_rows: int = 65536,
                        extra: dict | None = None, striped: bool = True,
                        coalesce_gap=8, versions: np.ndarray | None = None,
                        base_step: int | None = None,
                        skip_shards=None) -> dict:
        """Checkpoint a (flushed) embedding ``FeatureStore`` as a sharded
        table: rows stream in chunks through a striped ``submit_write``
        engine into a stage-dir FeatureStore with identical geometry, the
        manifest records per-shard CRCs, and the atomic rename publishes.
        Call ``cache.flush()`` first so storage is authoritative.

        INCREMENTAL/DELTA mode: pass ``versions`` (the per-row write
        version counters, e.g. ``cache.mut._versions`` via
        ``MutableTierTable.versions``) and only shards whose version
        fingerprint MOVED since the base checkpoint are written; unchanged
        shards' manifest entries point at the step that last wrote them
        (chains flatten — a delta of a delta references the original
        holder directly).  ``base_step`` picks the base (default: latest
        embedding checkpoint); a base without fingerprints forces a full
        save.

        DEGRADED-MODE DEFERRAL: ``skip_shards`` (e.g. the engine's
        ``degraded_shards()``) suspends checkpoint traffic to failing
        shards — a skipped shard the base already holds is referenced
        delta-style at its stale bytes and listed under
        ``shards_deferred`` in the manifest; a skipped shard with no
        base copy is still written (there is nothing to defer to)."""
        from repro_torch.core.iostack import AsyncIOEngine, FeatureStore
        stage = os.path.join(self.dir, f".stage_emb_{step}")
        final = os.path.join(self.dir, f"emb_{step:010d}")
        n_shards = store.n_shards
        fp = (self._shard_version_fp(np.asarray(versions), n_shards)
              if versions is not None else None)
        base = None
        if fp is not None:
            if base_step is None:
                base_step = self.latest_embedding_step()
            if base_step is not None:
                with open(os.path.join(self.dir, f"emb_{base_step:010d}",
                                       "manifest.json")) as f:
                    base = json.load(f)
                if "version_fp" not in base:
                    base = None         # pre-delta base: save everything
        changed = (list(range(n_shards)) if base is None else
                   [s for s in range(n_shards)
                    if fp[str(s)] != base["version_fp"].get(str(s))])
        deferred = []
        if skip_shards is not None and base is not None:
            skip = {int(s) for s in np.asarray(skip_shards).ravel()}
            deferred = sorted(s for s in changed
                              if s in skip and str(s) in base["shards"])
            changed = [s for s in changed if s not in deferred]
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        dest = FeatureStore(os.path.join(stage, "table"), store.n_rows,
                            store.row_dim, dtype=store.dtype,
                            n_shards=n_shards, create=True, writable=True)
        with AsyncIOEngine(dest, striped=striped,
                           coalesce_gap=coalesce_gap) as eng:
            if len(changed) == n_shards:
                virt = self._stream_rows(store, eng, chunk_rows)
            else:
                virt = sum(self._stream_one_shard(store, eng, s, n_shards,
                                                  chunk_rows)
                           for s in changed)
        dest.flush()
        del dest                        # release memmaps before unlinking
        shards = {}
        for s in range(n_shards):
            fn = f"shard_{s}.bin"
            if s in changed:
                shards[str(s)] = {
                    "step": step, "file": f"table/{fn}",
                    "crc32": self._file_crc(os.path.join(stage, "table",
                                                         fn))}
            else:
                # unchanged: reference the base's holder (chain-flattened —
                # the base entry already names the step that wrote it) and
                # drop the zero-filled local copy from the stage dir
                ent = dict(base["shards"][str(s)])
                ent.setdefault("step", base["step"])
                shards[str(s)] = ent
                os.remove(os.path.join(stage, "table", fn))
        manifest = {"step": step, "kind": "embedding",
                    "geometry": {"n_rows": store.n_rows,
                                 "row_dim": store.row_dim,
                                 "dtype": store.dtype.name,
                                 "n_shards": n_shards},
                    "shards": shards, "virtual_write_s": virt,
                    "shards_written": len(changed),
                    "shards_deferred": deferred,
                    "extra": extra or {}, "time": time.time()}
        if fp is not None:
            manifest["version_fp"] = fp
        if base is not None:
            manifest["delta_of"] = base["step"]
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(stage, final)        # atomic publish
        self._gc_embeddings()
        return manifest

    def _emb_shard_path(self, ent: dict | str, manifest: dict) -> str:
        """Resolve a shard entry to its file on disk: delta manifests point
        unchanged shards at the STEP that last wrote them."""
        if isinstance(ent, str):                    # legacy manifests
            ent = {"file": ent}
        holder = ent.get("step", manifest["step"])
        return os.path.join(self.dir, f"emb_{holder:010d}", ent["file"])

    def restore_embeddings(self, store, step: int | None = None,
                           chunk_rows: int = 65536, verify: bool = True,
                           striped: bool = True, coalesce_gap=8,
                           fallback: bool = True) -> dict:
        """Stream a sharded embedding checkpoint back into the LIVE
        (writable) ``store`` through ``submit_write``; per-shard CRCs are
        verified before a single row lands.  Delta manifests resolve each
        shard to the step that actually holds its bytes (mixed base+delta
        restore), so a chain of incremental checkpoints reconstructs the
        full table from exactly ``n_shards`` files.

        With ``fallback`` (default), a CORRUPT candidate — torn/bit-
        flipped shard bytes failing their CRC, a missing referenced file,
        an unparseable manifest — is skipped and the next-newest
        embedding step tried, walking the chain until one restores
        intact; the result reports ``restored_step`` and a ``skipped``
        list of what was passed over and why.  Geometry mismatches still
        raise: the caller brought the wrong store, no older checkpoint
        fixes that."""
        want = step if step is not None else self.latest_embedding_step()
        if want is None:
            raise FileNotFoundError("no embedding checkpoint found")
        candidates = [s for s in reversed(self.all_embedding_steps())
                      if s <= want]
        if not fallback:
            candidates = candidates[:1]
        if not candidates or candidates[0] != want:
            raise FileNotFoundError(f"embedding checkpoint {want} not found")
        skipped = []
        for cand in candidates:
            try:
                out = self._restore_embeddings_one(
                    store, cand, chunk_rows, verify, striped, coalesce_gap)
            except (IOError, OSError, KeyError,
                    json.JSONDecodeError) as e:
                skipped.append({"step": cand, "error": str(e)})
                continue
            return out | {"restored_step": cand, "skipped": skipped}
        raise IOError("no intact embedding checkpoint; skipped: "
                      + "; ".join(f"step {s['step']}: {s['error']}"
                                  for s in skipped))

    def _restore_embeddings_one(self, store, step: int, chunk_rows: int,
                                verify: bool, striped: bool,
                                coalesce_gap) -> dict:
        from repro_torch.core.iostack import AsyncIOEngine, CompletionQueue
        d = os.path.join(self.dir, f"emb_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        geo = manifest["geometry"]
        want = {"n_rows": store.n_rows, "row_dim": store.row_dim,
                "dtype": store.dtype.name, "n_shards": store.n_shards}
        if geo != want:
            raise ValueError(f"embedding checkpoint geometry {geo} != "
                             f"live store {want}")
        paths = {int(s): self._emb_shard_path(ent, manifest)
                 for s, ent in manifest["shards"].items()}
        if verify:
            for s, ent in manifest["shards"].items():
                if isinstance(ent, str):
                    ent = {"file": ent}
                crc = self._file_crc(paths[int(s)])
                if crc != ent["crc32"]:
                    raise IOError(f"embedding shard {s} corrupt: "
                                  f"crc {crc:#x} != {ent['crc32']:#x}")
        n_shards = geo["n_shards"]
        virt, cq = 0.0, CompletionQueue()
        with AsyncIOEngine(store, striped=striped,
                           coalesce_gap=coalesce_gap) as eng:
            for s in range(n_shards):
                rows = np.load(paths[s], mmap_mode="r")
                gids = np.arange(s, geo["n_rows"], n_shards)
                for lo in range(0, len(gids), chunk_rows):
                    eng.submit_write(gids[lo:lo + chunk_rows],
                                     np.asarray(rows[lo:lo + chunk_rows]),
                                     tag="ckpt", cq=cq)
                    while cq.pending >= self._EMB_INFLIGHT:
                        virt += cq.pop().wait()[1]
            for tk in cq.drain():
                virt += tk.wait()[1]
        store.flush()
        return manifest | {"restore_virtual_write_s": virt}

    def all_embedding_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("emb_") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d[4:]))
        return sorted(out)

    def latest_embedding_step(self) -> int | None:
        steps = self.all_embedding_steps()
        return steps[-1] if steps else None

    def _gc_embeddings(self):
        """Keep the last ``keep`` embedding checkpoints PLUS any older step
        a surviving delta still references for shard bytes — collecting a
        base out from under its deltas would corrupt every restore chained
        through it."""
        steps = self.all_embedding_steps()
        survivors = set(steps[-self.keep:])
        referenced = set()
        for s in survivors:
            mf = os.path.join(self.dir, f"emb_{s:010d}", "manifest.json")
            with open(mf) as f:
                manifest = json.load(f)
            for ent in manifest["shards"].values():
                if isinstance(ent, dict):
                    referenced.add(ent.get("step", manifest["step"]))
        for s in steps:
            if s not in survivors and s not in referenced:
                shutil.rmtree(os.path.join(self.dir, f"emb_{s:010d}"),
                              ignore_errors=True)
