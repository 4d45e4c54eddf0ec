"""Per-shard multi-host checkpointing for spatially-sharded worlds.

The store's serializer (core.serde) materializes arrays to host via
``np.asarray``, which requires every shard to be addressable — true only
single-process.  On a multi-host mesh each process can address only its
own devices' blocks, so checkpointing a P('x','y') world there must
write per-process shard files.  This module does that on top of
core.serde's file format (native checksummed writer, files.json
manifest): each process writes its addressable blocks — deduped by
global index — under ``<root>/save__proc{k}_0/``, plus a
``{name}.meta.json`` sidecar recording the global shape/dtype/blocks.

Restore assumes the same process/mesh topology as the save (each process
reads back exactly the blocks it owns under the target sharding) — the
fixed-topology contract multi-host restarts satisfy.  Neither save nor restore
moves bytes across hosts.

Reference: PipelineSerialization.cs:15-236 is the single-machine raw
dump subsystem this scales out; the reference has no multi-host analog
(SURVEY.md §2.7: its "communication backend" is shared memory).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..core.serde import SerdeManager


def _shard_key(name: str, index, shape) -> str:
    """Stable buffer-entry key for one global block: the block's concrete
    [start, stop) span per dimension (slice Nones normalized)."""
    spans = []
    for d, sl in enumerate(index):
        start = 0 if sl.start is None else int(sl.start)
        stop = shape[d] if sl.stop is None else int(sl.stop)
        spans.append(f"{start}-{stop}")
    return f"{name}__shard__{'_'.join(spans)}"


class ShardedCheckpoint:
    """Per-process shard writer/reader rooted at a shared save directory
    (typically ``PipelineStateManager.serde.root`` so sharded checkpoints
    live next to the store's single-process ones)."""

    def __init__(self, root: str, process_index: Optional[int] = None):
        import jax

        pid = jax.process_index() if process_index is None else process_index
        self.root = root
        self.serde = SerdeManager(root, f"proc{pid}", "0")

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.serde.root,
                            f"{name.replace('/', '_')}.meta.json")

    def save(self, name: str, arr, async_: bool = False):
        """Write this process's addressable blocks of a (possibly
        partially-replicated) global array.  Replicated blocks are deduped
        within the process but written by every process that holds one, so
        each process can restore purely from its own files."""
        shape = arr.shape
        seen = set()
        blocks = []
        for s in arr.addressable_shards:
            key = _shard_key(name, s.index, shape)
            if key in seen:
                continue
            seen.add(key)
            blocks.append(key)
            self.serde.save(key, np.asarray(s.data), async_=async_)
        meta = {"shape": list(shape), "dtype": str(arr.dtype),
                "blocks": blocks}
        with open(self._meta_path(name), "w") as fh:
            json.dump(meta, fh)

    def exists(self, name: str) -> bool:
        if not os.path.exists(self._meta_path(name)):
            return False
        with open(self._meta_path(name)) as fh:
            meta = json.load(fh)
        return all(self.serde.exists(k) for k in meta["blocks"])

    def flush(self):
        """Barrier for async native-pool writes."""
        self.serde.flush()

    def load(self, name: str, sharding):
        """Rebuild the global array under ``sharding`` from this process's
        shard files (topology must match the save); None if absent."""
        import jax

        if not os.path.exists(self._meta_path(name)):
            return None
        with open(self._meta_path(name)) as fh:
            meta = json.load(fh)
        shape = tuple(meta["shape"])
        arrays = []
        for dev, idx in sharding.addressable_devices_indices_map(
                shape).items():
            block = self.serde.load(_shard_key(name, idx, shape))
            if block is None:
                raise IOError(
                    f"checkpoint {name!r} lacks block {idx} for {dev} — "
                    "restore topology must match the save (same process "
                    "count and mesh layout)")
            arrays.append(jax.device_put(block, dev))
        return jax.make_array_from_single_device_arrays(
            shape, sharding, arrays)
