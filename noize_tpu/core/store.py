"""Pipeline state manager — global registry of named, typed, persistent
device buffers with locks, change callbacks and transparent checkpoint.

Reference: ``PipelineStateManager`` (/root/reference/Pipeline/PipelineState/
PipelineStateManager.cs:13-189), per-type buffer states
(PipelineState.cs:121-349), fence locks (PipelineStateLock.cs:12-39).

Device mapping (SURVEY.md L5): buffers are device-resident ``jax.Array``s (or any
host object for non-array containers: lists, dicts, python refs — the
reference's NativeList/Queue/HashMap family).  The reference's fence locks
exist because jobs mutate shared memory; here arrays are immutable, so a
"lock" is an ordering token used by the host driver: a buffer is locked
while a producing computation is in flight and unlocked when the producer
commits its output (the ``HandleLock.CheckFenceIsDependencyOrDidSyncFence``
analog is ``jax.Array``'s own readiness plus the token check).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from .serde import SerdeManager


class PipelineStateManager:
    def __init__(self, save_dir: Optional[str] = None,
                 save_name: str = "default", version: str = "0"):
        self._buffers: Dict[str, Any] = {}
        self._locks: Dict[str, Any] = {}
        self._callbacks: Dict[str, list] = {}
        self._mutex = threading.RLock()
        self.serde: Optional[SerdeManager] = None
        if save_dir is not None:
            self.set_save_path(save_dir, save_name, version)

    # --- save path (PipelineStateManager.cs:18-20) -------------------------

    def set_save_path(self, save_dir: str, save_name: str = "default",
                      version: str = "0"):
        self.serde = SerdeManager(save_dir, save_name, version)

    # --- buffers (PipelineStateManager.cs:30-96) ---------------------------

    def get_buffer(self, name: str, default: Any = None,
                   factory: Optional[Callable[[], Any]] = None) -> Any:
        """Get-or-create.  On first access, transparently restores from the
        save directory if a checkpoint exists (PipelineStateManager.cs:63-71).
        ``factory`` builds the initial value; ``default`` is a shortcut for a
        constant initial value."""
        with self._mutex:
            if name in self._buffers:
                return self._buffers[name]
            if self.serde is not None and self.serde.exists(name):
                import jax.numpy as jnp

                restored = self.serde.load(name)
                value = jnp.asarray(restored)
            elif factory is not None:
                value = factory()
            else:
                value = default
            self._buffers[name] = value
            return value

    def set_buffer(self, name: str, value: Any):
        """Commit a new value; fires change callbacks
        (PipelineState.cs:294-318) and releases any lock held for the
        producing computation."""
        with self._mutex:
            self._buffers[name] = value
            cbs = list(self._callbacks.get(name, ()))
        for cb in cbs:
            cb(name, value)

    def buffer_exists(self, name: str) -> bool:
        with self._mutex:
            return name in self._buffers or (
                self.serde is not None and self.serde.exists(name)
            )

    def release_buffer(self, name: str):
        with self._mutex:
            self._buffers.pop(name, None)
            self._locks.pop(name, None)

    def names(self):
        with self._mutex:
            return sorted(self._buffers)

    # --- locks (PipelineStateLock.cs:12-39, PipelineState.cs:320-337) ------

    def try_set_lock(self, name: str, token: Any) -> bool:
        with self._mutex:
            if name in self._locks and self._locks[name] is not token:
                return False
            self._locks[name] = token
            return True

    def is_locked(self, name: str, token: Any = None) -> bool:
        """Locked unless the querying computation holds the token itself
        (fence-identity check parity)."""
        with self._mutex:
            held = self._locks.get(name)
            if held is None:
                return False
            return held is not token

    def unlock(self, name: str, token: Any = None) -> bool:
        with self._mutex:
            held = self._locks.get(name)
            if held is None:
                return True
            if token is None or held is token:
                del self._locks[name]
                return True
            return False

    # --- callbacks (PipelineState.cs:294-318) ------------------------------

    def register_callback(self, name: str, cb: Callable[[str, Any], None]):
        with self._mutex:
            self._callbacks.setdefault(name, []).append(cb)

    def remove_callback(self, name: str, cb) -> bool:
        with self._mutex:
            lst = self._callbacks.get(name, [])
            if cb in lst:
                lst.remove(cb)
                return True
            return False

    # --- checkpoint (PipelineStateManager.cs:98-113) -----------------------

    def save_buffer_to_disk(self, name: str, async_: bool = False) -> bool:
        if self.serde is None:
            return False
        with self._mutex:
            if name not in self._buffers:
                return False
            value = self._buffers[name]
        arr = np.asarray(value)
        self.serde.save(name, arr, async_=async_)
        return True

    def save_all(self, async_: bool = True) -> Dict[str, Exception]:
        """Checkpoint every array buffer; async by default (the native
        write pool overlaps disk IO with device compute), with a barrier
        at the end.

        Returns a ``{buffer_name: exception}`` map of failed writes (empty
        when the checkpoint is complete) so callers can detect a partial
        checkpoint; each failure is also logged."""
        failures: Dict[str, Exception] = {}
        skipped = []
        for name in self.names():
            with self._mutex:
                value = self._buffers.get(name)
            if value is None or isinstance(value, (dict, set)):
                continue  # non-array container (dicts/refs) — not saved
            if isinstance(value, (list, tuple)):
                # numeric sequences are checkpointed; only ragged/object
                # payloads are skipped.  Convert ONCE and hand the result
                # straight to serde — a probe-then-save would materialize
                # any device arrays in the sequence to host twice (the
                # no-probe rule below)
                try:
                    arr = np.asarray(value)
                except Exception:
                    skipped.append(name)
                    continue
                if arr.dtype == object:
                    skipped.append(name)
                    continue
                try:
                    self.serde.save(name, arr, async_=async_)
                except Exception as e:
                    failures[name] = e
                continue
            # no np.asarray probe for array buffers: it would materialize
            # every device array to host a second time, and a probe
            # failure must surface, not skip silently
            try:
                self.save_buffer_to_disk(name, async_=async_)
            except Exception as e:  # disk full, IO error, non-array buffer
                failures[name] = e
        if skipped:
            import logging

            logging.getLogger(__name__).info(
                "save_all: skipped %d non-numeric container buffer(s): %s",
                len(skipped), skipped,
            )
        if self.serde is not None and async_:
            try:
                self.serde.flush()
            except Exception as e:
                failures["<flush>"] = e
        if failures:
            import logging

            logging.getLogger(__name__).warning(
                "save_all: %d buffer(s) failed to checkpoint: %s",
                len(failures),
                {k: repr(v) for k, v in failures.items()},
            )
        return failures
