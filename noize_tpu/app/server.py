"""TileServer — batched streaming tile generation for production serving.

The reference's MeshTileGenerator serves one tile per frame from its work
queue (MeshTileGenerator.cs:125-138).  Here a batch of B tiles runs as
ONE device program under the hybrid lowering (vmap field stages, lax.map
erosion — see parallel.tiled), which amortizes the per-dispatch overhead
over the batch.  The server collects requests into batches, runs each
batch to completion (the loop blocks on batch N before it collects batch
N+1, so host batching and device work do not overlap), and delivers
per-tile results through callbacks.

Single-process serving; scale out with parallel.device_mesh (shard the
batch axis) or parallel.distributed (independent tile sets per host).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core.tiles import TileRequest, TileSetMeta
from ..parallel import tiled as TL


@dataclass
class TileOrder:
    request: TileRequest
    on_complete: Optional[Callable] = None


@dataclass
class ServedTile:
    request: TileRequest
    heights: object          # f32[R, R] (device array); None when error set
    batch_id: int
    latency_ms: float
    error: object = None     # the batch exception, delivered per order
    mesh_planes: object = None  # f32[12, tr+1, tr+1] when config.emit_mesh


class TileServer:
    def __init__(
        self,
        config: TL.TilePipelineConfig,
        # the batch size is not yet chosen from a GPU measurement; scale
        # beyond one card with the dp mesh axis
        batch_size: int = 4,
        mesh=None,
        max_wait_ms: float = 5.0,
        seed: int = 0,
    ):
        self.config = config
        self.batch_size = batch_size
        self.mesh = mesh
        self.max_wait_ms = max_wait_ms
        self.seed = seed
        self.queue: "queue.Queue[TileOrder]" = queue.Queue()
        self.served: int = 0
        self.batches: int = 0
        self.errors: List[Exception] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- client surface ------------------------------------------------------

    def submit(self, tile_id: str, pos: Tuple[int, int],
               on_complete: Optional[Callable[[ServedTile], None]] = None):
        self.queue.put(TileOrder(TileRequest(uuid=tile_id, pos=pos), on_complete))

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def drain(self, timeout: float = 120.0) -> bool:
        """Wait until every submitted order has been fully processed.

        Uses the queue's unfinished-task count (orders are marked done only
        AFTER their batch completes and callbacks fire), so there is no
        window where a dequeued-but-unprocessed order looks drained.
        Returns False on timeout or if the worker thread has died."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.queue.unfinished_tasks == 0:
                return True
            if self._thread is not None and not self._thread.is_alive():
                return self.queue.unfinished_tasks == 0
            time.sleep(0.005)
        return False

    # --- batching loop --------------------------------------------------------

    def _collect_batch(self) -> List[TileOrder]:
        orders: List[TileOrder] = []
        try:
            orders.append(self.queue.get(timeout=0.05))
        except queue.Empty:
            return orders
        deadline = time.time() + self.max_wait_ms / 1e3
        while len(orders) < self.batch_size and time.time() < deadline:
            try:
                orders.append(self.queue.get_nowait())
            except queue.Empty:
                time.sleep(0.0005)
        return orders

    def _loop(self):
        import jax
        import logging

        log = logging.getLogger(__name__)
        while not self._stop.is_set():
            orders = self._collect_batch()
            if not orders:
                continue
            try:
                t0 = time.perf_counter()
                # pad the batch to the fixed compiled size with repeats
                reqs = [o.request for o in orders]
                origins = np.asarray(
                    [self.config.meta.tile_origin(r.pos) for r in reqs],
                    np.int32,
                )
                pad = self.batch_size - len(origins)
                if pad > 0:
                    origins = np.concatenate(
                        [origins, np.repeat(origins[-1:], pad, 0)]
                    )
                # seed is the GLOBAL seed — per-tile randomness is derived
                # from world position inside tile_batch, so re-requested
                # tiles reproduce regardless of batch membership
                tiles = TL.tile_batch(
                    self.config, origins, mesh=self.mesh, seed=self.seed,
                )
                jax.block_until_ready(tiles)
                # emit_mesh configs return {"height", "mesh_planes"}
                if isinstance(tiles, dict):
                    heights_arr = tiles["height"]
                    planes_arr = tiles["mesh_planes"]
                else:
                    heights_arr, planes_arr = tiles, None
                dt = (time.perf_counter() - t0) * 1e3
                self.batches += 1
                for i, order in enumerate(orders):
                    self.served += 1
                    if order.on_complete is not None:
                        # one order's raising callback must not starve the
                        # rest of the batch of their results
                        try:
                            order.on_complete(ServedTile(
                                request=order.request,
                                heights=heights_arr[i],
                                batch_id=self.batches,
                                latency_ms=dt,
                                mesh_planes=(None if planes_arr is None
                                             else planes_arr[i]),
                            ))
                        except Exception as e:
                            self.errors.append(e)
                            log.exception(
                                "on_complete raised for tile %s",
                                order.request.pos)
            except Exception as e:
                self.errors.append(e)
                log.exception("TileServer batch failed (%d orders dropped)",
                              len(orders))
                # deliver the failure per order so waiters unblock instead
                # of deadlocking on a result that will never arrive
                for order in orders:
                    if order.on_complete is not None:
                        try:
                            order.on_complete(ServedTile(
                                request=order.request, heights=None,
                                batch_id=self.batches, latency_ms=0.0,
                                error=e,
                            ))
                        except Exception:
                            log.exception(
                                "on_complete raised for failed tile %s",
                                order.request.pos)
            finally:
                # mark every dequeued order done so drain() can't hang on
                # a failed batch
                for _ in orders:
                    self.queue.task_done()
