"""The system under test: clann_tpu_torch, driven through its public
entries only. A configuration's ``build`` names how the index is made
(``facade``: ``init_with_config`` -> ``Clann.build`` on one card;
``sharded``: ``parallel.sharded.build_sharded`` over a mesh of the cell's
cards) and a traffic's ``mode`` which search the window calls."""

from __future__ import annotations

import gc
import time
from typing import List, Optional

import numpy as np
import torch


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class System:
    def __init__(self, config: dict, traffic: dict, devices: List[torch.device]):
        from clann_tpu_torch import Config

        self.kind = config["build"]
        if self.kind not in ("facade", "sharded"):
            raise ValueError(f"unknown build {self.kind!r}")
        self.cfg = Config.from_dict({**config["index"], "k": int(config["k"])})
        self.mode = traffic["mode"]
        self.delta: Optional[float] = traffic.get("delta")
        self.devices = devices
        self.handle = self.index = self.mesh = None

    def build(self, train: np.ndarray) -> float:
        """Build the index; seconds on the host clock, every card synchronized."""
        sync(self.devices)
        t0 = time.perf_counter()
        if self.kind == "facade":
            from clann_tpu_torch import init_with_config

            self.handle = init_with_config(train, self.cfg, device=self.devices[0])
            self.handle.build()
        else:
            from clann_tpu_torch.parallel.mesh import make_mesh
            from clann_tpu_torch.parallel.sharded import build_sharded

            self.mesh = make_mesh(len(self.devices), devices=self.devices)
            self.index = build_sharded(train, self.cfg, mesh=self.mesh)
        sync(self.devices)
        return time.perf_counter() - t0

    def search(self, queries: np.ndarray):
        """(distances, ids, stats) as the entry returns them, on the host."""
        if self.kind == "facade":
            return self.handle.search_batch(queries, mode=self.mode, delta=self.delta)
        from clann_tpu_torch.parallel import sharded as sh

        if self.mode == "lsh":
            return sh.sharded_global_search(self.index, queries, delta=self.delta,
                                            mesh=self.mesh)
        raise ValueError(f"no sharded entry for mode {self.mode!r}")

    @staticmethod
    def distance_computations(stats) -> Optional[np.ndarray]:
        dc = getattr(stats, "distance_computations", None)
        return None if dc is None else np.asarray(dc)

    def close(self) -> None:
        self.handle = self.index = self.mesh = None
        gc.collect()
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
