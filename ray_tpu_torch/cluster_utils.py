"""In-process multi-node cluster fixture (ray: python/ray/cluster_utils.py:99).

The reference tests distributed behavior by booting extra raylet+plasma
processes with fake node IDs on one machine. Here nodes are virtual entries in
the scheduler's node table; each node gets its own worker processes, so
scheduling policy, spillback, node failure and actor restart are all
exercised for real while the object plane stays host-local (multi-host object
transfer is a later-round subsystem).
"""

from __future__ import annotations

from typing import Dict, Optional


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: Optional[Dict] = None):
        import ray_tpu_torch
        from ray_tpu_torch._private.runtime import get_runtime

        self._nodes = []
        if initialize_head:
            ray_tpu_torch.init(**(head_node_args or {}))
        self._rt = get_runtime()
        self.head_node_id = self._rt.head_node_id

    def add_node(
        self,
        num_cpus: float = 1.0,
        resources: Optional[Dict] = None,
        labels: Optional[Dict[str, str]] = None,
        daemon: bool = False,
        store_root: Optional[str] = None,
    ) -> str:
        """labels: node metadata; "mesh_coord" (e.g. "0,1") marks the host's
        ICI torus coordinate, consumed by the MESH placement strategy.

        daemon=True starts a REAL node-daemon process owning the node's
        worker pool AND node object store (the reference's extra-raylet
        Cluster mode, ray: cluster_utils.py:99) — killing it is a node
        failure.  store_root places that node's isolated object-store
        directory (tests use distinct roots to prove no path sharing)."""
        if daemon:
            nid = self._rt.add_daemon_node(
                num_cpus=num_cpus, resources=resources, labels=labels,
                store_root=store_root,
            )
        else:
            nid = self._rt.add_node(
                num_cpus=num_cpus, resources=resources, labels=labels
            )
        self._nodes.append(nid)
        return nid

    def kill_node_daemon(self, node_id: str) -> None:
        """Hard-kill a daemon node's process (fault injection — the
        reference's NodeKillerActor pattern, test_utils.py:1347)."""
        proc = self._rt._daemon_procs.get(node_id)
        if proc is not None:
            proc.kill()

    def remove_node(self, node_id: str) -> None:
        self._rt.remove_node(node_id)
        if node_id in self._nodes:
            self._nodes.remove(node_id)

    def shutdown(self) -> None:
        import ray_tpu_torch

        ray_tpu_torch.shutdown()
