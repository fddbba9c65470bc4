"""StandardAutoscaler: reconcile resource demand against the node fleet.

ray: python/ray/autoscaler/_private/autoscaler.py:168 (StandardAutoscaler,
update :366) + resource_demand_scheduler.py:103 (bin-packing demand into
node types) + load_metrics.py.  Demand comes straight from the runtime:
queued task resource shapes + pending placement-group bundles; supply is
the alive node table.  update() launches the cheapest node-type mix that
fits the unmet demand (first-fit-decreasing) and terminates nodes idle
longer than idle_timeout_s, within [min_workers, max_workers].
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


@dataclass
class NodeTypeConfig:
    """One launchable machine shape (ray: available_node_types entries)."""

    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    idle_timeout_s: float = 60.0
    max_launch_batch: int = 8
    # A launched node that never joins the runtime within this window is
    # terminated (boot failure) — and until then its capacity counts as
    # in-flight so repeated update() passes don't re-launch for the same
    # demand (slow cloud boots would otherwise launch max_workers VMs).
    boot_timeout_s: float = 600.0


def _fits(have: Dict[str, float], need: Dict[str, float]) -> bool:
    return all(have.get(k, 0.0) >= v - 1e-9 for k, v in need.items())


def _sub(have: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        have[k] = have.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        config: AutoscalerConfig,
    ):
        self.provider = provider
        self.config = config
        self._idle_since: Dict[str, float] = {}  # provider node id -> ts
        self._launching: Dict[str, Tuple[str, float]] = {}  # pid -> (type, ts)
        self._warned_infeasible: set = set()
        # With an autoscaler attached, infeasible tasks park instead of
        # erroring — the fleet can grow to fit them (ray's default).
        from ray_tpu_torch._private.runtime import get_runtime

        get_runtime().allow_pending_infeasible = True

    # -- demand/supply views ----------------------------------------------
    def _pending_demand(self) -> List[Dict[str, float]]:
        """Unschedulable resource shapes: queued tasks + pending PG bundles
        (ray: load_metrics.py pending_resource_demands)."""
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        demand: List[Dict[str, float]] = []
        with rt.lock:
            for tid in rt.ready_queue:
                rec = rt.tasks.get(tid)
                if rec is not None:
                    demand.append(dict(rec.spec.resources))
            for pg_id in rt.pending_pgs:
                pg = rt.state.placement_groups.get(pg_id)
                if pg is not None and pg.state == "PENDING":
                    demand.extend(dict(b) for b in pg.bundles)
        return demand

    def _free_capacity(self) -> List[Tuple[Optional[str], Dict[str, float]]]:
        """(runtime_node_id, available) per alive node, plus the full shape
        of every still-booting launch (in-flight supply)."""
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        out: List[Tuple[Optional[str], Dict[str, float]]] = [
            (n.node_id, dict(n.available)) for n in rt.state.alive_nodes()
        ]
        for pid, (tname, _ts) in self._launching.items():
            tcfg = self.config.node_types.get(tname)
            if tcfg is not None:
                out.append((None, dict(tcfg.resources)))
        return out

    def _refresh_launching(self) -> None:
        """Drop joined launches; boot-timeout stragglers are terminated."""
        now = time.monotonic()
        for pid in list(self._launching):
            tname, ts = self._launching[pid]
            if pid not in set(self.provider.non_terminated_nodes()):
                self._launching.pop(pid, None)
                continue
            if self.provider.runtime_node_id(pid) is not None:
                self._launching.pop(pid, None)
            elif now - ts > self.config.boot_timeout_s:
                # Never joined: reclaim the machine instead of leaking it.
                self.provider.terminate_node(pid)
                self._launching.pop(pid, None)

    def _nodes_by_type(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for pid in self.provider.non_terminated_nodes():
            out.setdefault(self.provider.node_type(pid), []).append(pid)
        return out

    # -- reconciliation ----------------------------------------------------
    def _launch(self, tname: str, tcfg: NodeTypeConfig, launched: Dict[str, int]):
        pid = self.provider.create_node(tname, tcfg.resources)
        self._launching[pid] = (tname, time.monotonic())
        launched[tname] = launched.get(tname, 0) + 1
        return pid

    def update(self) -> Dict[str, Any]:
        """One reconcile pass; returns {launched: {type: n},
        terminated: [id], infeasible: [shape]}."""
        launched: Dict[str, int] = {}
        infeasible: List[Dict[str, float]] = []
        self._refresh_launching()
        by_type = self._nodes_by_type()

        # 1. min_workers floors.
        for tname, tcfg in self.config.node_types.items():
            have = len(by_type.get(tname, []))
            for _ in range(max(0, tcfg.min_workers - have)):
                pid = self._launch(tname, tcfg, launched)
                by_type.setdefault(tname, []).append(pid)

        # 2. Unmet demand -> launches (first-fit-decreasing over free
        #    capacity incl. in-flight boots, then bin-pack the remainder
        #    into node types; ray: resource_demand_scheduler :103).
        free = self._free_capacity()
        reserved_nodes: set = set()  # runtime nodes absorbing queued demand
        unmet: List[Dict[str, float]] = []
        for shape in sorted(
            self._pending_demand(), key=lambda s: -sum(s.values())
        ):
            placed = False
            for nid, cap in free:
                if _fits(cap, shape):
                    _sub(cap, shape)
                    if nid is not None:
                        reserved_nodes.add(nid)
                    placed = True
                    break
            if not placed:
                unmet.append(shape)
        n_new = 0
        while unmet and n_new < self.config.max_launch_batch:
            shape = unmet[0]
            chosen: Optional[Tuple[str, NodeTypeConfig]] = None
            for tname, tcfg in sorted(
                self.config.node_types.items(),
                key=lambda kv: sum(kv[1].resources.values()),
            ):
                if len(by_type.get(tname, [])) >= tcfg.max_workers:
                    continue
                if _fits(tcfg.resources, shape):
                    chosen = (tname, tcfg)
                    break
            if chosen is None:
                unmet.pop(0)
                infeasible.append(shape)
                key = tuple(sorted(shape.items()))
                if key not in self._warned_infeasible:
                    self._warned_infeasible.add(key)
                    import warnings

                    warnings.warn(
                        f"autoscaler: demand {shape} fits NO configured node "
                        f"type (or all types at max_workers); the task will "
                        f"stay pending forever unless the config changes"
                    )
                continue
            tname, tcfg = chosen
            pid = self._launch(tname, tcfg, launched)
            by_type.setdefault(tname, []).append(pid)
            n_new += 1
            # the new node absorbs every unmet shape it fits
            cap = dict(tcfg.resources)
            unmet = [s for s in unmet if not (_fits(cap, s) and (_sub(cap, s) or True))]

        # 3. Idle terminations (above min_workers; nodes that just absorbed
        #    queued demand in step 2 are NOT idle).
        terminated = self._terminate_idle(by_type, reserved_nodes)
        return {
            "launched": launched,
            "terminated": terminated,
            "infeasible": infeasible,
        }

    def _terminate_idle(
        self, by_type: Dict[str, List[str]], reserved_nodes: set
    ) -> List[str]:
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        now = time.monotonic()
        out: List[str] = []
        for tname, pids in by_type.items():
            tcfg = self.config.node_types.get(tname)
            if tcfg is None:
                continue
            killable = len(pids) - tcfg.min_workers
            for pid in pids:
                if killable <= 0:
                    break
                if pid in self._launching:
                    continue  # still booting (boot timeout reclaims these)
                nid = self.provider.runtime_node_id(pid)
                node = rt.state.nodes.get(nid) if nid else None
                # node is None here means an orphan (not booting — those are
                # skipped above — but never joined, e.g. tracker restart):
                # NOT busy, so the idle clock reclaims it.
                busy = nid in reserved_nodes or (
                    node is not None
                    and any(
                        node.available.get(k, 0.0)
                        < node.resources.get(k, 0.0) - 1e-9
                        for k in node.resources
                    )
                )
                if busy:
                    self._idle_since.pop(pid, None)
                    continue
                since = self._idle_since.setdefault(pid, now)
                if now - since >= self.config.idle_timeout_s:
                    self.provider.terminate_node(pid)
                    self._idle_since.pop(pid, None)
                    out.append(pid)
                    killable -= 1
        return out
