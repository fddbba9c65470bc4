"""NodeProvider: the cloud-plugin seam of the autoscaler.

ray: python/ray/autoscaler/node_provider.py:13 (NodeProvider ABC) +
_private/fake_multi_node/node_provider.py:237 (FakeMultiNodeProvider).
Providers own machine lifecycle; the autoscaler decides HOW MANY of each
node type, the provider makes it so.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Subclass per cloud.  node_type -> resource shape comes from the
    autoscaler config's available_node_types table."""

    def __init__(self, provider_config: Optional[Dict[str, Any]] = None):
        self.provider_config = dict(provider_config or {})

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        raise NotImplementedError

    def node_type(self, provider_node_id: str) -> str:
        raise NotImplementedError

    def create_node(self, node_type: str, resources: Dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def runtime_node_id(self, provider_node_id: str) -> Optional[str]:
        """The ray_tpu_torch cluster node id this machine registered as (None
        while still booting/joining)."""
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """Test/dev provider: "machines" are in-process virtual nodes (or real
    node-daemon processes with daemon=True) of the current runtime — the
    analogue of FakeMultiNodeProvider, which starts extra raylets."""

    def __init__(self, provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config)
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.use_daemons = bool(self.provider_config.get("use_daemons", False))

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes.keys())

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        return dict(self._nodes[provider_node_id]["resources"])

    def node_type(self, provider_node_id: str) -> str:
        return self._nodes[provider_node_id]["type"]

    def create_node(self, node_type: str, resources: Dict[str, float]) -> str:
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        res = dict(resources)
        cpus = res.pop("CPU", 1.0)
        if self.use_daemons:
            nid = rt.add_daemon_node(num_cpus=cpus, resources=res)
        else:
            nid = rt.add_node(num_cpus=cpus, resources=res)
        pid = f"local-{uuid.uuid4().hex[:8]}"
        with self._lock:
            self._nodes[pid] = {
                "type": node_type,
                "resources": dict(resources),
                "runtime_node_id": nid,
            }
        return pid

    def terminate_node(self, provider_node_id: str) -> None:
        from ray_tpu_torch._private.runtime import get_runtime

        with self._lock:
            info = self._nodes.pop(provider_node_id, None)
        if info is not None:
            get_runtime().remove_node(info["runtime_node_id"])

    def runtime_node_id(self, provider_node_id: str) -> Optional[str]:
        info = self._nodes.get(provider_node_id)
        return info["runtime_node_id"] if info else None


class TPUPodNodeProvider(NodeProvider):
    """GCP TPU-VM provider: node types are TPU slice shapes (e.g. v5p-8
    hosts) created via gcloud; each VM's startup script boots a node
    daemon pointed at the head, registering a PRE-ASSIGNED node id.

    The full lifecycle (create -> daemon joins -> TPU-shaped task
    schedules -> terminate) is exercised against a fake `gcloud`
    executable in tests/test_autoscaler_jobs.py — the real binary needs
    cloud credentials + egress, which CI doesn't have (the same
    fake-provider pattern as ray: autoscaler/_private/fake_multi_node).
    """

    def __init__(self, provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config)
        self.project = self.provider_config.get("project")
        self.zone = self.provider_config.get("zone")
        self._nodes: Dict[str, Dict[str, Any]] = {}

    def _gcloud(self, *args: str) -> str:
        import subprocess

        cmd = ["gcloud", "compute", "tpus", "tpu-vm", *args,
               f"--project={self.project}", f"--zone={self.zone}", "--format=json"]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"gcloud failed: {out.stderr[-500:]}")
        return out.stdout

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes.keys())

    def node_resources(self, provider_node_id: str) -> Dict[str, float]:
        return dict(self._nodes[provider_node_id]["resources"])

    def node_type(self, provider_node_id: str) -> str:
        return self._nodes[provider_node_id]["type"]

    def create_node(self, node_type: str, resources: Dict[str, float]) -> str:
        # node_type e.g. "v5p-8"; boots a TPU VM whose startup script runs
        # `python -m ray_tpu_torch._private.node_daemon` pointed at the head's
        # address, with a node_id PRE-ASSIGNED here — once the daemon
        # registers under it, runtime_node_id() flips from None (booting)
        # to the joined id, which is what the autoscaler's boot-timeout and
        # idle logic key on.
        name = f"raytpu-{node_type}-{uuid.uuid4().hex[:6]}"
        import json

        from ray_tpu_torch._private import ids as _ids
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        nid = _ids.node_id()
        _bind_host, port = rt.address
        # The driver's loopback bind address is useless to a remote VM: the
        # head host must come from provider config (and the driver must run
        # with RAY_TPU_BIND_HOST=0.0.0.0 or a routable interface).
        host = self.provider_config.get("head_host")
        if not host:
            raise ValueError(
                "TPUPodNodeProvider requires provider_config['head_host'] — "
                "a driver address the TPU VMs can route to"
            )
        if _bind_host in ("127.0.0.1", "localhost"):
            # Fail BEFORE billing a VM whose daemon can never connect.
            raise ValueError(
                "driver listener is bound to loopback; start the driver "
                "with RAY_TPU_BIND_HOST=0.0.0.0 (or a routable interface) "
                "so remote node daemons can reach it"
            )
        node_cfg = json.dumps(
            {
                "node_id": nid,
                "session": rt.session_name,
                "num_cpus": resources.get("CPU", 1),
                # full shape + labels: a TPU node registering CPU-only would
                # leave the TPU demand that triggered this launch infeasible
                "resources": {k: v for k, v in resources.items() if k != "CPU"},
                "labels": dict(self.provider_config.get("labels") or {}),
            }
        )
        # NOTE: a hardened deployment should deliver the authkey via a
        # secret manager rather than instance metadata.
        import shlex

        startup = (
            f"export RAY_TPU_DRIVER_HOST={shlex.quote(str(host))}; "
            f"export RAY_TPU_DRIVER_PORT={shlex.quote(str(port))}; "
            f"export RAY_TPU_AUTHKEY={shlex.quote(rt._authkey.hex())}; "
            f"export RAY_TPU_NODE_CONFIG={shlex.quote(node_cfg)}; "
            "python -m ray_tpu_torch._private.node_daemon"
        )
        self._gcloud(
            "create", name, f"--accelerator-type={node_type}",
            "--version=tpu-ubuntu2204-base",
            f"--metadata=startup-script={startup}",
        )
        self._nodes[name] = {
            "type": node_type,
            "resources": dict(resources),
            "runtime_node_id": nid,
        }
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        if provider_node_id in self._nodes:
            self._gcloud("delete", provider_node_id, "--quiet")
            self._nodes.pop(provider_node_id, None)

    def runtime_node_id(self, provider_node_id: str) -> Optional[str]:
        """None until the VM's daemon actually registers the node."""
        nid = self._nodes.get(provider_node_id, {}).get("runtime_node_id")
        if nid is None:
            return None
        from ray_tpu_torch._private.runtime import get_runtime

        return nid if nid in get_runtime().state.nodes else None
