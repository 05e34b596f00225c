"""Entry points of the port: the one-card kernel check and the dry run.

`entry()` returns K1's wrapper and example arguments; `dryrun_multichip`
drives the EC mesh and then a cluster over real TCP sockets: a mon, 16
OSD daemons and a librados client, each on its own socket, with a `tpu`
k=8 m=4 pool whose writes ride the device mesh (ICIFabric) and a read
that reconstructs after one shard's daemon dies.

The port's counterparts of `__graft_entry__.py:5-69` (`entry`,
`dryrun_multichip`) and `:71-183` (`_dryrun_cluster_over_fabric`).
Everything runs on the card unless the caller passes CPU devices
(`dryrun_multichip(8, devices=["cpu"] * 8)`); the default devices are
every card, or `["cuda:0"] * n` on one card.  `TcpCluster` is the boot
both the dry run and chip_smoke.py's phase 20 use: the reference's
pick-then-bind retry with teardown (`__graft_entry__.py:103-134`), with
cephx as an option.
"""
from __future__ import annotations

import errno
import time

import numpy as np
import torch

K, M = 8, 4
N_OSD = 16             # k+m=12 over exactly 12 hosts is CRUSH-pathological


def entry(device=None):
    """(fn, example_args): K1 on the flagship path, the GF(2^8) encode
    of k=8 m=4 (isa_rs_matrix(8, 4)[8:], row-packed tables) over a
    (4, 8, 512) uint8 batch.  `fn(*args)` launches K1 on a cuda batch
    and runs its plain version on a cpu one."""
    from . import device as _device
    from .ec import gf
    from .ec.kernels import bitmatmul as bm

    dev = _device.resolve(device)
    mat = np.ascontiguousarray(gf.isa_rs_matrix(K, M)[K:])
    tables = _device.as_u8(bm.packed_nibble_tables(mat), dev)
    data = torch.zeros((4, K, 512), dtype=torch.uint8, device=dev)
    return bm.gf_matmul, (tables, _device.as_u8(mat, dev), data)


def default_devices(n_devices: int) -> list[torch.device]:
    """Every card when there are n of them, else n positions on the
    first card (the one-card mesh)."""
    from .dist.mesh_ec import cuda_devices
    devs = cuda_devices()
    return devs[:n_devices] if len(devs) >= n_devices \
        else [devs[0]] * n_devices


class TcpCluster:
    """A mon, `n_osd` OSD daemons (one per host) and a librados client
    (`client.900`), each on its own TcpNet socket on 127.0.0.1, in this
    process.

    Boots under the reference's pick-then-bind retry: ports are picked
    free and bound later, so another process can take one in between; a
    boot that hits EADDRINUSE tears down what it started and retries
    on fresh ports.  `auth="cephx"` gives every daemon the cluster
    keyring and the client its own key (the mon's key server
    authenticates it)."""

    CLIENT = "client.900"
    ATTEMPTS = 3

    def __init__(self, n_osd: int = N_OSD, device=None, fabric=None,
                 auth: str = "none", op_timeout: float = 300.0):
        from . import device as _device
        from .auth import KeyRing
        from .client import Rados
        from .common.perf_counters import PerfCountersCollection
        from .mon.monitor import Monitor, build_initial
        from .msg.tcp import TcpNet, pick_free_ports
        from .osd.daemon import OSDDaemon

        self.device = _device.resolve(device)
        perf_collection = PerfCountersCollection()
        names = ["mon.0"] + [f"osd.{i}" for i in range(n_osd)] + \
            [self.CLIENT]
        self.keyring = KeyRing.generate(names) if auth == "cephx" else None
        self.mon, self.osds, self.rados = None, {}, None
        for attempt in range(self.ATTEMPTS):
            ports = pick_free_ports(len(names))
            self.network = TcpNet(
                {n: ("127.0.0.1", p) for n, p in zip(names, ports)})
            imap, wrap = build_initial(n_osd, osds_per_host=1)
            try:
                self.mon = Monitor(self.network, initial_map=imap,
                                   initial_wrapper=wrap,
                                   device=self.device, keyring=self.keyring)
                self.mon.init()
                for i in range(n_osd):
                    self.osds[i] = OSDDaemon(
                        self.network, i, fabric=fabric, device=self.device,
                        keyring=self.keyring,
                        perf_collection=perf_collection)
                    self.osds[i].init()
                self.rados = Rados(
                    self.network, name=self.CLIENT, op_timeout=op_timeout,
                    auth_secret=self.keyring.get(self.CLIENT)
                    if self.keyring else None).connect(30.0)
                break
            except OSError as err:
                self.shutdown()
                if err.errno != errno.EADDRINUSE or \
                        attempt == self.ATTEMPTS - 1:
                    raise

    def wait_for(self, pred, what: str, timeout: float = 60.0) -> None:
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if pred():
                return
            time.sleep(0.05)
        raise AssertionError(f"timeout waiting for {what}")

    def wait_all_up(self, timeout: float = 60.0) -> None:
        self.wait_for(lambda: sum(
            1 for o in self.osds
            if self.rados.objecter.osdmap.is_up(o)) == len(self.osds),
            "all osds up", timeout)

    def kill_osd(self, osd: int) -> None:
        """The daemon leaves the wire; the mon learns only by command."""
        self.osds.pop(osd).shutdown()

    def shutdown(self) -> None:
        if self.rados is not None:
            self.rados.shutdown()
            self.rados = None
        for d in self.osds.values():
            d.shutdown()
        self.osds.clear()
        if self.mon is not None:
            self.mon.shutdown()
            self.mon = None


def dryrun_multichip(n_devices: int, devices=None,
                     object_bytes: int = 1 << 20) -> dict:
    """The EC step over an n-device mesh, then the cluster over TCP.

    Mesh axes: 'stripe' (data parallel over objects) x 'shard' (chunk
    placement, Ceph's k+m shard fan-out across OSDs): K1 per position,
    the partials XORed per stripe row.  Encodes, checks the parity
    against the host oracle, then loses chunks 1 and 9 and reconstructs
    them over the same mesh; then `_dryrun_cluster_over_fabric`.
    Returns what the cluster leg saw (see there)."""
    from .dist import MeshECCoder, make_mesh

    devs = default_devices(n_devices) if devices is None \
        else [torch.device(d) for d in devices]
    mesh = make_mesh(n_devices, k=K, devices=devs)
    coder = MeshECCoder(K, M, mesh)
    stripe_ways = mesh.devices.shape[0]
    S, N = 2 * stripe_ways, 256
    rng = np.random.default_rng(0)
    data_np = rng.integers(0, 256, (S, K, N), dtype=np.uint8)
    parity = coder.encode(coder.shard_data(data_np))
    if parity.shape != (S, M, N) or not coder.check_parity(data_np, parity):
        raise AssertionError("multichip parity mismatch vs oracle")
    # degraded path: lose data chunk 1 + parity 9, reconstruct over
    # the same mesh
    decode_index = [0, 2, 3, 4, 5, 6, 7, 8]
    parity_np = parity.numpy()
    all_np = np.concatenate([data_np, parity_np], axis=1)
    survivors = coder.shard_data(
        np.ascontiguousarray(all_np[:, decode_index, :]))
    rec = coder.decode(decode_index, [1, 9], survivors).numpy()
    if not (np.array_equal(rec[:, 0], data_np[:, 1]) and
            np.array_equal(rec[:, 1], parity_np[:, 1])):
        raise AssertionError("multichip decode mismatch")
    return _dryrun_cluster_over_fabric(devs, object_bytes)


def _dryrun_cluster_over_fabric(devices, object_bytes: int) -> dict:
    """E2E at the flagship code shape on the real transport: mon + 16
    OSD daemons + librados client, each endpoint on its own TCP socket
    (framing, reader threads, resend), EC pool k=8 m=4 on the `tpu`
    plugin.  The write's chunk fan-out rides the device mesh (ECBackend
    stages the encode on the ICIFabric and every acting shard gathers
    its slice; ref: the messenger fan-out this replaces,
    ECBackend.cc:2037-2070), then the acting set's last shard's daemon
    dies and the read reconstructs degraded.  Fails on a handler error
    a reader thread survived, a failed queued item or a full rebuild.

    Returns {"payload", "acting", "stored": {shard: bytes on its OSD
    before the kill}, "victim", "fabric": stats}."""
    from .dist import ICIFabric
    from .osd.ec_backend import pg_cid
    from .store import ObjectId

    fab = ICIFabric(devices=devices)
    c = TcpCluster(device=devices[0], fabric=fab)
    try:
        c.wait_all_up()
        r = c.rados
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k8m4",
            "profile": {"plugin": "tpu", "k": str(K), "m": str(M),
                        "crush-failure-domain": "host"}})
        if rc != 0:
            raise AssertionError(f"profile set: {outs}")
        r.pool_create("ec", pg_num=8, pool_type="erasure",
                      erasure_code_profile="k8m4")
        io = r.open_ioctx("ec")
        payload = np.random.default_rng(7).integers(
            0, 256, object_bytes, dtype=np.uint8).tobytes()
        io.write_full("mesh_e2e", payload)
        if fab.stats["staged"] < 1:
            raise AssertionError("EC write did not ride the mesh fan-out")
        if fab.stats["fetched"] < K + M - 1:
            raise AssertionError("shards did not gather their chunks "
                                 "from the mesh")
        if io.read("mesh_e2e") != payload:
            raise AssertionError("fabric E2E read mismatch")
        omap = r.objecter.osdmap
        pool = r.pool_lookup("ec")
        raw = omap.object_locator_to_pg("mesh_e2e", pool)
        acting = list(omap.pg_to_up_acting_osds(raw)[2])
        pg = omap.pools[pool].raw_pg_to_pg(raw)
        stored = {s: c.osds[o].store.read(pg_cid(pg),
                                           ObjectId("mesh_e2e", shard=s))
                  for s, o in enumerate(acting)}
        # degraded: kill the acting set's LAST shard daemon outright,
        # mark it down, and reconstruct the read from k survivors
        victim = next(o for o in reversed(acting) if o >= 0)
        c.kill_osd(victim)
        r.mon_command({"prefix": "osd down", "ids": [str(victim)]})
        c.wait_for(lambda: not r.objecter.osdmap.is_up(victim),
                   f"osd.{victim} marked down")
        if io.read("mesh_e2e") != payload:
            raise AssertionError("degraded read mismatch after shard loss")
        if c.network.dispatch_errors:
            raise AssertionError(f"dispatch errors: "
                                 f"{c.network.last_dispatch_error}")
        faults = {key: sum(d.perf.get(key) for d in c.osds.values())
                  for key in ("queued_op_failures", "recovery_full_rebuild")}
        if any(faults.values()):
            raise AssertionError(f"daemon fault counters {faults}")
        return {"payload": payload, "acting": acting, "stored": stored,
                "victim": victim, "fabric": dict(fab.stats)}
    finally:
        c.shutdown()
