"""MiniCluster: vstart-style single-process cluster harness.

One mon (or a quorum of them) + N OSD daemons + client handles over a
LocalNetwork — the tier-2 cluster fixture the reference builds with
vstart.sh / qa/tasks/ceph.py: spin a cluster up, create pools, do IO through
librados, kill/revive daemons, and let the mon's failure handling and
the client's resend engine react.

The port's copy of `ceph_tpu.testing.cluster` in part (replicated and
erasure pools alike; replicated pools need nothing of the harness beyond
what EC pools use): `n_mon` mons (a quorum when more than one, whose
election settles in the constructor in pump mode) with `leader()`,
`kill_mon` and `revive_mon` (the revived mon resumes from the store the
killed one kept; give a single mon a `MonitorStore(LogDB(dir))` through
`mon_store` to have that store on disk), the seeded fault plane
(`fault_seed`, on the cluster's clock), crash spools per mon
(`mon_crash_dirs`) and per OSD (`start_osd(crash_dir=)`, sticky across
restarts), `crash_osd`, `start_osd`, `kill_osd`, `revive_osd`,
`start_mgr`, `rados()`, `pump`, `tick`, `wait_all_up`, `shutdown` and
the shared `fabric`.  An OSD runs on whatever store `_stores[osd]`
holds when it starts (a mounted `BlueStore` or `JournaledStore` for a
durable one), as the reference's tests use that slot.  The cluster
runs on its `device` (cuda unless the caller passes `device="cpu"`):
every OSD builds its plugins there, and so do the mon and the mgr.  `auth="cephx"` gives
the cluster one keyring (the daemons' keys and the service secret) and
each `rados()` client a key minted into it; unlike the reference, such
a client also runs in pump mode, where its MAuthRequest handshake is
pumped like any other message.  One rule differs: `tick` reaps an OSD
whose `heartbeat_tick` raises, as the reference does, and also records
the reap in `reaped` (osd id, exception type, traceback), so a kernel
fault raised from a ticked peering retry shows (the OSD has already
captured the crash into the mon's crash table, as the reference's
does).  The RGW helpers are the reference's: `rgw_multisite` (one
gateway per zone, each on its own replicated `rgw-<zone>` pool),
`kill_rgw_zone` and `restart_rgw_zone`, and so are the MDS helpers
(`start_mds`, `start_mds_standby`, `kill_mds`, `adopt_promoted`,
`fsmap`, `wait_mds_active`; threaded clusters only, as the
reference's).  `revive_mon` also hands the
revived mon the cluster's keyring (the reference's starts it without
one), and makes it `self.mon` again when `self.mon` is not alive.
"""
from __future__ import annotations

import copy
import itertools
import time
import traceback

from .. import device as _device
from ..client.rados import Rados
from ..common.log import dout
from ..common.perf_counters import PerfCountersCollection
from ..mon.monitor import Monitor, build_initial
from ..msg.messenger import LocalNetwork
from ..osd.daemon import OSDDaemon


class MiniCluster:
    def __init__(self, n_osd: int = 6, osds_per_host: int = 1,
                 threaded: bool = True, fabric=None, device=None,
                 auth: str = "none", mon_store=None, n_mon: int = 1,
                 mon_crash_dirs: dict[int, str] | None = None,
                 fault_seed: int = 0):
        if mon_store is not None and n_mon != 1:
            raise ValueError("mon_store is a single mon's store")
        self.device = _device.resolve(device)
        self.network = LocalNetwork(fault_seed=fault_seed)
        # fault-plane delays release against the same clock the mons
        # tick on, so a sim-time schedule holds messages sim-time long
        self.network.faults.clock = self._clock
        self.threaded = threaded
        #: shared ICIFabric — OSDs become device-mesh co-resident and
        #: EC writes ride the mesh fan-out (dist/fabric.py)
        self.fabric = fabric
        self._sim_now: float | None = None
        self.perf_collection = PerfCountersCollection()
        ranks = list(range(n_mon))
        self.mon_names = [f"mon.{r}" for r in ranks]
        self.osds: dict[int, OSDDaemon] = {}
        self._stores: dict[int, object] = {}
        #: per-osd crash-spool dirs, sticky across kill/revive
        self._crash_dirs: dict[int, str] = {}
        self.clients: list[Rados] = []
        self.mgr = None
        #: (osd, exception type, traceback) of every OSD `tick` reaped
        self.reaped: list[tuple[int, str, str]] = []
        # MDS fleet (ref: vstart's mds spawning): rank -> daemon (or
        # the MDSStandby wrapper that promoted into it), plus the
        # waiting standby pool
        self.mdss: dict[int, object] = {}
        self.standbys: dict[str, object] = {}
        self._standby_seq = 0
        # cephx: one cluster keyring; daemons get it whole, clients get
        # per-entity secrets minted on demand (ref: ceph-authtool
        # provisioning + AuthMonitor key server)
        self.keyring = None
        if auth == "cephx":
            from ..auth import KeyRing
            self.keyring = KeyRing.generate(
                self.mon_names + [f"osd.{o}" for o in range(n_osd)])
        self._client_keys = itertools.count(1)
        m, w = build_initial(n_osd, osds_per_host=osds_per_host)
        #: per-rank mon crash-spool dirs (the post-election spool
        #: drain); also honored by revive_mon
        self._mon_crash_dirs = dict(mon_crash_dirs or {})
        self.mons: dict[int, Monitor] = {}
        for r in ranks:
            self.mons[r] = Monitor(
                self.network, rank=r, initial_map=copy.deepcopy(m),
                initial_wrapper=copy.deepcopy(w), store=mon_store,
                threaded=threaded, clock=self._clock,
                mon_ranks=ranks if n_mon > 1 else None,
                device=self.device, keyring=self.keyring,
                crash_dir=self._mon_crash_dirs.get(r))
            self.mons[r].init()
        self.mon = self.mons[0]      # rank 0 wins elections when alive
        self._mon_stores: dict = {}
        if not threaded and n_mon > 1:
            self.pump()              # settle the election
        for osd in range(n_osd):
            self.start_osd(osd)

    # ------------------------------------------------------------ mons
    def leader(self) -> Monitor | None:
        for mn in self.mons.values():
            if mn.is_leader:
                return mn
        return None

    def kill_mon(self, rank: int = 0) -> None:
        """Hard-kill a mon: off the wire, its store kept for
        `revive_mon`."""
        mn = self.mons.pop(rank, None)
        if mn is not None:
            self._mon_stores[rank] = mn.store
            mn.shutdown()
        if self.mon is mn and self.mons:
            self.mon = self.mons[min(self.mons)]

    def revive_mon(self, rank: int = 0) -> Monitor:
        """Restart a killed mon from its surviving store."""
        ranks = [int(n.split(".")[1]) for n in self.mon_names]
        mn = Monitor(self.network, rank=rank,
                     store=self._mon_stores.get(rank),
                     threaded=self.threaded, clock=self._clock,
                     mon_ranks=ranks if len(ranks) > 1 else None,
                     device=self.device, keyring=self.keyring,
                     crash_dir=self._mon_crash_dirs.get(rank))
        mn.init()
        self.mons[rank] = mn
        if self.mon not in self.mons.values():
            self.mon = mn
        if not self.threaded:
            self.pump()
        return mn

    # ------------------------------------------------------------ osds
    def start_osd(self, osd: int,
                  crash_dir: str | None = None) -> OSDDaemon:
        store = self._stores.get(osd)
        if crash_dir is not None:
            self._crash_dirs[osd] = crash_dir
        d = OSDDaemon(self.network, osd, store=store,
                      threaded=self.threaded,
                      perf_collection=self.perf_collection,
                      mon=self.mon_names, fabric=self.fabric,
                      device=self.device, keyring=self.keyring,
                      crash_dir=self._crash_dirs.get(osd))
        self._stores[osd] = d.store
        d.init()
        self.osds[osd] = d
        return d

    def kill_osd(self, osd: int) -> None:
        """Hard-kill: the daemon vanishes from the wire; its store
        survives for a later restart (qa thrasher kill_osd model)."""
        d = self.osds.pop(osd, None)
        if d is not None:
            d.shutdown()

    def revive_osd(self, osd: int) -> OSDDaemon:
        return self.start_osd(osd)

    def crash_osd(self, osd: int, now: float | None = None) -> None:
        """Inject a fault into the OSD's next tick: it captures a
        crash report (backtrace + metadata), posts it to the mon's
        crash table, and leaves the cluster like an aborted process
        (store kept for revive_osd)."""
        self.osds[osd].inject_crash_tick = True
        self.tick(now)

    # ------------------------------------------------------------- mds
    def start_mds(self, rank: int = 0, **kw):
        """Spawn a beaconing rank daemon (threaded mode only)."""
        from ..fs import MDSDaemon
        d = MDSDaemon(self.network, self.rados(), rank=rank,
                      mon=self.mon_names, keyring=self.keyring, **kw)
        d.init()
        self.mdss[rank] = d
        return d

    def start_mds_standby(self, name: str | None = None,
                          standby_replay_rank: int | None = None):
        """Add a standby to the promotion pool."""
        from ..fs import MDSStandby
        if name is None:
            self._standby_seq += 1
            name = f"sb{self._standby_seq}"
        s = MDSStandby(self.network, self.rados(), name=name,
                       mon=self.mon_names, keyring=self.keyring,
                       standby_replay_rank=standby_replay_rank)
        s.init()
        self.standbys[name] = s
        return s

    def kill_mds(self, rank: int) -> None:
        """Hard-kill a rank daemon: beacons stop, the endpoint
        vanishes, the journal tail is left unflushed for the
        successor's replay (qa mds thrasher kill model)."""
        d = self.mdss.pop(rank, None)
        if d is not None:
            d.kill()
        # a standby that promoted INTO this rank is now dead too
        for name, s in list(self.standbys.items()):
            if getattr(s, "rank", None) == rank:
                del self.standbys[name]

    def adopt_promoted(self) -> None:
        """Move promoted standbys into the rank table so kill_mds /
        fs status style helpers see them."""
        for name, s in list(self.standbys.items()):
            if getattr(s, "active", None) is not None:
                self.mdss[s.rank] = s
                del self.standbys[name]

    def fsmap(self):
        ldr = self.leader() or self.mon
        return ldr.mdsmon.fsmap

    def wait_mds_active(self, rank: int = 0,
                        timeout: float = 30.0) -> None:
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            m = self.fsmap()
            info = m.ranks.get(rank)
            if info is not None and info.state == "active":
                self.adopt_promoted()
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"mds.{rank} never went active (fsmap e{self.fsmap().epoch}"
            f" ranks={ {r: i.state for r, i in self.fsmap().ranks.items()} })")

    # ------------------------------------------------------------- mgr
    def start_mgr(self, **kw):
        """Start (or restart) the mgr on the cluster's device."""
        from ..mgr import MgrDaemon
        if self.mgr is not None:
            self.mgr.shutdown()
        kw.setdefault("device", self.device)
        self.mgr = MgrDaemon(self.network, threaded=self.threaded,
                             mon=self.mon_names, **kw)
        self.mgr.init()
        if not self.threaded:
            self.pump()
        return self.mgr

    # ---------------------------------------------------------- client
    def rados(self, timeout: float = 30.0) -> Rados:
        name = auth_secret = None
        if self.keyring is not None:
            # mint this client's key into the shared keyring
            from ..auth import generate_key
            name = f"client.mc{next(self._client_keys)}"
            auth_secret = generate_key()
            self.keyring.keys[name] = auth_secret
        r = Rados(self.network, name=name, op_timeout=timeout,
                  threaded=self.threaded, mon=self.mon_names,
                  auth_secret=auth_secret)
        self.clients.append(r)   # before connect: pump() must see it
        if self.threaded:
            r.connect(timeout)
        else:
            r.objecter.pump_hook = self.pump
            r.objecter.start()
            self.pump()
            if r.objecter.osdmap.epoch < 1:
                raise TimeoutError("no osdmap after pump")
            r._connected = True
        return r

    # ------------------------------------------------------------ sync
    def pump(self, rounds: int = 30) -> None:
        """Non-threaded mode: pump every endpoint until quiescent."""
        for _ in range(rounds):
            # release fault-held messages whose deadline passed;
            # counts as movement so we keep pumping
            moved = self.network.faults.flush()
            moved += sum(mn.ms.poll() for mn in self.mons.values())
            for d in self.osds.values():
                moved += d.ms.poll()
            for c in self.clients:
                moved += c.objecter.ms.poll()
            if self.mgr is not None:
                moved += self.mgr.ms.poll()
            if not moved:
                break

    def _clock(self) -> float:
        """Mon clock: simulated when ticks carry `now`, else real —
        keeps the mon's failure/auto-out timers in the same time domain
        as the OSD heartbeats."""
        return self._sim_now if self._sim_now is not None \
            else time.monotonic()

    def tick(self, now: float | None = None) -> None:
        """One heartbeat round on every live OSD + a mon tick; pumps
        in non-threaded mode so the exchange completes.  An OSD whose
        tick raises has already crash-captured (osd/daemon.py
        heartbeat_tick); it is reaped like an aborted process: off the
        wire, store kept for a revive, and recorded in `reaped`."""
        if now is not None:
            self._sim_now = now
        for osd, d in list(self.osds.items()):
            try:
                d.heartbeat_tick(now)
            except Exception as ex:
                dout("cluster", 0).write(
                    "osd.%d crashed in tick (%s: %s) — reaped",
                    osd, type(ex).__name__, ex)
                self.reaped.append((osd, type(ex).__name__,
                                    traceback.format_exc()))
                del self.osds[osd]
                d.shutdown()
        if not self.threaded:
            self.pump()
        for mn in self.mons.values():
            mn.tick(now)
        if not self.threaded:
            self.pump()

    # ------------------------------------------------------------- rgw
    def rgw_multisite(self, zones=("z1", "z2"), zonegroup: str = "zg1",
                      realm: str = "gold", index_shards: int = 4,
                      sync_interval: float = 0.05, **kw) -> list:
        """Spin one RGW gateway per zone (first zone = metadata
        master), each over its own `rgw-<zone>` pool, commit the
        realm/zonegroup/zone period into EVERY zone's pool (the
        `realm pull` bootstrap), and start the sync agents.  Returns
        the gateways in zone order (ref: the two-cluster multisite
        topology of qa/tasks/rgw-multisite; collapsed onto one RADOS
        cluster with per-zone pools)."""
        from ..rgw import RGWGateway
        gws = []
        for z in zones:
            gws.append(RGWGateway(
                self.rados(), pool=f"rgw-{z}", zone=z,
                index_shards=index_shards,
                sync_interval=sync_interval, **kw))
        for gw in gws:
            adm = gw.multisite.admin
            adm.realm_create(realm)
            adm.zonegroup_create(zonegroup)
            for i, z in enumerate(zones):
                adm.zone_create(
                    z, zonegroup,
                    endpoint=f"http://127.0.0.1:{gws[i].port}",
                    master=(i == 0))
            adm.period_commit()
            gw.multisite.refresh(force=True)
        self.rgws = getattr(self, "rgws", [])
        self.rgws.extend(gws)
        for i, z in enumerate(zones):
            # HTTP fault coverage: peer pulls to this zone's endpoint
            # resolve to the entity "rgw.<zone>" in partition rules
            self.network.faults.bind_alias(
                f"http://127.0.0.1:{gws[i].port}", f"rgw.{z}")
            gws[i].faults = self.network.faults
        for gw in gws:
            gw.start()
        return gws

    def kill_rgw_zone(self, gw) -> None:
        """Stop a zone's gateway the unclean way a kill -9 looks to
        the rest of the site: the sync agent abandons its in-flight
        batch (markers for it never persist), the HTTP port closes,
        and NO final GC pass runs — exactly the state a restart must
        recover from via the durable sync markers."""
        gw.sync._stop.set()
        if gw.sync._thread is not None:
            gw.sync._thread.join(timeout=10.0)
        gw.pusher.stop()
        gw._gc_stop.set()
        gw.httpd.shutdown()
        gw.httpd.server_close()
        if gw in getattr(self, "rgws", []):
            self.rgws.remove(gw)

    def restart_rgw_zone(self, gw, **kw):
        """Bring a killed zone's gateway back on the SAME port (its
        endpoint is baked into every peer's period) and pool — the
        restarted sync agent resumes from the durable markers.  The
        old gateway's security config rides along by default: a
        secured zone restarted anonymous would have its signed pulls
        refused by every peer (and stop gating its own surface)."""
        from ..rgw import RGWGateway
        kw.setdefault("keyring", gw.keyring)
        kw.setdefault("system_key", gw.system_key)
        if gw.keystone is not None:
            kw.setdefault("keystone_url", gw.keystone.url)
        g2 = RGWGateway(
            self.rados(), pool=gw.pool, zone=gw.zone, port=gw.port,
            index_shards=gw.index_shards,
            sync_interval=gw.sync.interval, **kw)
        self.rgws = getattr(self, "rgws", [])
        self.rgws.append(g2)
        g2.faults = gw.faults
        g2.start()
        return g2

    def wait_all_up(self, timeout: float = 30.0) -> None:
        end = time.monotonic() + timeout
        want = set(self.osds)
        while time.monotonic() < end:
            if not self.threaded:
                self.pump()
            m = self.mon.osdmap
            if all(o < m.max_osd and m.is_up(o) for o in want):
                return
            time.sleep(0.01)
        raise TimeoutError("osds never came up")

    def shutdown(self) -> None:
        for gw in list(getattr(self, "rgws", [])):
            gw.shutdown()
        for sb in list(self.standbys.values()):
            sb.shutdown()
        for d in list(self.mdss.values()):
            d.shutdown()
        for c in self.clients:
            c.shutdown()
        if self.mgr is not None:
            self.mgr.shutdown()
        for d in list(self.osds.values()):
            d.shutdown()
        for mn in self.mons.values():
            mn.shutdown()
