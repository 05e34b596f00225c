#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one card: the erasure-code data
path, CRUSH placement, compiled repair, the placement tools (crushtool,
osdmaptool and the upmap balancer), the device guard, the multi-device EC
mesh and its OSD-side fabric, the ceph_erasure_code_benchmark CLI, the
EC placement group's data plane (ECBackend over MemStore), the port's
own cluster (mon, OSD daemons with EC peering and recovery, librados,
and a replicated pool beside the EC pool), and that cluster over TCP
with cephx, as daemon processes driven by `rados bench` and the `rados`
CLI, in the port's dry run, and on durable stores through SIGKILLs and
restarts.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each failing the run (non-zero exit) on any error or mismatch:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ceph_tpu_torch/ec/kernels/csrc and print
   ptxas's registers and stack frame for each (from the log kept beside
   the library, so a cached build is checked too); a kernel with a stack
   frame (accumulators pushed to local memory) fails the run;
3. K1 (gf_matmul_cuda) against its plain PyTorch version over
   S x N x (r, k) sweeps with random matrices, r = 1 .. 8 and 10 rows,
   ragged and unaligned inputs included;
4. K2 (gf_decode_select_cuda) against its plain version over every 1-
   and 2-erasure pattern of k=8 m=4, with garbage in the erased slots;
5. the main path at full width through the user entry points: the `tpu`
   plugin k=8 m=4 reed_sol_van on cuda, one 1 MiB object through
   encode() against the numpy oracle, then 256 stripes of 1 MiB through
   encode_batch, decode_batch and decode_batch_full (erasures [1, 9]) and
   an ECUtil encode -> lose 2 shards -> decode_concat round trip.
   Kernel launch counts are zeroed before and read after; a kernel that
   the path did not launch fails the run;
6. time encode, staged decode and full-width decode (CUDA events, warmup,
   median of 7) and each kernel beside its plain version and its bound;
   K1 at both of its main-path shapes (encode r=4, staged decode r=2);
7. K3 (crush_do_rule_cuda) against its plain PyTorch version: every rule
   shape of the batch engine's tests on small straw2 hierarchies under
   jewel and firefly tunables, all-in and 15 % out / 15 % partial
   weights, a choose_args weight set with id remaps, tie-heavy and
   many-weight flat buckets, and the 10,000-OSD map for the first 65,536
   seeds of both pools below; ptxas's registers and stack frame of K3;
8. CRUSH placement at full width through the user entry point:
   `osdmaptool --createsimple 10000 --test-map-pgs` (10,000 OSDs, 500
   straw2 hosts of 20, jewel tunables, 1,048,576 PGs of size 3) plus an
   EC k=8 m=4 pool (chooseleaf_indep 12 type host, 65,536 PGs), mapped by
   OSDMapMapping(device=cuda).update(); then a failure epoch (100 OSDs
   out, 100 reweighted to 0x8000, 50 down) and update() again.  Each
   epoch: 256 sampled PGs of each pool against the scalar
   pg_to_up_acting_osds, and the PGs per OSD.  K3's launch count is
   zeroed before and read after (it must be above 0); the count of pools
   that took the scalar engine must stay 0;
9. time K3 over 1,048,576 seeds (CUDA events), update() on the host
   clock and split into its pieces, and the plain version at 65,536
   seeds; K3's bound from the
   straw2 item evaluations the plain version counts over all 1,048,576
   seeds, the integer instructions of one hash in K3's SASS and the SM
   clock read during the timing;
10. compiled repair at full width through the user entry points:
   `factory("jerasure", k=4 m=2 reed_sol_van)`, `factory("clay", k=4
   m=2)` (d=5) and `factory("lrc", k=4 m=2 l=3)` on cuda, 8 objects of
   4 MiB each (stripe unit 4096 B, 256 stripes; cut from 64 to keep the
   smoke's wall time), made from the seed and
   encoded by ecutil on the host.  Shard 0 is lost; each object's helper
   buffers are cut as an OSD ships them (plan.byte_extents +
   ecutil.expand_stream_extents) and ecutil.compiled_repair_streams
   rebuilds it, twice; jerasure also rebuilds shards {1, 2} of every
   object.  On object 0, every single-erasure signature (jerasure: every
   double too) equals the original; one compile per signature; helper
   bytes read per byte rebuilt are 4.0 / 2.5 / 3.0.  Then clay k=6 m=3
   d=8 on one object (a 27 x 72 repair matrix) and gf2_matmul_device
   against bitmatrix_apply for liber8tion k=8, liberation k=7 w=7 and
   blaum_roth k=6 w=6 over 4 MiB of packets.  K1's launch count is
   zeroed before and read after: one launch per repair or bit-matrix
   product.  K1 equals its plain version at every repair shape, two
   with tables above 48 KiB (k_in 256 and 400) included;
11. time each code's rebuild of its 8 objects on the host clock, split
   into gather, copy in, K1 (also by CUDA events), copy back and
   scatter, with the rebuilt MB/s, beside the first (compiling) and
   second pass of phase 10; K1 per launch at each repair shape beside
   its bound ((k_in + r) * N bytes over 3.35 TB/s, or r * k_in * N
   operations at the int8 rate) and its plain version;
12. crushtool on the card, as Ceph's "Editing a CRUSH map" does it at the
   placement scale: `crushtool --build --num-osds 10000 host straw2 20
   root straw2 0`, `-d`, two rules appended (replicated_rule: chooseleaf
   firstn 0 type host; ec_k8m4: set_chooseleaf_tries 5, chooseleaf indep
   0 type host), `-c`, the decompile fixed point, then `-i --test
   --show-statistics --show-utilization` over x = 0 .. 1,048,575 for
   rule 0 at num_rep 3 and rule 1 at 12: one K3 launch per (rule,
   num_rep), no scalar fallback, every x of full size; K3 against the
   plain version on the card over every 4th x of rule 0 and every 16th
   x of rule 1 (262,144 and 65,536 x over the whole range, cut to keep
   the smoke's wall time, so neither text is held to the plain
   version's tables), 256 sampled x equal to
   CrushWrapper.do_rule, and the text equal to CrushTester(device="cpu")'s
   at 1,024 x; K3 by CUDA events in the tool's run, and the split of one
   more run with each piece a lap of it (map load, then
   CrushTester.test's timings: compile_map, map_batch, copy back,
   counting and formatting);
13. the balancer: `osdmaptool --createsimple 10000 --osds-per-host 20
   --pg-num 1048576`, then `--upmap --upmap-max 10 --upmap-deviation 5
   --test-map-pgs` (the tool's defaults): two K3 launches (the
   balancer's update() and --test-map-pgs's), timed by CUDA events in
   that run; every upmapped PG on 3 hosts and equal to the scalar
   pg_to_up_acting_osds after the Incremental, Balancer.score()'s stddev
   lower after; the split of one more pass, each piece a lap of it
   (update, calc_pg_upmaps's timings: clone, _build_pgs_by_osd, search;
   apply_incremental, second update); then at 500 OSDs / 16,384 PGs
   the command file from the card equals the one from `--device cpu`;
14. the device guard (ceph_tpu_torch.common.devguard): first the host
   cost per call of K1's wrapper, the operator's launch() and the
   plugin's encode_batch with the guard off and on; then, armed, phase
   5's ECUtil round trip (and one on a fresh plugin, whose decode operator
   is built inside the guarded region), an OSDMapMapping.update() of
   phase 8's map, phase 10's compiled repair of one code (and one repair
   on a fresh instance of it, whose cache compiles the plan once) and
   phase 12's rule-0 test at 65,536 x, with no guard error and no
   recompile; then an `.item()` inside guard_transfers() must raise;
15. the multi-device EC mesh on one card (ceph_tpu_torch.dist.make_mesh(8,
   shard_ways=w, devices=["cuda:0"] * 8) for w = 1, 2, 4; K1 per grid
   position, the partials XORed per stripe row): phase 5's 256 x 1 MiB
   encode equal to encode_batch's parity and the plain version, the
   decode of [1, 9] at full width and all 66 two-erasure patterns at 16
   stripes equal to the lost chunks; K1's launch count zeroed before and
   read after (8 per mesh step); the mesh encode timed beside
   encode_batch, and K1 at the narrowest column slice ((128, 2, 131072)
   -> r=4) beside its bound and its plain version.  One card cannot show
   a launch on a card that is not the current device (the multi-card
   test in tests/test_torch_cuda.py does);
16. the fabric: ICIFabric(devices=["cuda:0"] * 8) with the `tpu` plugin
   on the card, 64 objects of 4 MiB (stripe unit 4096 B); 32 staged, then
   12 threads fetch every shard of those while 2 threads stage and fetch
   the other 32; every stream equal to ecutil.encode, nothing staged
   after release; each stage and fetch on the host clock;
17. the ceph_erasure_code_benchmark CLI (ceph_tpu_torch.tools.ec_bench) on
   the card for the tpu and isa plugins, k=8 m=4, 1 MiB x 64 iterations,
   encode and decode (random two-erasure patterns through its byte
   gate): seconds, KiB and MB/s;
18. the EC placement group's data plane (ceph_tpu_torch.osd.ec_backend:
   ECBackend and one ECPGShard per shard over the port's MemStores, wired
   directly) at the pool shape `tpu` k=8 m=4 reed_sol_van on the card,
   stripe unit 4096 B, 4 MiB objects: 16 objects (cut from 64, then 32)
   written through submit_transaction, a 100 KiB unaligned overwrite in
   each, every
   object read back equal to the script's bytes and every shard stream
   equal to ecutil.encode through a device="cpu" plugin (K1's plain
   version); shards 1 and 9 down and every object read degraded (K1's
   staged decode); shard 0 wiped and recovered through recover_object,
   one compiled repair (one K1 launch) per object and no full rebuild,
   equal to the streams from before, read/rebuilt exactly 8.0; the same
   recovery for REPAIR_r01.json's jerasure, clay and lrc (the 16
   objects each, 4.0 / 2.5 / 3.0); the 16 writes again through ICIFabric over
   ["cuda:0"] * 8, every chunk equal to the host path's.  Write, read,
   degraded-read and rebuilt MB/s on the host clock, K1's CUDA-event
   share of each, and a split of one write (merge, ecutil.encode, the
   HashInfo crc32c, the transaction build, MemStore's apply).  K1's
   launch count is zeroed before and read after the phase;
19. the port's cluster (ceph_tpu_torch.testing.MiniCluster on the card,
   threaded as deployed daemons run): one mon, 16 OSDs one per host, a
   `tpu` k=8 m=4 profile with crush-failure-domain=host and an erasure
   pool of pg_num 32 (Octopus's osd_pool_default_pg_num), as
   __graft_entry__.py:92-183 builds it.  64 objects of 4 MiB written
   through librados write_full and read back.  (e) The scheduled scrub:
   a data shard of one object bitrotted under its OSD's MemStore, both
   scrub intervals cut to 300 s by `config set osd` on the mon (every
   OSD applies the MConfig push; `config get osd.N` answers it for all
   16), then the cluster's heartbeat tick on a sim clock (5 s a tick)
   and no pg_scrub call, until the scheduled deep scrub of that PG has
   found the shard, repaired it on K1 and verified it ({"inconsistent":
   [oid], "repaired": 1, "unrepairable": [], "verified": True}) and
   the primary's cluster-log line "pg <pg> scrub: 1 inconsistent, 1
   repaired and re-verified" is the one scrub line in the mon's `log
   last 50 warn`; the shard equal to the plain encode again, every
   other scrub clean, the reservation peaks within osd_max_scrubs, no
   OSD marked down; `config rm` takes both intervals back.  (f) The replicated pool beside
   the EC pool, made after (e): `reppool`, replicated, pg_num 32, size
   3, min_size 2 (Octopus's defaults); 64 seeded 4 MiB objects, each one
   WriteOp of write_full and two xattrs; 16 index objects of 1,024 omap
   keys (32-byte keys, 64-byte values) and a header; one 16 MiB
   RadosStriper object; on `ecpool` one WriteOp of data plus an xattr
   (K1 encodes it); list_objects of both pools equal to what was
   written.  With the victim below down, every replicated object read
   degraded (the omap and the striped object too) and 16 more written;
   after `osd out` each pool's time to clean, the pushes, pulls and
   bytes, and every replica on its acting OSDs equal to its payload,
   xattrs and omap (sha256); then one byte of one replica flipped
   under its MemStore: pg_scrub lists it, pg_scrub(repair=True) repairs
   and verifies it, a third scrub is clean.  On `reppool`, before the
   victim dies: pool snap s19, 16 of its objects (those the victim holds
   first) overwritten with new seeded payloads and an xattr (COW clones
   on every replica), one removed, one created after; every object at
   s19 equal to its first payload (sha256), the heads to the new ones,
   the removed one ENOENT at head, the late one ENOENT at s19,
   list_snaps exactly the clones; snap_rollback of one object restores
   its data and xattrs; `ecpool` answers EOPNOTSUPP to snap_create,
   selfmanaged_snap_create and exec; the object classes: an exclusive
   lock taken and released by two clients, refcount get/put (the last
   put removes the object), version gating, 16 concurrent aio_exec
   numops adds that all land, 1,024 cls log entries added, listed by
   marker and trimmed, and every replica of those objects equal; 4 more
   librados clients each watch 2 `ecpool` and 2 `reppool` objects (one
   of each on the victim's PGs where there is one) and 64 notifies,
   timed, collect every reply.  After the recovery: the watches whose
   primary moved are on the new primaries and a notify round gets all
   16 replies, a watcher client shut down is reported timed out (2 s
   timeout), every object at s19 equal to its first payload again (the
   clone bytes the pushes carried counted), then snap_remove(s19) and
   the heartbeat tick on the sim clock (osd_snap_trim_sleep 0; the
   replicas' trim acks dropped for the first tick, so `df` shows the
   trimming PGs) until every PG's snap index is empty, `df` shows no
   trimming PG and `reppool`'s store bytes equal its bytes.  Block images
   on `reppool` (the port's rbd, through the main client and the first
   watcher client), before the victim dies: vm0 (1 GiB, order 22,
   rbd_cache on) gets 64 x 4 MiB written in order and 256 seeded 4 KiB
   writes, reads back equal to the host model and `du` reports 64
   objects; snapshot `base`, protected, cloned to vm0c, whose 128 seeded
   4 KiB writes copy up every object they touch; vm0c and vm0@base equal
   their models; the second client's writes take vm0's exclusive lock
   by cooperative hand-off and `diff` since base lists exactly their
   objects; `jvm` (64 MiB, journaling, mirrored) takes 256 writes of
   4-64 KiB and ImageMirror replays all 256 to `rbdbak` (replicated,
   pg_num 8, made beside `reppool`), both copies equal to the model; a
   64 MiB image migrates to `rbdbak` while another client writes 64
   seeded 4 KiB blocks during `migration_execute`, then commits and
   reads back equal to the model.  After the recovery: the holder
   answers a ping on vm0's header and still holds the lock (none broken),
   vm0, vm0c and vm0@base equal their models, 64 more jvm writes replay,
   an orderly failback (demote, sync, promote on `rbdbak`), vm0c is
   flattened, then the images and `rbdbak` are removed; K1 launches in
   the leg, swallowed rbd and journal errors and broken locks all 0.
   The S3/Swift gateway (the port's rgw, SigV4 on every S3 request) on
   its own pool `rgw`, which it makes (replicated, pg_num 32; an EC pool
   refuses the bucket index's omap), before the victim dies: 64 x 4 MiB
   objects (radosgw's stripe size) PUT by 4 threads and read back (ETag
   == md5), 1,024 x 4 KiB by 8 threads over all 8 index shards,
   ListObjectsV2 at max-keys 1000 in 2 pages of the model's 1,088 keys;
   one 64 MiB multipart upload of 8 x 8 MiB parts (the AWS CLI's chunk;
   ETag the md5 of the part md5s, -8); a versioned bucket with 2 keys of
   3 versions and a delete marker each (?versions and every versionId
   equal to the model), then NoncurrentDays 1 on one key's prefix and
   `lc_tick(now + 2 days)` removing its 3 noncurrent versions; a Swift
   TempAuth token and the Swift listing of the S3 bucket equal to it; an
   STS role, AssumeRole and a PUT and GET with the temporary keys, the
   untrusted caller refused; a topic whose endpoint is an HTTP receiver
   here gets 16 PUT/DELETE events in order (delivery p50/p99).  While
   the victim is down every 4 MiB object and 64 small ones read back
   equal to the model; after the recovery every object, the multipart
   object and every version, every listing and every index shard's
   keys equal the model, then every object, version and bucket is
   deleted, the gateway shut down and `rgw` removed; K1 launches in the
   leg and swallowed rgw errors 0.
   The file system (the port's `fs`: an MDS rank, a standby, the mon's
   MDSMonitor) laid out as Ceph documents CephFS on EC: `cephfs_data`,
   an EC pool on the cluster's `tpu` k=8 m=4 profile (pg_num 8, cut
   from 32 for the smoke's wall), made
   before the first MDS starts, and `cephfs_metadata`, which the MDS
   makes (replicated, size 3, pg_num 32); beacons every 0.2 s, grace 1
   s; Ceph's default file layout (4 MiB objects).  Before the victim
   dies: two clients write 16 x 4 MiB files into two directories and
   32 x 4 KiB files into one, every file read back equal to the model
   (sha256); a 4 KiB overwrite mid-file (a read-modify-write on the EC
   pool), a hardlink, a rename, and a reader's open revoking a writer's
   CAP_EXCL (the reader sees the buffered bytes).  With the victim down
   every file read again (K1 decodes), then mds.0 killed while a create
   is in flight (its reply dropped) and the standby driven to active on
   phase 19's sim clock by MDSThrasher (tick_grace / wait_takeover,
   forward jumps only); the create lands once (its ino, and the next
   create takes the next).  After the recovery every file read again,
   `fs status` and the fsmap epochs checked, every `cephfs_data`
   object's shards on their acting OSDs equal to the plain version's
   encode; K1's launches for `cephfs_data` by encode, decode and repair
   (the recovery's included) each above 0; swallowed fs errors and
   dispatch errors 0; then the daemons shut down and both pools removed.
   (g) Elastic pools, after the
   recovery below, with the victim out: the mgr (MgrDaemon on the card)
   with its pg_autoscaler and progress; one autoscale tick with the EC
   pool's bytes splits `ecpool` 32 -> 128 (next_pow2(15 in x 100 / 12);
   `reppool` stays), every object read back with no byte leaving its
   OSD; the next tick reseeds pgp_num 128, timed to clean (objects
   moved, bytes rebuilt, K1 split into compile probes and repairs, full
   rebuilds by path); one balancer round on K3 (its launches and upmap
   changes) and clean again; each OSD's `_update_pgs` host time per map
   epoch; every `ecpool` object read back and every shard on its acting
   OSD equal to the plain encode, progress's events completed, a mgr
   health slice carried by the mon's `health`.  Then OSDThrasher (seed
   SEED, min_in = min_live = 12, EIO injection on `ecpool`) for 4 rounds
   with two seeded 4 MiB writes between, one shard EIO forced if none
   was rolled and its objects read around it, heal, and the same
   checks; then (g3) the mgr's telemetry and insights modules:
   `telemetry show` proxied by the mon to the mgr answers the report
   (16 OSDs, both pools, the `tpu` k=8 m=4 profile, a 32-hex-digit
   cluster id, no host, path, pool or entity name), `telemetry send`
   writes it to a file:// target under ceph_tpu_torch/_build/smoke,
   `insights` reports the cluster log's counts over its window (sampled
   from the start of (g)); with the mgr killed, `insights` is answered
   EAGAIN.  Then (g4), rgw multisite: two zones (z1 the metadata
   master, z2), each a gateway on its own replicated pool (pg_num 32, 8
   index shards, SigV4, the peers' pulls signed as the system user),
   syncing every 0.05 s: 16 x 4 MiB and 256 x 4 KiB PUT to z1, a bucket
   made on z2 (forwarded to the master) with 64 x 4 KiB, 4 versions and
   a delete marker, 16 DELETEs; both zones converge (every index shard's
   object entries and every object's sha256 equal across the zones and
   to the model); z2 killed under 64 PUTs to z1 and restarted from its
   durable markers (no full sync); z2 partitioned from z1 on the fault
   plane (backoff, markers unmoved) and healed; a new mgr's /metrics
   over HTTP (lag gauges 0, the apply-latency counts equal the entries
   applied, the zone pools' objects equal `df`, the osdmap epoch the
   mon's) and its restful API (`/health`, `/df`, `/osd`, `/pool` equal
   the mon commands behind them, 401 without the key, the dashboard
   listing both zones); `rados rgw sync-status` equal to
   `render_sync_status`; swallowed errors, failed sync rounds, error
   lists and K1 launches 0; both pools removed.
   Every fault count 0 (queued items, dropped pulls, tick and dispatch
   errors, reaps, compiled repairs that raised, the mgr's failed
   commands); the sim clock of (e) goes on, each tick waiting for the
   ping replies that keep a busy OSD from being reported.
   (d) The paged artifact store:
   an ArtifactStore with its default layout (64 KiB pages, 1 MiB
   objects) puts a 32 MiB checkpoint of 4 shards (the last ragged) and
   a KV pool of 1,024 pages, streams every shard under the `checkpoint`
   policy and runs 4 waves of 64 seeded page ids through a `kvcache`
   handle, every byte equal to the put's (pages by sha256).  The OSD in
   the most acting sets is killed and marked down, every object read
   degraded, (d)'s streams and waves repeated degraded (K1 decodes
   counted) and both artifacts deleted; the OSD marked out, every PG's EC peering run to CLEAN (the lost shards
   rebuilt on their new OSDs by the compiled repair, on K1), every
   object read again.  Every read equals its payload, every shard of
   every object on its acting OSD equals ecutil.encode through a
   device="cpu" plugin (K1's plain version), read/rebuilt is exactly
   8.0, no full rebuild, no failed queued item and no handler error
   caught by a dispatch thread (the waits fail on the first one).  Then
   the same cluster over ICIFabric(["cuda:0"] * 8): 16 objects of 4 MiB
   written and read back, writes staged on the mesh and shards fetched
   from it.
   Write, read and degraded-read MB/s, the time from `osd out` to clean
   and the rebuilt MB/s on the host clock, K1's launches and CUDA-event
   share of each leg, recovery's launches split into compile probes and
   repairs, the messages routed, (d)'s put, stream and degraded-stream
   MB/s and page-wave p50/p99 healthy and degraded, (e)'s ticks and
   repair launches, (g)'s walls and launches, and the phase's wall.
   K1's and K3's launch counts are zeroed before and read after the
   phase;
20. the cluster on its real transport, in three legs, and the vstart
   shell (d).  (a) phase 19's
   cell over TCP (ceph_tpu_torch.dryrun.TcpCluster): the mon, 16 OSDs
   and the client each on its own socket on 127.0.0.1, cephx on and
   secure mode off (Octopus's defaults), 8 x 4 MiB writes (cut from 64),
   reads, kill, `osd down`, degraded reads, `osd out` and recovery to
   clean; every shard on its acting OSD equal to its bytes before the
   kill; frames and bytes on the wire, cephx signatures verified and
   rejected (0).  (b) `dryrun_multichip(8)` on ["cuda:0"] * 8: the mesh
   encode and decode, then a mon, 16 OSDs and a client on TCP with a
   fabric write whose 12 stored shards equal the plain version's
   encode, and a degraded read.  (c) Ceph's `rados bench` shape: `python
   -m ceph_tpu_torch.tools.daemon_main` mon and 16 OSD processes on the
   card, each with a keyring and an admin socket, a k=8 m=4 pool, the
   `rados_cli` processes `bench ecpool 2 write -t 16 --no-cleanup` and
   `bench ecpool 2 seq -t 16` (4 MiB; seq lists the pool and checks each
   read against the first), then `mkpool reppool 32` (replicated),
   `bench reppool 2 write -t 16 --no-cleanup`, `bench reppool 2 seq -t
   16`, `ls`, `setxattr` / `getxattr` / `listxattr`, `setomapval` /
   `listomapvals`, the `rbd_cli` processes `create --size 1G img`,
   `snap create img@s`, `du img` and `info img` on `reppool`, then
   `rmpool`, each output equal to the reference's text; a radosgw
   process (`python -m ceph_tpu_torch.rgw.gateway`, cephx as client.rgw)
   that makes its pool `rgw` and serves 8 x 4 MiB PUT, GET and a
   listing over HTTP, then exits 0 on SIGTERM (its start-up printed),
   and `rmpool rgw`; the write
   bench's client traces its ops (blkin_trace_all), and
   `rados_cli trace <id> --asok-dir <dir>` assembles one of its EC
   writes from the 17 admin sockets into one span tree: the primary's
   osd_op with its ec_encode_kernel span (K1) and the 11 ec_sub_write
   spans of the other shards' OSDs, printed; then the OSD in the most
   acting sets killed, `osd down` and 16 listed bench objects read
   degraded.  Bench MB/s, each daemon's
   start-up (interpreter, imports, CUDA context, kernel load, join),
   and, through each admin socket, its K1 launches, tick errors, failed
   queued items, full rebuilds and dispatch errors, all of which must
   be 0.  K1's launch count in this process is zeroed before and read
   after legs (a) and (b).  (d) the vstart shell in this process:
   `ceph_tpu_torch.tools.vstart.main(["--osds", "12", "-c", <the k=8
   m=4 host-domain profile>, "-c", "osd pool create ecp 8 erasure
   ..."])` (pg_num 8, cut from phase 19's 32) with the rest of the tour
   on its standard input and its standard output captured: 8 seeded
   4 MiB objects `put` and `get` back equal by sha256 and every shard
   on its acting OSD equal to the plain version's encode; `trace on`,
   one more `put`, `trace ls` and `trace <id>`, whose tree holds the
   ec_encode_kernel span; `pg scrub` of obj0's PG (`"inconsistent":
   []`); `balance` (K3) and `balancer status`; `serve put`, `stat` and
   `pages` on `ecp`; `kill-osd` of obj0's primary, `osd down`, a
   degraded `get` equal by sha256 that launched K1 decodes, and
   `revive-osd`; `crash-osd`, `crash ls`, `health` (HEALTH_WARN) and
   `status` (the crash's health summary), `crash archive-all`, `health`
   (HEALTH_OK), `telemetry show`, `insights`, `perf dump`, `status` and
   `quit`.  Every command's status, host seconds and K1 and K3
   launches are printed (`balance` must launch K3), and K1's launches
   by encode, decode and repair and K3's, each zeroed before and read
   after the leg; the fault counts stay 0 and the only OSD reaped is
   the crashed one;
21. the durable cluster: phase 20 (c)'s mon and 16 OSD processes, each
   with `--data-dir` under ceph_tpu_torch/_build/smoke/phase21/data on
   this machine's disk (`df -T` printed): the mon on a LogDB, every OSD
   on BlueStore, a `reppool` (replicated, pg_num 32) beside the EC pool
   with one small object in each of its PGs.  `rados bench write
   --no-cleanup -t 16 -b 4M` for 2 s;
   the OSD in the most acting sets SIGKILLed and marked down (not out),
   16 seeded 4 MiB objects written to each pool while it is down; the
   OSD restarted on its data dir and timed until every PG is clean: it
   answers peering from its durable shard log and only the shards it
   missed are rebuilt (bytes rebuilt equal to them, read/rebuilt exactly
   8.0, no full rebuild, K1 launches counted through the admin sockets);
   on `reppool` it catches up from its durable log (GetMissing, pulls
   over PGPull, pushes after PGMissingReply): the pushes it applied carry
   exactly the replicas it missed, none of them a backfill push; the mon
   SIGKILLed and restarted on its LogDB at the same epoch with the pool
   and the profile, a new client and the old one served; `rados bench
   seq` and the seeded objects read back byte for byte; one OSD stopped
   cleanly and marked down, a stored byte of a data shard of a seeded
   object flipped with `corrupt_blob_bytes`, the OSD restarted, the
   object read right through a degraded decode on K1 (its launches
   counted); `objectstore_tool --op fsck` on the stopped dir, right after
   the flip, reports exactly that blob (before that stop the client
   took pool snap s21 on `reppool` and overwrote the object of each of
   the OSD's `reppool` PGs: `objectstore_tool --op list-snaps` and
   `--op dump-snap-index` on the stopped dir list exactly those clones
   and index entries); the smoke's client then scrubs
   the PG over TCP: `pg_scrub` lists exactly that object inconsistent,
   `pg_scrub(repair=True)` repairs 1 and verifies it, a third scrub is
   clean, and the primary's K1 launches rise (its admin socket); `osd
   perf dump` through the mon shows bluestore_csum_errors above 0 for
   the bitrotted OSD alone (its restarted process counted the real
   checksum mismatch), and a MgrDaemon with devicehealth, in this
   process on the cluster's TCP network with its own cephx key (mgr.0
   in keyring.json), raises DEVICE_HEALTH for exactly that device in the
   mon's `health` and its warn line in `log last`, and its prometheus
   exporter, scraped over HTTP, carries that device's health and media
   error gauges equal to devicehealth's record; `config set osd
   osd_max_backfills 2` reaches all 16 OSD processes (each admin
   socket's `config get`) and `config rm` takes it back; that restarted
   OSD's process alone runs with errcheck armed (CEPH_TPU_ERRCHECK=1,
   CEPH_TPU_ERRCHECK_DIR): its dump, merged after the stop, gives the
   fired / total handlers, the fired ones by module, and the sub-read
   handler that takes BlueStore's checksum mismatch must have fired;
   everything stopped, the repaired shard on the bitrotted OSD's disk
   equal to the plain encode (sha256), each seeded shard on that disk,
   the restarted OSD's and two others' equal to the plain version's
   encode (tolerance 0), the replicas the restarted OSD pulled equal to
   their payloads on its disk, and `monstore_tool show-versions` on the mon's
   dir at the client's last epoch (its paxos holds one commit per map
   epoch, the crash table's first and one per commit of the config, the
   cluster log and the fsmap).  MB/s of the writes, seq and the
   degraded read, the restart-to-clean seconds of the OSD and the mon,
   every daemon's start-up split (its store's open included), the WAL
   sizes and statfs per daemon, and every fault count (0);
22. chaos on a three-mon quorum: the port's MiniCluster(n_osd=16, one
   per host, n_mon=3, pump mode, fault_seed=7) on the card, phase 19's
   `tpu` k=8 m=4 host-domain `ecpool` of pg_num 32, 16 seeded 4 MiB
   objects, then ChaosRunner(seed=1) on `ecpool` over the reference's
   schedule (tests/test_chaos.py: mon.2 partitioned from mon.0 and
   mon.1 at 20 s and healed at 60, osd.3 killed at 80 and revived at
   120, 2 % seeded Ping loss among the OSDs from 140 to 200) and the
   primary of chaos_00001 isolated from 220 to 280 s.  run() returns
   without InvariantViolation (a majority quorum, every PG active+clean,
   every acked write read back, health clear, an empty crash table);
   then acked == ops_total > 0, a partition and a drop counted, the 16
   objects read back byte for byte, K1 launched (split into encodes,
   decodes and compiled repairs), the crash table empty, every fault
   count 0 and the leader's quorum [0, 1, 2]; `log last` answers the same
   mon-originated lines from each of the three mons, "osd.3 marked down
   after failure reports from its peers" among them.  The fault digest and
   counts, each phase's p50/p99, the elections held, the sim seconds
   from the mon heal to a full quorum and the leg's host seconds.

Integer outputs are compared exactly (tolerance 0).  The last two lines
are the kernel table and {"ok": true, "device": {...}}, both JSON.
"""
from __future__ import annotations

import contextlib
import hashlib
import http.client
import io
import itertools
import json
import os
import random
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
K, M = 8, 4
OBJECT = 1 << 20                 # 1 MiB objects
CHUNK = OBJECT // K              # 131072 B
STRIPES = 256                    # stripes per launch, as bench.py
ERASURES = [1, 9]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 peak
SMS, INT32_LANES = 132, 64       # H100 SXM: SMs, INT32 lanes per SM
N_OSD, OSDS_PER_HOST = 10_000, 20
PG_NUM, EC_PG_NUM = 1 << 20, 1 << 16
EC_K, EC_M = 8, 4
SAMPLE = 256                     # identity sample per pool, as placement_bench
PLAIN_SEEDS = 1 << 16
REPAIR_OBJECTS = 8               # per code, cut from 64, 32, 16 (the wall)
REPAIR_OBJECT = 4 << 20          # 4 MiB objects
STRIPE_UNIT = 4096               # osd_pool_erasure_code_stripe_unit default
REPAIR_CODES = [                 # REPAIR_r01.json's profiles and read/rebuilt
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}, 4.0),
    ("clay", {"k": "4", "m": "2"}, 2.5),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 3.0),
]
WIDE_CLAY = {"k": "6", "m": "3", "d": "8"}   # the corpus's wider clay profile
TOOL_TESTS = [(0, 3), (1, 12)]   # crushtool --test (rule, num_rep)
TOOL_X = 1 << 20                 # x = 0 .. 1,048,575
TOOL_SAMPLE = 256                # sampled x per rule against do_rule
TOOL_PLAIN_CHUNK = 1 << 18       # seeds per pass of the plain version there
# stride of the x held to the plain version per rule, to keep the smoke's
# wall time: every 4th x of rule 0 (cut from every x, PERF.md section 4);
# every 16th x of rule 1 (the 12-wide indep rule, 8x rule 0's cost per
# x); 262,144 and 65,536 x spread over the whole launch
TOOL_PLAIN_STRIDE = {0: 4, 1: 16}
TOOL_GUARD_X = 1 << 16           # phase 14's guarded tester run
TOOL_CPU_X = 1 << 10             # text against CrushTester on the CPU
TOOL_RULES = """\
rule replicated_rule {
\tid 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take root
\tstep chooseleaf firstn 0 type host
\tstep emit
}

rule ec_k8m4 {
\tid 1
\ttype erasure
\tmin_size 3
\tmax_size 12
\tstep set_chooseleaf_tries 5
\tstep take root
\tstep chooseleaf indep 0 type host
\tstep emit
}
"""
UPMAP_MAX, UPMAP_DEVIATION = 10, 5   # osdmaptool's --upmap defaults
# the card-against-CPU balancer map, cut from 65,536 PGs to keep phases
# 12-14 short (the CPU side is the plain version)
CROSS_OSD, CROSS_PG = 500, 1 << 14    # cut from 1,000 and 1 << 15
MESH_WAYS = (1, 2, 4)            # shard_ways of the one-card mesh
MESH_PATTERN_S = 16              # stripes per two-erasure pattern
FABRIC_OBJECTS = 64              # 4 MiB objects through the fabric
BENCH_ITERATIONS = 64            # ec_bench --iterations
SPIN_CYCLES = 4_000_000          # about 2 ms at the H100's 1980 MHz


def make_lock(name: str):
    """The port's lock factory, so the lock-order sanitizer sees the
    smoke's locks too (imported at the call: a checkout without the
    package fails at its first phase, not at import)."""
    from ceph_tpu_torch.common.lockdep import make_lock as port_make_lock
    return port_make_lock(name)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, repeats: int = 7) -> float:
    """Median over `repeats` of the mean time of `reps` calls, CUDA
    events around each group, after a warmup."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def device_ms(fn, reps: int = 20, repeats: int = 7) -> float:
    """Like time_ms, but each group is queued behind a spin kernel of
    about 2 ms, so the card runs the launches back to back whatever the
    host's cost of launching them: the kernel's own time."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item()) \
        if a.numel() else 0


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` whose data pointer is 1 byte off 16."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = (16 - buf.data_ptr() % 16) % 16 + 1
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_k1(bm, gen: torch.Generator, dev) -> int:
    worst = 0
    cases = 0
    for (r, k), s, n in itertools.product(
            [(4, 8), (2, 8), (3, 5), (4, 20), (10, 6), (1, 8), (5, 8),
             (6, 8), (7, 8), (8, 8)], [1, 3, 4, 7],
            [1, 31, 4096, CHUNK + 17]):
        mat = torch.randint(0, 256, (r, k), generator=gen, device=dev,
                            dtype=torch.uint8)
        tables = torch.from_numpy(
            bm.packed_nibble_tables(mat.cpu().numpy())).to(dev)
        data = torch.randint(0, 256, (s, k, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        want = bm.gf_matmul_plain(mat, data)
        for d in (data, unaligned_copy(data)) if n == 4096 else (data,):
            err = max_err(bm.gf_matmul_cuda(tables, d, r), want)
            if err:
                raise AssertionError(f"K1 differs at r={r} k={k} S={s} "
                                     f"N={n} ptr%16={d.data_ptr() % 16}")
            worst = max(worst, err)
            cases += 1
    torch.cuda.synchronize()
    print(f"phase 3: K1 == plain on {cases} cases (max_abs_err {worst})")
    return worst


def check_k2(bm, ec, make_decode_matrix_full, gen: torch.Generator,
             dev) -> int:
    n = K + M
    s, nbytes = 3, 4096 + 5
    worst = 0
    patterns = [list(p) for r in (1, 2) for p in itertools.combinations(range(n), r)]
    for erasures in patterns:
        decode_index = [i for i in range(n) if i not in erasures][:K]
        full = make_decode_matrix_full(ec.encode_matrix, K, n, decode_index,
                                       erasures)
        valid = np.ones(n, dtype=bool)
        valid[erasures] = False
        op = bm.GFDecodeFull(full, valid, dev)
        data = torch.randint(0, 256, (s, K, nbytes), generator=gen,
                             device=dev, dtype=torch.uint8)
        arrival = torch.cat([data, ec.encode_batch(data)], dim=1)
        want_rows = arrival[:, erasures].clone()
        arrival[:, erasures] = torch.randint(
            0, 256, (s, len(erasures), nbytes), generator=gen, device=dev,
            dtype=torch.uint8)
        got = bm.gf_decode_select_cuda(op.tables, op.sel_t, arrival)
        plain = bm.gf_decode_select_plain(op.mat_t, op.runs, arrival)
        err = max(max_err(got, plain), max_err(got, want_rows))
        if err:
            raise AssertionError(f"K2 differs for erasures {erasures}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    print(f"phase 4: K2 == plain == lost rows on {len(patterns)} erasure "
          f"patterns (max_abs_err {worst})")
    return worst


def main_path(ec, ecutil, gf, gen: torch.Generator, dev) -> dict:
    """The full-width slice through the user entry points.  Returns the
    device tensors the timing phase reuses."""
    n = K + M
    rng = np.random.default_rng(SEED)
    obj = rng.integers(0, 256, OBJECT, dtype=np.uint8).tobytes()
    chunks = ec.encode(set(range(n)), obj)
    want = np.frombuffer(obj, dtype=np.uint8).reshape(K, CHUNK)
    want = np.concatenate([want, gf.gf_matmul_bytes(ec.encode_matrix[K:], want)])
    for i in range(n):
        if not np.array_equal(chunks[i], want[i]):
            raise AssertionError(f"encode() chunk {i} differs from the oracle")

    data = torch.randint(0, 256, (STRIPES, K, CHUNK), generator=gen,
                         device=dev, dtype=torch.uint8)
    parity = ec.encode_batch(data)
    full = torch.cat([data, parity], dim=1)
    decode_index = [i for i in range(n) if i not in ERASURES][:K]
    survivors = full[:, decode_index].contiguous()
    lost = full[:, ERASURES].clone()
    staged = ec.decode_batch(decode_index, ERASURES, survivors)
    arrival = full.clone()
    arrival[:, ERASURES] = 0xA5              # garbage in the erased slots
    rebuilt = ec.decode_batch_full(ERASURES, arrival)
    if not torch.equal(staged, lost) or not torch.equal(rebuilt, lost):
        raise AssertionError("decode did not rebuild chunks 1 and 9")

    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    logical = data.cpu().numpy().tobytes()
    t_encode = []                 # first call, then a repeat
    for _ in range(2):
        t0 = time.monotonic()
        shards = ecutil.encode(sinfo, ec, logical)
        t_encode.append(time.monotonic() - t0)
    for i in range(K, n):
        if shards[i] != parity[:, i - K].cpu().numpy().tobytes():
            raise AssertionError(f"ecutil.encode shard {i} differs")
    degraded = {i: v for i, v in shards.items() if i not in ERASURES}
    t_decode = []
    for _ in range(2):
        timings = {}
        t0 = time.monotonic()
        rebuilt_object = ecutil.decode_concat(sinfo, ec, degraded, timings)
        t_decode.append(time.monotonic() - t0)
    if rebuilt_object != logical:
        raise AssertionError("ecutil decode_concat round trip differs")
    torch.cuda.synchronize()
    stage = timings["stage"][1] - timings["stage"][0]
    kernel = timings["kernel"][1] - timings["kernel"][0]
    def ms(ts):
        return " then ".join(f"{t * 1e3:.1f}" for t in ts)
    print(f"phase 5: ecutil host clock, {len(logical)} B, first call then "
          f"repeat: encode {ms(t_encode)} ms, decode_concat {ms(t_decode)} "
          f"ms (repeat: survivor stack {stage * 1e3:.1f} ms, copy in + "
          f"kernel + copy back {kernel * 1e3:.1f} ms)")
    return {"data": data, "parity": parity, "survivors": survivors,
            "arrival": arrival, "decode_index": decode_index,
            "staged": staged, "rebuilt": rebuilt}


# ---------------------------------------------------------------------------
# CRUSH placement: phases 7-9

def max_err32(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, stack frame and spills of `kernel` from ptxas -v."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" not in line or kernel not in line:
            continue
        rest = lines[i + 1:]
        end = next((j for j, ln in enumerate(rest) if "Compiling entry" in ln),
                   len(rest))
        block = " ".join(rest[:end])
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        if frame and regs:
            return {"registers": int(regs.group(1)),
                    "stack_frame_bytes": int(frame.group(1)),
                    "spill_store_bytes": int(frame.group(2)),
                    "spill_load_bytes": int(frame.group(3))}
    raise AssertionError(f"no ptxas report for {kernel}")


def sass_instructions(lib_path, function: str) -> int:
    """Instructions (NOPs aside) of one kernel in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    for name, body in zip(parts[1::2], parts[2::2]):
        if name == function:
            ops = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)]
            return sum(1 for op in ops if not op.startswith("NOP"))
    raise AssertionError(f"{function} not in the SASS of {lib_path}")


class ClockSampler:
    """The SM clock (MHz) read by nvidia-smi every 100 ms while the
    block runs; the process is stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.mhz = [int(v) for v in out.split() if v.strip().isdigit()]
        return False


def placement_map():
    """`osdmaptool --createsimple 10000`: 500 straw2 hosts of 20 OSDs
    under a straw2 root, jewel tunables, pool 0 of 1,048,576 PGs x 3;
    plus pool 1, EC k=8 m=4 (chooseleaf_indep 12 type host), 65,536 PGs."""
    from ceph_tpu_torch.crush.types import (CRUSH_RULE_CHOOSELEAF_INDEP,
                                            CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
                                            CrushRule, CrushRuleMask,
                                            CrushRuleStep)
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
    m = OSDMap()
    m.build_simple(N_OSD, osds_per_host=OSDS_PER_HOST,
                   pg_pool=PGPool(pg_num=PG_NUM, pgp_num=PG_NUM, size=3))
    root = next(b.id for b in m.crush.buckets
                if b is not None and b.type == 10)
    size = EC_K + EC_M
    m.crush.rules.append(CrushRule(
        steps=[CrushRuleStep(CRUSH_RULE_TAKE, root),
               CrushRuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, size, 1),
               CrushRuleStep(CRUSH_RULE_EMIT)],
        mask=CrushRuleMask(ruleset=1, type=POOL_TYPE_ERASURE, min_size=1,
                           max_size=16)))
    m.pools[1] = PGPool(type=POOL_TYPE_ERASURE, size=size,
                        min_size=EC_K + 1, crush_rule=1, pg_num=EC_PG_NUM,
                        pgp_num=EC_PG_NUM)
    m.pool_names[1] = "ecpool"
    return m


def check_k3(cb, ct, placement, dev) -> tuple[int, int]:
    """Phase 7: K3 against the plain version, exactly.  Returns
    (cases, max_abs_err)."""
    from ceph_tpu_torch.crush.types import ChooseArg, CrushRule
    rng = np.random.default_rng(SEED)
    worst = 0
    cases = 0

    def one(m, result_max, weight, xs, label, ruleno=0, choose_args=None,
            class_path=None):
        nonlocal worst, cases
        cc = cb.compile_map(m, choose_args=choose_args,
                            class_path=class_path, device=dev)
        cfg = cc.rule_cfg(ruleno, result_max)
        xs = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=dev)
        weight = torch.as_tensor(np.asarray(weight, dtype=np.int64),
                                 device=dev)
        got, got_n = cb.crush_do_rule_cuda(cc, cfg, xs, weight)
        want, want_n = cb.map_batch_plain(cc, cfg, xs, weight)
        err = max(max_err32(got, want), max_err32(got_n, want_n))
        if err:
            raise AssertionError(f"K3 differs from plain: {label}")
        worst = max(worst, err)
        cases += 1

    seeds = rng.integers(0, 1 << 32, 4000, dtype=np.int64)
    for rule in ("replicated_firstn", "ec_indep", "two_level_firstn",
                 "direct_osd_indep", "direct_osd_firstn"):
        for tunables in ("jewel", "firefly"):
            m, root = ct.build_hierarchy(seed=cases, tunables=tunables)
            steps, result_max = ct.rule_shapes(root)[rule]
            m.rules.append(CrushRule(steps=steps))
            for weight in (np.full(m.max_devices, 0x10000),
                           ct.make_weight(m.max_devices, seed=cases)):
                one(m, result_max, weight, seeds, f"{rule} {tunables}")
    m, root = ct.build_hierarchy(seed=11)
    m.rules.append(CrushRule(steps=ct.rule_shapes(root)["ec_indep"][0]))
    rb = m.bucket(root)
    ca = {root: ChooseArg(
        ids=[i - 1000 for i in rb.items],
        weight_set=[[int(rng.integers(1, 8) * 0x10000) for _ in rb.items]
                    for _ in range(3)])}
    for class_path in (True, False):
        one(m, 6, ct.make_weight(m.max_devices, seed=5), seeds,
            "choose_args weight set", choose_args=ca, class_path=class_path)
        one(ct.build_flat([0xFFFF0000] * 20), 3, np.full(20, 0x10000),
            np.arange(20_000), "tie-heavy flat", class_path=class_path)
        n = cb.CLASS_PATH_MAX + 8
        one(ct.build_flat([0x10000 + i * 0x100 for i in range(n)]), 3,
            ct.make_weight(n, seed=3), seeds, "many weights",
            class_path=class_path)
    for pool_id, pool in placement.pools.items():
        ruleno = placement.crush.find_rule(pool.crush_rule, pool.type,
                                           pool.size)
        pps = pool.raw_pg_to_pps_batch(np.arange(PLAIN_SEEDS), pool_id)
        one(placement.crush, pool.size, placement.osd_weight, pps,
            f"10k map pool {pool_id}", ruleno=ruleno)
    torch.cuda.synchronize()
    print(f"phase 7: K3 == plain on {cases} cases (max_abs_err {worst})")
    return cases, worst


def failure_epoch(osdmap):
    """100 OSDs out, 100 others reweighted to 0x8000, 50 others down."""
    from ceph_tpu_torch.osd.osdmap import Incremental
    order = np.random.default_rng(SEED).permutation(N_OSD)
    out, part, down = order[:100], order[100:200], order[200:250]
    inc = Incremental(epoch=osdmap.epoch + 1)
    inc.new_weight.update({int(o): 0 for o in out})
    inc.new_weight.update({int(o): 0x8000 for o in part})
    inc.new_down_osds.extend(int(o) for o in down)
    return inc, out, down


def drive_placement(om, placement) -> dict:
    """Phase 8: OSDMapMapping.update on the card, before and after the
    failure epoch, each checked against the scalar pipeline."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd.types import PG
    rng = np.random.default_rng(SEED + 1)
    mapping = om.OSDMapMapping()            # device None: the card
    times = []
    for epoch in (1, 2):
        if epoch == 2:
            inc, out, down = failure_epoch(placement)
            placement.apply_incremental(inc)
        t0 = time.monotonic()
        mapping.update(placement)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        for pool_id, pool in placement.pools.items():
            pm = mapping.pools[pool_id]
            if pm.up.shape != (pool.pg_num, pool.size):
                raise AssertionError(f"pool {pool_id}: up {pm.up.shape}")
            vals = pm.up[pm.up != CRUSH_ITEM_NONE]
            if vals.size == 0 or vals.min() < 0 or vals.max() >= N_OSD:
                raise AssertionError(f"pool {pool_id}: OSD ids out of range")
            for ps in rng.choice(pool.pg_num, SAMPLE, replace=False):
                pg = PG(pool_id, int(ps))
                if mapping.get(pg) != placement.pg_to_up_acting_osds(pg):
                    raise AssertionError(f"epoch {epoch}: {pg} differs from "
                                         "the scalar pipeline")
        counts = mapping.osd_pg_counts(N_OSD)
        if epoch == 1 and counts.min() == 0:
            raise AssertionError("an OSD carries no PG on the all-in map")
        if epoch == 2 and (counts[out].any() or counts[down].any()):
            raise AssertionError("an out or down OSD still carries PGs")
        holes = int((mapping.pools[1].up == CRUSH_ITEM_NONE).sum())
        print(f"phase 8: epoch {epoch}: update() {times[-1]:.3f} s on the "
              f"host clock; {SAMPLE} sampled PGs of each pool == scalar "
              f"pg_to_up_acting_osds; PGs per OSD (acting, both pools) min "
              f"{int(counts.min())} max {int(counts.max())} mean "
              f"{float(counts.mean()):.2f}; EC holes {holes}")
    return {"mapping": mapping, "update_s": times}


def update_split(cb, om, placement, dev) -> dict:
    """Host-clock split of one OSDMapMapping.update() of the current map:
    the pieces timed one by one with the calls update() makes (table
    staging by compile_map; per pool, the seed hashing and map_batch with
    the copy back); the rest of update() is the numpy epilogue (filters,
    compaction, primary affinity, temp rows)."""
    weights = np.asarray(placement.osd_weight, dtype=np.int64)
    t0 = time.monotonic()
    om.OSDMapMapping().update(placement)
    torch.cuda.synchronize()
    split = {"update": time.monotonic() - t0, "pps": 0.0, "map_batch": 0.0}
    t0 = time.monotonic()
    cc = cb.compile_map(placement.crush, device=dev)
    split["compile_map"] = time.monotonic() - t0
    for pool_id, pool in placement.pools.items():
        t0 = time.monotonic()
        pps = pool.raw_pg_to_pps_batch(np.arange(pool.pg_num), pool_id)
        t1 = time.monotonic()
        res, cnt = cc.map_batch(pps, weights, ruleno=placement.crush.find_rule(
            pool.crush_rule, pool.type, pool.size), result_max=pool.size,
            return_counts=True)
        res.cpu().numpy(), cnt.cpu().numpy()
        split["pps"] += t1 - t0
        split["map_batch"] += time.monotonic() - t1
    split["epilogue"] = split["update"] - split["compile_map"] - \
        split["pps"] - split["map_batch"]
    return split


def crush_phases(log: str, name_power: str, dev) -> tuple[dict, object]:
    """Phases 7-9; returns K3's entry of the kernels line and the
    placement map (at its failure epoch)."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import testing as ct
    from ceph_tpu_torch.ec.kernels import _build
    from ceph_tpu_torch.osd import mapping as om

    ptx = ptxas_report(log, "crush_do_rule_kernel")
    print(f"phase 7: K3 ptxas: {ptx['registers']} registers, "
          f"{ptx['stack_frame_bytes']} bytes stack frame, "
          f"{ptx['spill_store_bytes']} bytes spill stores, "
          f"{ptx['spill_load_bytes']} bytes spill loads")
    placement = placement_map()
    w_all_in = np.asarray(placement.osd_weight, dtype=np.int64)
    cases, err = check_k3(cb, ct, placement, dev)

    cb.reset_launches()
    om.reset_fallbacks()
    state = drive_placement(om, placement)
    launches = cb.LAUNCHES["crush_do_rule"]
    fallbacks = om.FALLBACKS["batch_unsupported"]
    print(f"phase 8: launches crush_do_rule {launches}, pools through the "
          f"scalar engine {fallbacks}")
    if launches == 0 or fallbacks:
        raise AssertionError("the placement path did not run through K3")

    # -- phase 9: timing and the bound ----------------------------------
    pool = placement.pools[0]
    ruleno = placement.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    cc = cb.compile_map(placement.crush, device=dev)
    cfg = cc.rule_cfg(ruleno, pool.size)
    pps = torch.from_numpy(pool.raw_pg_to_pps_batch(
        np.arange(PG_NUM), 0)).to(dev)
    weight = torch.from_numpy(w_all_in).to(dev)
    with ClockSampler() as clock:
        k3_ms = time_ms(lambda: cb.crush_do_rule_cuda(cc, cfg, pps, weight),
                        reps=3, repeats=5)
    k3_part_ms = time_ms(lambda: cb.crush_do_rule_cuda(
        cc, cfg, pps[:PLAIN_SEEDS], weight), reps=3, repeats=5)
    plain_ms = time_ms(lambda: cb.map_batch_plain(
        cc, cfg, pps[:PLAIN_SEEDS], weight), reps=1, repeats=3)
    ec = placement.pools[1]
    ec_cfg = cc.rule_cfg(placement.crush.find_rule(
        ec.crush_rule, ec.type, ec.size), ec.size)
    ec_pps = torch.from_numpy(ec.raw_pg_to_pps_batch(
        np.arange(EC_PG_NUM), 1)).to(dev)
    k3_ec_ms = time_ms(lambda: cb.crush_do_rule_cuda(cc, ec_cfg, ec_pps,
                                                     weight), reps=3,
                       repeats=5)
    # the work of this run's seeds, counted by the plain version, which
    # also holds K3 to it over all 1,048,576 seeds
    stats = {}
    want, want_n = cb.map_batch_plain(cc, cfg, pps, weight, stats=stats)
    got, got_n = cb.crush_do_rule_cuda(cc, cfg, pps, weight)
    err = max(err, max_err32(got, want), max_err32(got_n, want_n))
    if err:
        raise AssertionError("K3 differs from plain over the 1M seeds")
    lib = _build.lib_path("crush_rule")
    hash_instr = sass_instructions(lib, "crush_jhash3_probe") - \
        sass_instructions(lib, "crush_xor3_probe")
    mhz = max(clock.mhz) if clock.mhz else int(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.split()[0])
    evals = stats["straw2_evals"]
    ops_ms = evals * hash_instr / (SMS * INT32_LANES * mhz * 1e6) * 1e3
    table_bytes = sum(t.numel() * t.element_size() for t in (
        cc.items, cc.ids, cc.weights, cc.sizes, cc.btypes, cc.valid)) + \
        65536 * 8 + weight.numel() * 8
    nbytes = PG_NUM * (8 + 4 * pool.size + 4) + table_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")
    update_s = state["update_s"]
    split = update_split(cb, om, placement, dev)
    print("phase 9: update() split on the host clock (failure-epoch map): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    print(f"phase 9: K3 {k3_ms:.4f} ms per {PG_NUM} seeds "
          f"({PG_NUM / k3_ms * 1e3:.1f} mappings/s), {k3_part_ms:.4f} ms per "
          f"{PLAIN_SEEDS}; plain {plain_ms:.4f} ms per {PLAIN_SEEDS}; "
          f"update() of both pools {update_s[0]:.3f} s then "
          f"{update_s[1]:.3f} s on the host clock "
          f"({(PG_NUM + EC_PG_NUM) / update_s[0]:.1f} and "
          f"{(PG_NUM + EC_PG_NUM) / update_s[1]:.1f} mappings/s); K3 on "
          f"the EC pool's {EC_PG_NUM} seeds {k3_ec_ms:.4f} ms, so K3 is "
          f"{(k3_ms + k3_ec_ms) / 1e3 / update_s[0]:.3f} of the first "
          f"update() on {name_power}")
    print(f"phase 9: K3 bound {bound_ms:.4f} ms by {bound_by}: {evals} "
          f"straw2 item evaluations ({evals / PG_NUM:.2f} per seed) x "
          f"{hash_instr} SASS instructions per hash / ({SMS} SMs x "
          f"{INT32_LANES} INT32 lanes x {mhz} MHz, SM clock read "
          f"{min(clock.mhz or [0])}-{max(clock.mhz or [0])} MHz); bytes "
          f"{nbytes} -> {bytes_ms:.4f} ms")
    return {"name": "crush_do_rule", "route": "cuda",
            "source": "ceph_tpu_torch/crush/kernels/csrc/crush_rule.cu",
            "replaces": "ceph_tpu/crush/batch.py:885",
            "launches": launches, "max_abs_err": err, "ms": k3_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "seeds": PG_NUM, "plain_seeds": PLAIN_SEEDS,
            "ms_at_plain_seeds": k3_part_ms, "ec_pool_ms": k3_ec_ms,
            "cases": cases,
            "straw2_evals": evals, "hash_sass_instructions": hash_instr,
            "sm_clock_mhz": mhz, "bytes": nbytes, "bytes_ms": bytes_ms,
            "update_s": update_s, "update_split_s": split, **ptx}, placement


# ---------------------------------------------------------------------------
# Compiled repair: phases 10-11

def helper_bufs(ecutil, plan, shards: dict, cs: int) -> dict:
    """Each helper's shard stream cut to the plan's extents, stripe by
    stripe: exactly the bytes an OSD ships for the repair."""
    ext = plan.byte_extents(cs)
    return {h: b"".join(shards[h][o:o + c] for o, c in
                        ecutil.expand_stream_extents(ext[h], cs,
                                                     len(shards[h])))
            for h in plan.helper_ids()}


def encode_objects(ecutil, ec, sinfo, count: int, seed: int) -> list[dict]:
    """`count` objects of REPAIR_OBJECT bytes (the last stripe padded
    with zeros), made from the seed and encoded by ecutil on the host."""
    rng = np.random.default_rng(seed)
    size = -(-REPAIR_OBJECT // sinfo.stripe_width) * sinfo.stripe_width
    out = []
    for _ in range(count):
        data = rng.integers(0, 256, REPAIR_OBJECT, dtype=np.uint8).tobytes()
        out.append(ecutil.encode(sinfo, ec, data + bytes(size - len(data))))
    return out


def drive_repair(registry, ecutil, repairc, plugin: str, profile: dict,
                 ratio: float, calls: list) -> dict:
    """Phase 10 for one code on the card: lose shard 0 of REPAIR_OBJECTS
    objects and rebuild it twice through compiled_repair_streams; check
    every signature on object 0, the byte ratio and one compile per
    signature.  Appends one entry to `calls` per compiled repair (one K1
    launch each)."""
    ec = registry.factory(plugin, dict(profile))     # device None: the card
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    cs = ec.get_chunk_size(k * STRIPE_UNIT)
    sinfo = ecutil.StripeInfo(k, k * cs)
    t0 = time.monotonic()
    objs = encode_objects(ecutil, ec, sinfo, REPAIR_OBJECTS, SEED)
    t_encode = time.monotonic() - t0
    plan = ecutil.repair_plan(ec, {0}, set(range(n)) - {0})
    bufs = [helper_bufs(ecutil, plan, s, cs) for s in objs]
    read = sum(len(b) for b in bufs[0].values())
    rebuilt = len(objs[0][0])
    if read / rebuilt != ratio or \
            plan.total_planes() / plan.output_planes() != ratio:
        raise AssertionError(f"{plugin}: read/rebuilt {read}/{rebuilt}, "
                             f"want {ratio}")
    passes = []
    for _ in range(2):                # the first pass compiles the plan
        t0 = time.monotonic()
        outs = [ecutil.compiled_repair_streams(ec, plan, cs, b) for b in bufs]
        passes.append(time.monotonic() - t0)
        calls.extend([plugin] * len(bufs))
        if any(o[0] != s[0] for o, s in zip(outs, objs)):
            raise AssertionError(f"{plugin}: a rebuilt shard 0 differs")
    extra = {}
    if plugin == "jerasure":
        plan2 = ecutil.repair_plan(ec, {1, 2}, set(range(n)) - {1, 2})
        for s in objs:
            out = ecutil.compiled_repair_streams(
                ec, plan2, cs, helper_bufs(ecutil, plan2, s, cs))
            calls.append(plugin)
            if out[1] != s[1] or out[2] != s[2]:
                raise AssertionError("jerasure: lost {1, 2} differs")
        extra = {"plan2": plan2, "bufs2": helper_bufs(ecutil, plan2,
                                                       objs[0], cs)}
    sigs = [{s} for s in range(n)]
    if plugin == "jerasure":
        sigs += [set(p) for p in itertools.combinations(range(n), 2)]
    for lost in sigs:
        p = ecutil.repair_plan(ec, lost, set(range(n)) - lost)
        out = ecutil.compiled_repair_streams(
            ec, p, cs, helper_bufs(ecutil, p, objs[0], cs))
        calls.append(plugin)
        if any(out[s] != objs[0][s] for s in lost):
            raise AssertionError(f"{plugin}: signature {sorted(lost)} differs")
    compiles = repairc.cache_of(ec).stats()["compiles"]
    if len(compiles) != len(sigs) or set(compiles.values()) != {1}:
        raise AssertionError(f"{plugin}: compiles {compiles}")
    print(f"phase 10: {plugin} {profile}: {REPAIR_OBJECTS} x {REPAIR_OBJECT} "
          f"B objects, chunk {cs} B, {len(objs[0][0]) // cs} stripes; "
          f"ecutil.encode {t_encode:.1f} s on the host; shard 0 rebuilt "
          f"twice == original; read/rebuilt {read}/{rebuilt} = "
          f"{read / rebuilt}; {len(sigs)} signatures on object 0 == "
          f"original, one compile each; compiled repair of all objects "
          f"{passes[0]:.3f} s (first pass, compiles) then {passes[1]:.3f} s")
    return {"plugin": plugin, "ec": ec, "plan": plan, "bufs": bufs,
            "want": [s[0] for s in objs], "cs": cs, "passes": passes,
            "encode_s": t_encode, "rebuilt": rebuilt, "read": read, **extra}


def rebuild_pass(ecutil, state: dict) -> float:
    """Host-clock seconds of one compiled_repair_streams over every
    object, each output dropped at once (as an OSD that writes the
    rebuilt shard out and moves on)."""
    ec, plan, cs = state["ec"], state["plan"], state["cs"]
    t0 = time.monotonic()
    for bufs in state["bufs"]:
        ecutil.compiled_repair_streams(ec, plan, cs, bufs)
    return time.monotonic() - t0


def repair_split(ecutil, state: dict) -> dict:
    """Phase 11 for one code: a rebuild of every object timed piece by
    piece with the calls RepairProgram.run makes (gather, copy in, K1,
    copy back, scatter; K1 also by CUDA events around its launch, the
    host's launch cost included), between two whole passes of
    compiled_repair_streams; then the top functions of a third pass by
    cProfile's own time."""
    import cProfile
    import pstats
    from ceph_tpu_torch import device as _device
    from ceph_tpu_torch.ec.repairc import program_for
    ec, plan, cs = state["ec"], state["plan"], state["cs"]
    prog = program_for(ec, plan)
    mm = prog.kernel(ec.device)
    whole = [rebuild_pass(ecutil, state)]
    split = dict.fromkeys(("gather", "h2d", "k1", "d2h", "scatter"), 0.0)
    k1_events = 0.0
    for bufs, want in zip(state["bufs"], state["want"]):
        t0 = time.monotonic()
        x, nstripes, ssz = prog._gather(bufs, cs)
        t1 = time.monotonic()
        x_dev = _device.as_u8(x, ec.device)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out_dev = mm(x_dev)
        end.record()
        end.synchronize()
        t3 = time.monotonic()
        out = out_dev.cpu().numpy()
        t4 = time.monotonic()
        streams = prog._scatter(out, nstripes, ssz)
        t5 = time.monotonic()
        if streams[0] != want:
            raise AssertionError(f"{state['plugin']}: split rebuild differs")
        for key, a, b in (("gather", t0, t1), ("h2d", t1, t2), ("k1", t2, t3),
                          ("d2h", t3, t4), ("scatter", t4, t5)):
            split[key] += b - a
        k1_events += start.elapsed_time(end)
    whole.append(rebuild_pass(ecutil, state))
    prof = cProfile.Profile()
    prof.runcall(rebuild_pass, ecutil, state)
    stats = pstats.Stats(prof).stats
    top = sorted(((v[2], f"{Path(k[0]).name}:{k[1]}({k[2]})")
                  for k, v in stats.items()), reverse=True)[:6]
    total = sum(split.values())
    rebuilt = state["rebuilt"] * len(state["bufs"])
    return {"split_s": split, "total_s": total, "k1_events_ms": k1_events,
            "rebuilt_MBps": rebuilt / total / 1e6,
            "pass_MBps": [rebuilt / t / 1e6 for t in state["passes"]],
            "dropped_pass_s": whole,
            "dropped_pass_MBps": [rebuilt / t / 1e6 for t in whole],
            "profile_top_s": [[name, t] for t, name in top]}


def repair_phases(name_power: str, gen: torch.Generator,
                  dev) -> tuple[dict, dict]:
    """Phases 10-11; returns the keys K1's entry of the kernels line
    gains and the first code's phase-10 state."""
    from ceph_tpu_torch.ec import bitmatrix, registry, repairc
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    calls: list = []
    bm.reset_launches()
    states = [drive_repair(registry, ecutil, repairc, plugin, profile, ratio,
                           calls) for plugin, profile, ratio in REPAIR_CODES]
    # the corpus's wider clay profile: one object, 27 x 72 repair matrix
    wide = registry.factory("clay", dict(WIDE_CLAY))
    k = wide.get_data_chunk_count()
    cs = wide.get_chunk_size(k * STRIPE_UNIT)
    shards = encode_objects(ecutil, wide, ecutil.StripeInfo(k, k * cs), 1,
                            SEED)[0]
    wide_plan = ecutil.repair_plan(wide, {0},
                                   set(range(1, wide.get_chunk_count())))
    wide_bufs = helper_bufs(ecutil, wide_plan, shards, cs)
    if ecutil.compiled_repair_streams(wide, wide_plan, cs,
                                      wide_bufs)[0] != shards[0]:
        raise AssertionError("clay k=6 m=3 d=8: rebuilt shard 0 differs")
    calls.append("clay k6m3d8")
    # the bit-matrix device form over one object of packets
    bit_codes = {"liber8tion k=8": bitmatrix.liber8tion_bitmatrix(8),
                 "liberation k=7 w=7": bitmatrix.liberation_bitmatrix(7, 7),
                 "blaum_roth k=6 w=6": bitmatrix.blaum_roth_bitmatrix(6, 6)}
    rng = np.random.default_rng(SEED)
    bit_inputs = {}
    for label, g in bit_codes.items():
        rows = g.shape[1]
        packets = rng.integers(0, 256, (rows, REPAIR_OBJECT // rows),
                               dtype=np.uint8)
        got = bitmatrix.gf2_matmul_device(g[rows:], packets)
        calls.append(label)
        if not np.array_equal(got.cpu().numpy(),
                              bitmatrix.bitmatrix_apply(g[rows:], packets)):
            raise AssertionError(f"gf2_matmul_device differs: {label}")
        bit_inputs[label] = (g[rows:], packets)
    launches = bm.LAUNCHES["gf_matmul"]
    print(f"phase 10: launches gf_matmul {launches} for {len(calls)} "
          f"compiled repairs and bit-matrix products (one each); clay k=6 "
          f"m=3 d=8 shard 0 == original; gf2_matmul_device == "
          f"bitmatrix_apply for {', '.join(bit_codes)}")
    if launches == 0 or launches != len(calls) or \
            bm.LAUNCHES["gf_decode_select"]:
        raise AssertionError("the repair path did not run through K1 once "
                             "per repair")

    # -- K1 at each repair shape against its plain version, then timed --
    def bound(r: int, k_in: int, n: int) -> tuple[float, str]:
        tb = (k_in + r) * n / HBM_BYTES_PER_S * 1e3
        to = r * k_in * n / INT8_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    shapes = []
    for st in states:
        shapes.append((f"{st['plugin']} lost 0", st["ec"], st["plan"],
                       st["bufs"][0], st["cs"]))
        if "plan2" in st:
            shapes.append((f"{st['plugin']} lost 1,2", st["ec"], st["plan2"],
                           st["bufs2"], st["cs"]))
    shapes.append(("clay k6m3d8 lost 0", wide, wide_plan, wide_bufs, cs))
    cases = []
    for label, ec, plan, bufs, c in shapes:
        prog = repairc.program_for(ec, plan)
        x = torch.from_numpy(prog._gather(bufs, c)[0]).to(dev)[None]
        cases.append((label, prog.matrix, x))
    for label, (mat, packets) in bit_inputs.items():
        cases.append((label, mat, torch.from_numpy(packets).to(dev)[None]))
    for r, k_in, n in ((16, 256, 65536), (4, 400, 65536)):
        cases.append((f"random {r}x{k_in}",
                      torch.randint(0, 256, (r, k_in), generator=gen,
                                    device=dev, dtype=torch.uint8)
                      .cpu().numpy(),
                      torch.randint(0, 256, (1, k_in, n), generator=gen,
                                    device=dev, dtype=torch.uint8)))
    worst = 0
    rows = []
    for label, mat, x in cases:
        r, (_, k_in, n) = mat.shape[0], x.shape
        tables = torch.from_numpy(bm.packed_nibble_tables(mat)).to(dev)
        mat_t = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
        err = max_err(bm.gf_matmul_cuda(tables, x, r),
                      bm.gf_matmul_plain(mat_t, x))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"K1 differs from plain at {label}")
        worst = max(worst, err)
        b_ms, b_by = bound(r, k_in, n)
        rows.append({"shape": label, "r": r, "k_in": k_in, "n": n,
                     "ms": device_ms(lambda: bm.gf_matmul_cuda(tables, x, r)),
                     "paced_ms": time_ms(
                         lambda: bm.gf_matmul_cuda(tables, x, r)),
                     "plain_ms": time_ms(lambda: bm.gf_matmul_plain(mat_t, x),
                                         reps=1, repeats=3),
                     "bound_ms": b_ms, "bound_by": b_by})
    print(f"phase 10: K1 == plain at {len(cases)} repair shapes, "
          f"max_abs_err {worst}")

    # -- phase 11: the rebuild split and K1 per launch ---------------------
    splits = {}
    for st in states:
        sp = repair_split(ecutil, st)
        splits[st["plugin"]] = sp
        s = sp["split_s"]
        print(f"phase 11: {st['plugin']} rebuild of {REPAIR_OBJECTS} "
              f"objects, split: {sp['rebuilt_MBps']:.1f} MB/s rebuilt on "
              f"the host clock ({sp['total_s']:.3f} s: gather "
              f"{s['gather']:.3f}, copy in {s['h2d']:.3f}, K1 {s['k1']:.3f} "
              f"(CUDA events {sp['k1_events_ms'] / 1e3:.4f}), copy back "
              f"{s['d2h']:.3f}, scatter {s['scatter']:.3f} s); "
              f"compiled_repair_streams {sp['pass_MBps'][0]:.1f} MB/s first "
              f"pass (compiles), {sp['pass_MBps'][1]:.1f} MB/s second "
              f"(outputs kept), {sp['dropped_pass_MBps'][0]:.1f} and "
              f"{sp['dropped_pass_MBps'][1]:.1f} MB/s before and after the "
              f"split (outputs dropped); on {name_power}")
        print(f"phase 11: {st['plugin']} pass by cProfile own time: "
              + ", ".join(f"{name} {t:.3f} s"
                          for name, t in sp["profile_top_s"]))
    for row in rows:
        print(f"phase 11: K1 {row['shape']} ({row['r']} x {row['k_in']}, N "
              f"{row['n']}): {row['ms']:.4f} ms on the card "
              f"({row['paced_ms']:.4f} ms launched one after another from "
              f"the host), bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({row['bound_ms'] / row['ms']:.2f} of "
              f"it), plain {row['plain_ms']:.4f} ms on {name_power}")
    return {"launches_repair": launches, "max_abs_err_repair": worst,
            "repair_shapes": rows,
            "repair": {p: {"encode_s": st["encode_s"],
                           "passes_s": st["passes"], **splits[p]}
                       for p, st in zip(splits, states)}}, states[0]


# ---------------------------------------------------------------------------
# The placement tools: phases 12-13; the device guard: phase 14

def run_cli(tool_main, argv: list[str]) -> tuple[str, str, float]:
    """One run of a tool's main(argv): (stdout, stderr, host seconds up
    to a synchronize).  A non-zero exit fails the run."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool_main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), wall


def edited_crushmap(text: str) -> str:
    """The decompiled --build map with the two rules a user appends
    (Ceph's "Editing a CRUSH map": decompile, edit, compile)."""
    if "# rules\n" not in text:
        raise AssertionError("decompiled map has no rules section")
    return text.replace("# rules\n", "# rules\n" + TOOL_RULES)


@contextlib.contextmanager
def k3_events(cb):
    """Within the block, every K3 launch that map_batch makes is bracketed
    by CUDA events; yields the list of (start, end) pairs.  The launch
    itself, and its count, are the wrapper's."""
    pairs = []
    launch = cb.crush_do_rule_cuda

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    cb.crush_do_rule_cuda = timed
    try:
        yield pairs
    finally:
        cb.crush_do_rule_cuda = launch


def events_ms(pairs) -> float:
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs)


def crushtool_phase(name_power: str, dev, work: Path) -> dict:
    """Phase 12: crushtool --build / -d / edit / -c / --test on the card."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import tester as ctest
    from ceph_tpu_torch.crush.compiler import compile_crushmap, decompile
    from ceph_tpu_torch.tools import crushtool

    t_phase = time.monotonic()
    built, text, edited, mapfile = (str(work / n) for n in (
        "built.json", "built.txt", "edited.txt", "map.json"))
    run_cli(crushtool.main, ["--build", "--num-osds", str(N_OSD), "-o", built,
                             "host", "straw2", str(OSDS_PER_HOST),
                             "root", "straw2", "0"])
    run_cli(crushtool.main, ["-d", built, "-o", text])
    Path(edited).write_text(edited_crushmap(Path(text).read_text()))
    run_cli(crushtool.main, ["-c", edited, "-o", mapfile])
    w = crushtool.load(mapfile)
    t2 = decompile(w)
    if t2 != Path(edited).read_text() or decompile(compile_crushmap(t2)) != t2:
        raise AssertionError("crushtool -c / -d is not a fixed point")
    hosts = sum(1 for b in w.crush.buckets
                if b is not None and w.type_map[b.type] == "host")
    if w.crush.max_devices != N_OSD or hosts != N_OSD // OSDS_PER_HOST:
        raise AssertionError(f"--build gave {w.crush.max_devices} OSDs, "
                             f"{hosts} hosts")

    def test_argv(rule: int, nr: int, max_x: int) -> list[str]:
        return ["-i", mapfile, "--test", "--show-statistics",
                "--show-utilization", "--min-x", "0", "--max-x", str(max_x),
                "--rule", str(rule), "--num-rep", str(nr)]

    cb.reset_launches()
    ctest.reset_fallbacks()
    outs, walls, k3_cli = {}, {}, {}
    for rule, nr in TOOL_TESTS:
        with k3_events(cb) as pairs:
            outs[rule], _, walls[rule] = run_cli(
                crushtool.main, test_argv(rule, nr, TOOL_X - 1))
        k3_cli[rule] = events_ms(pairs)
    launches = cb.LAUNCHES["crush_do_rule"]
    fallbacks = ctest.FALLBACKS["batch_unsupported"]
    if launches != len(TOOL_TESTS) or fallbacks:
        raise AssertionError(f"crushtool --test: {launches} K3 launches for "
                             f"{len(TOOL_TESTS)} (rule, num_rep), "
                             f"{fallbacks} through the scalar engine")

    class TablesTester(ctest.CrushTester):
        """The tester's counting and text over tables it is given."""

        def __init__(self, tables, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tables = tables

        def map_all(self, ruleno, numrep, timings=None):
            return self.tables

    flags = {"show_statistics": True, "show_utilization": True}
    cc = cb.compile_map(w.crush, device=dev)
    xs = torch.arange(TOOL_X, device=dev)
    weight = torch.full((N_OSD,), 0x10000, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(SEED + 2)
    rows, worst = {}, 0
    for rule, nr in TOOL_TESTS:
        name = w.rule_name_map[rule]
        if f"rule {rule} ({name}) num_rep {nr} result size == {nr}:\t" \
                f"{TOOL_X}/{TOOL_X}" not in outs[rule]:
            raise AssertionError(f"rule {rule}: not every x maps to {nr}")
        # K3 against the plain version on the card, over every
        # TOOL_PLAIN_STRIDE[rule]-th x of the whole range
        cfg = cc.rule_cfg(rule, nr)
        got, got_n = cb.crush_do_rule_cuda(cc, cfg, xs, weight)
        stride = TOOL_PLAIN_STRIDE[rule]
        n_plain = TOOL_X // stride
        torch.cuda.synchronize()
        t_plain = time.monotonic()
        want, want_n = cb.map_batch_plain(cc, cfg, xs[::stride].contiguous(),
                                          weight, chunk=TOOL_PLAIN_CHUNK)
        torch.cuda.synchronize()
        t_plain = time.monotonic() - t_plain
        err = max(max_err32(got[::stride], want),
                  max_err32(got_n[::stride], want_n))
        worst = max(worst, err)
        if err:
            raise AssertionError(f"rule {rule}: K3 differs from the plain "
                                 f"version over every {stride}th x")
        res, cnt = got.cpu().numpy(), got_n.cpu().numpy()
        if stride == 1:
            # the tool's whole text against the plain version's tables
            plain = TablesTester((want.cpu().numpy(), want_n.cpu().numpy()),
                                 w, 0, TOOL_X - 1, nr, nr, rule, device=dev)
            if plain.test(**flags) != outs[rule]:
                raise AssertionError(f"rule {rule}: crushtool --test text "
                                     "differs from the plain version's")
            held = (f"K3 == plain version on every x (max_abs_err {err}, "
                    f"plain {t_plain:.1f} s) and the text == the plain "
                    "version's")
        else:
            held = (f"K3 == plain version on every {stride}th x, {n_plain} "
                    f"x over 0..{TOOL_X - 1} (max_abs_err {err}, plain "
                    f"{t_plain:.1f} s; cut from {TOOL_X} x to keep the "
                    "smoke's wall time, so no text check against the plain "
                    "version for this rule)")
        t_sample = time.monotonic()
        for x in rng.choice(TOOL_X, TOOL_SAMPLE, replace=False).tolist():
            if res[x, :cnt[x]].tolist() != w.do_rule(rule, x, nr):
                raise AssertionError(f"rule {rule} x {x}: K3 differs from "
                                     "CrushWrapper.do_rule")
        t_sample = time.monotonic() - t_sample
        # the host-clock split, every piece a lap of this one run: the
        # tool's map load, then CrushTester.test with its timings; K3 by
        # CUDA events in the same run
        timings = {}
        with k3_events(cb) as pairs:
            t0 = time.monotonic()
            w_run = crushtool.load(mapfile)
            t_load = time.monotonic() - t0
            text_run = ctest.CrushTester(w_run, 0, TOOL_X - 1, nr, nr, rule,
                                         device=dev).test(**flags,
                                                          timings=timings)
            wall_run = time.monotonic() - t0
        if text_run != outs[rule]:
            raise AssertionError(f"rule {rule}: CrushTester.test differs "
                                 "from the tool's text")
        split = {"load": t_load, **timings}
        k3_ms = events_ms(pairs)
        devices = outs[rule].count("  device ")
        rows[rule] = {"num_rep": nr, "wall_s": walls[rule],
                      "k3_events_ms": k3_cli[rule], "split_wall_s": wall_run,
                      "split_s": split, "split_k3_events_ms": k3_ms,
                      "plain_s": t_plain, "plain_x": n_plain,
                      "plain_stride": stride,
                      "devices_listed": devices}
        print(f"phase 12: crushtool --test rule {rule} ({name}) num_rep {nr} "
              f"x 0..{TOOL_X - 1}: {walls[rule]:.3f} s on the host clock, K3 "
              f"{k3_cli[rule]:.3f} ms by CUDA events in that run "
              f"({k3_cli[rule] / 1e3 / walls[rule]:.4f} of it); {devices} "
              f"devices listed; {held}; {TOOL_SAMPLE} sampled x == "
              f"CrushWrapper.do_rule ({t_sample:.1f} s) on {name_power}")
        print(f"phase 12: split of one more run, each piece a lap of it: "
              f"{wall_run:.3f} s = "
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
              + f", the rest {wall_run - sum(split.values()):.3f} s; K3 "
              f"{k3_ms:.3f} ms by CUDA events")

    # the text against CrushTester on the CPU, at a range the CPU's plain
    # version takes seconds for
    t_cpu = time.monotonic()
    for rule, nr in TOOL_TESTS:
        card_text, _, _ = run_cli(crushtool.main,
                                  test_argv(rule, nr, TOOL_CPU_X - 1))
        if card_text != ctest.CrushTester(w, 0, TOOL_CPU_X - 1, nr, nr, rule,
                                          device="cpu").test(**flags):
            raise AssertionError(f"rule {rule} at {TOOL_CPU_X} x: the text "
                                 "differs from CrushTester on the CPU")
    t_cpu = time.monotonic() - t_cpu
    wall = time.monotonic() - t_phase
    print(f"phase 12: crushtool --build {N_OSD} / -d / -c fixed point; "
          f"--test text == CrushTester(device=\"cpu\")'s at {TOOL_CPU_X} x "
          f"for both rules ({t_cpu:.1f} s); K3 launches {launches}, tester "
          f"fallbacks {fallbacks}; phase {wall:.1f} s")
    return {"launches": launches, "rows": rows, "wall_s": wall,
            "max_abs_err": worst, "mapfile": mapfile}


def parse_upmaps(text: str):
    """`ceph osd pg-upmap-items` lines -> {PG: [(from, to), ...]}; any
    other line fails the run."""
    from ceph_tpu_torch.osd.types import PG
    items = {}
    for line in text.splitlines():
        head = "ceph osd pg-upmap-items "
        if not line.startswith(head):
            raise AssertionError(f"unexpected upmap line {line!r}")
        pgid, *nums = line[len(head):].split()
        pool, ps = pgid.split(".")
        pairs = [int(v) for v in nums]
        items[PG(int(pool), int(ps, 16))] = list(zip(pairs[::2], pairs[1::2]))
    return items


def balancer_phase(name_power: str, dev, work: Path) -> dict:
    """Phase 13: osdmaptool --createsimple / --upmap --test-map-pgs on
    the card at full scale, the split, and card against CPU at 1,000
    OSDs."""
    import random

    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import remap
    from ceph_tpu_torch.osd import balancer as bal
    from ceph_tpu_torch.osd import mapping as om
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.tools import osdmaptool

    t_phase = time.monotonic()
    mapfile, upfile = str(work / "om.json"), str(work / "upmap.txt")
    run_cli(osdmaptool.main, ["--createsimple", str(N_OSD), "--osds-per-host",
                              str(OSDS_PER_HOST), "--pg-num", str(PG_NUM),
                              mapfile])
    cb.reset_launches()
    om.reset_fallbacks()
    with k3_events(cb) as pairs:
        stats_text, err, wall = run_cli(osdmaptool.main, [
            mapfile, "--upmap", upfile, "--upmap-max", str(UPMAP_MAX),
            "--upmap-deviation", str(UPMAP_DEVIATION), "--test-map-pgs"])
    k3_ms = events_ms(pairs)
    launches = cb.LAUNCHES["crush_do_rule"]
    if launches != 2 or om.FALLBACKS["batch_unsupported"]:
        raise AssertionError(f"--upmap --test-map-pgs: {launches} K3 "
                             "launches (want the balancer's update() and "
                             "--test-map-pgs's), scalar-engine pools "
                             f"{om.FALLBACKS['batch_unsupported']}")
    prepared = re.search(r"prepared (\d+)/(\d+) changes", err)
    items = parse_upmaps(Path(upfile).read_text())
    if not prepared or int(prepared.group(1)) != len(items) or not items:
        raise AssertionError(f"balancer output: {err!r}")
    if f"pool 0 pg_num {PG_NUM}" not in stats_text or \
            f" in {N_OSD}" not in stats_text or \
            f"size 3\t{PG_NUM}" not in stats_text:
        raise AssertionError("--test-map-pgs stats are incomplete")

    # the invariants of the balanced map, on the card and the scalar path
    m = osdmaptool.load_map(mapfile)
    inc = Incremental(epoch=m.epoch + 1)
    inc.new_pg_upmap_items.update(items)
    after = m.clone()
    after.apply_incremental(inc)
    mapping = om.OSDMapMapping()
    mapping.update(after)
    parent = remap.build_parent_map(after.crush)
    for pg, pairs in items.items():
        up = mapping.get(pg)
        if up != after.pg_to_up_acting_osds(pg):
            raise AssertionError(f"{pg}: card mapping differs from scalar")
        hosts = {remap.get_parent_of_type(after.crush, o, 1, parent)
                 for o in up[0]}
        if len(up[0]) != 3 or len(hosts) != 3 or \
                any(to not in up[0] for _, to in pairs):
            raise AssertionError(f"{pg}: up {up[0]} after the upmap")
    b = bal.Balancer(max_deviation=UPMAP_DEVIATION,
                     max_iterations=UPMAP_MAX)
    before_score, after_score = b.score(m), b.score(after)
    if not after_score["stddev"] < before_score["stddev"]:
        raise AssertionError(f"stddev {before_score['stddev']} -> "
                             f"{after_score['stddev']}")

    # the host-clock split of one more balancer pass, every piece a lap
    # of that pass: update(), calc_pg_upmaps's own timings (clone,
    # _build_pgs_by_osd, search), apply_incremental, update() again
    total_pgs = m.pools[0].size * m.pools[0].pg_num
    n_in = sum(1 for o in range(m.max_osd) if m.is_in(o))
    ratio = UPMAP_DEVIATION / max(1.0, total_pgs / n_in)
    inc2 = Incremental(epoch=m.epoch + 1)
    laps = {}
    t_pass = time.monotonic()
    mp = om.OSDMapMapping()
    mp.update(m)
    torch.cuda.synchronize()
    split = {"update": time.monotonic() - t_pass}
    n = bal.calc_pg_upmaps(m, ratio, UPMAP_MAX, {0}, inc2,
                           rng=random.Random(0), mapping=mp, timings=laps)
    split.update({k: t1 - t0 for k, (t0, t1) in laps.items()})
    t0 = time.monotonic()
    m.apply_incremental(inc2)
    split["apply_incremental"] = time.monotonic() - t0
    t0 = time.monotonic()
    om.OSDMapMapping().update(m)
    torch.cuda.synchronize()
    split["update_after"] = time.monotonic() - t0
    wall_pass = time.monotonic() - t_pass
    if inc2.new_pg_upmap_items != items or n != len(items):
        raise AssertionError("the split's balancer pass differs from the "
                             "tool's")
    share = k3_ms / 1e3 / wall
    print(f"phase 13: osdmaptool --upmap --test-map-pgs at {N_OSD} OSDs / "
          f"{PG_NUM} PGs: {wall:.3f} s on the host clock; prepared "
          f"{len(items)}/{UPMAP_MAX} changes; every upmapped PG on 3 hosts "
          f"and == scalar pg_to_up_acting_osds; score stddev "
          f"{before_score['stddev']} -> {after_score['stddev']}; K3 "
          f"launches {launches}, {k3_ms:.3f} ms by CUDA events in that run, "
          f"{share:.4f} of its wall, on {name_power}")
    print(f"phase 13: split of one more pass, each piece a lap of it: "
          f"{wall_pass:.3f} s = "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f", the rest {wall_pass - sum(split.values()):.3f} s")

    # card against CPU at 500 OSDs: the same command file, byte for byte
    small = str(work / "om_small.json")
    run_cli(osdmaptool.main, ["--createsimple", str(CROSS_OSD),
                              "--osds-per-host", str(OSDS_PER_HOST),
                              "--pg-num", str(CROSS_PG), small])
    files, cross = {}, {}
    for device in ("cuda", "cpu"):
        out = str(work / f"upmap_{device}.txt")
        _, _, cross[device] = run_cli(osdmaptool.main, [
            small, "--upmap", out, "--upmap-max", str(UPMAP_MAX),
            "--upmap-deviation", str(UPMAP_DEVIATION), "--device", device])
        files[device] = Path(out).read_bytes()
    if files["cuda"] != files["cpu"] or not files["cuda"]:
        raise AssertionError("--upmap on the card and on the CPU differ")
    wall_phase = time.monotonic() - t_phase
    print(f"phase 13: --upmap at {CROSS_OSD} OSDs / {CROSS_PG} PGs: card "
          f"{cross['cuda']:.3f} s, CPU {cross['cpu']:.3f} s, command files "
          f"equal ({len(files['cuda'])} B); phase {wall_phase:.1f} s")
    return {"launches": launches, "wall_s": wall, "split_s": split,
            "split_wall_s": wall_pass, "k3_ms": k3_ms, "k3_share": share, "changes": len(items),
            "stddev": [before_score["stddev"], after_score["stddev"]],
            "cross_s": cross, "phase_s": wall_phase}


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host-clock microseconds per call of `fn` over `calls` calls in a
    row, after a warmup, up to a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def launch_cost(ec, bm, devguard, dev) -> dict:
    """What each layer above K1 costs the host per call, on one staged
    stripe of 4 KiB chunks (the kernel takes microseconds, so the host
    sets the pace): the kernel wrapper, the operator's launch(), the
    plugin's encode_batch with the guard off, and with it on."""
    x = torch.randint(0, 256, (1, K, 4096), dtype=torch.uint8, device=dev)
    op = ec._encode_mm
    cost = {"gf_matmul_cuda": host_us_per_call(
                lambda: bm.gf_matmul_cuda(op.tables, x, M)),
            "operator_launch": host_us_per_call(lambda: op.launch(x)),
            "encode_batch_guard_off": host_us_per_call(
                lambda: ec.encode_batch(x))}
    devguard.enable()
    try:
        cost["encode_batch_guard_on"] = host_us_per_call(
            lambda: ec.encode_batch(x))
    finally:
        devguard.disable()
    return cost


def guard_phase(ec, ecutil, logical: bytes, placement, repair_state,
                mapfile: str, dev, name_power: str) -> dict:
    """Phase 14: phases 5, 8, 10 and 12 once more under the device guard,
    then a deliberate sync inside a region, which must raise."""
    from ceph_tpu_torch.common import devguard
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import mapping as om
    from ceph_tpu_torch.tools import crushtool

    t_phase = time.monotonic()
    cost = launch_cost(ec, bm, devguard, dev)
    devguard.reset()
    devguard.enable()
    bm.reset_launches()
    cb.reset_launches()
    try:
        sinfo = ecutil.StripeInfo(K, K * CHUNK)
        # phase 5's round trip, then one on a fresh plugin, whose decode
        # operator is built inside ecutil's guarded region
        for code in (ec, registry.factory("tpu", {"k": str(K), "m": str(M)})):
            obj = logical if code is ec else logical[:8 * K * CHUNK]
            shards = ecutil.encode(sinfo, code, obj)
            degraded = {i: v for i, v in shards.items() if i not in ERASURES}
            if ecutil.decode_concat(sinfo, code, degraded) != obj:
                raise AssertionError("guarded ECUtil round trip differs")
        mapping = om.OSDMapMapping()
        mapping.update(placement)
        st = repair_state
        for bufs, want in zip(st["bufs"], st["want"]):
            if ecutil.compiled_repair_streams(st["ec"], st["plan"], st["cs"],
                                              bufs)[0] != want:
                raise AssertionError("guarded repair differs")
        # and a fresh plugin instance, whose cache compiles the plan once
        fresh = registry.factory(st["plugin"], dict(REPAIR_CODES[0][1]))
        if ecutil.compiled_repair_streams(fresh, st["plan"], st["cs"],
                                          st["bufs"][0])[0] != st["want"][0]:
            raise AssertionError("guarded repair on a fresh plugin differs")
        run_cli(crushtool.main, ["-i", mapfile, "--test", "--show-statistics",
                                 "--max-x", str(TOOL_GUARD_X - 1), "--rule",
                                 "0", "--num-rep", "3"])
        stats = devguard.stats()
        if any(s["recompiles"] for s in stats.values()) or \
                stats.get("repairc", {}).get("compiles") != 1:
            raise AssertionError(f"devguard compile stats: {stats}")
        launches = {**bm.LAUNCHES, **cb.LAUNCHES}
        if not (launches["gf_matmul"] and launches["crush_do_rule"]):
            raise AssertionError(f"guarded run launched {launches}")
        probe = torch.ones(4, device=dev)
        try:
            with devguard.guard_transfers(dev):
                probe.sum().item()
        except RuntimeError as ex:
            caught = str(ex).splitlines()[0]
        else:
            raise AssertionError(".item() inside guard_transfers() passed")
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError("the sync debug mode was not restored")
    finally:
        devguard.disable()
    wall = time.monotonic() - t_phase
    print(f"phase 14: under devguard: ECUtil round trips ({len(logical)} B "
          f"and a fresh plugin), OSDMapMapping.update(), {len(st['bufs'])} "
          f"compiled repairs of {st['plugin']}, crushtool --test rule 0 at "
          f"{TOOL_GUARD_X} x: no guard error; launches {launches}; compile "
          f"stats {stats}; .item() inside a region raised ({caught!r}); "
          f"phase {wall:.1f} s")
    print("phase 14: host us per call on one staged 8 x 4 KiB stripe: "
          + ", ".join(f"{k} {v:.2f}" for k, v in cost.items())
          + f" on {name_power}")
    return {"launches": launches, "wall_s": wall, "stats": stats,
            "host_us_per_call": cost}


# ---------------------------------------------------------------------------
# The multi-device EC mesh, the fabric and the benchmark CLI: phases 15-17

def mesh_phase(ec, state: dict, name_power: str, dev) -> dict:
    """Phase 15: the one-card mesh (["cuda:0"] * 8) at the main path's
    shapes for shard_ways 1, 2 and 4: parity against encode_batch's and
    the plain version, the decode of [1, 9] at full width, every
    two-erasure pattern at S = MESH_PATTERN_S, K1's launches; then the
    mesh encode beside encode_batch and K1 at the narrowest slice."""
    from ceph_tpu_torch.dist import MeshECCoder, make_mesh
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    t_phase = time.monotonic()
    n = K + M
    data, parity = state["data"], state["parity"]
    full = torch.cat([data, parity], dim=1)
    plain = bm.gf_matmul_plain(ec._encode_mm.mat_t, data)
    di = state["decode_index"]
    data_np = data.cpu().numpy()
    survivors_np = state["survivors"].cpu().numpy()
    small_np = full[:MESH_PATTERN_S].cpu().numpy()
    patterns = list(itertools.combinations(range(n), 2))
    coders, sharded = {}, {}
    calls = 0
    bm.reset_launches()
    for w in MESH_WAYS:
        coder = MeshECCoder(K, M, make_mesh(8, shard_ways=w, k=K,
                                            devices=[dev] * 8),
                            encode_matrix=ec.encode_matrix)
        x = coder.shard_data(data_np)
        out = coder.encode(x)
        calls += 1
        s = STRIPES // coder.mesh.devices.shape[0]
        for i, row in enumerate(out.blocks):
            if not torch.equal(row[0], parity[i * s:(i + 1) * s]) or \
                    not torch.equal(row[0], plain[i * s:(i + 1) * s]):
                raise AssertionError(f"mesh parity differs at shard_ways {w}"
                                     f" stripe row {i}")
        rec = coder.decode(di, ERASURES, coder.shard_data(survivors_np))
        calls += 1
        for i, row in enumerate(rec.blocks):
            if not torch.equal(row[0], full[i * s:(i + 1) * s, ERASURES]):
                raise AssertionError(f"mesh decode of {ERASURES} differs at "
                                     f"shard_ways {w}")
        s = MESH_PATTERN_S // coder.mesh.devices.shape[0]
        for erasures in patterns:
            idx = [i for i in range(n) if i not in erasures][:K]
            rec = coder.decode(idx, list(erasures), coder.shard_data(
                np.ascontiguousarray(small_np[:, idx])))
            calls += 1
            for i, row in enumerate(rec.blocks):
                if not torch.equal(row[0], full[i * s:(i + 1) * s,
                                               list(erasures)]):
                    raise AssertionError(f"mesh decode of {erasures} differs"
                                         f" at shard_ways {w}")
        coders[w], sharded[w] = coder, x
    torch.cuda.synchronize()
    launches = bm.LAUNCHES["gf_matmul"]
    if launches == 0 or launches != 8 * calls or \
            bm.LAUNCHES["gf_decode_select"]:
        raise AssertionError(f"mesh: {launches} K1 launches for {calls} mesh "
                             "steps of 8 positions")
    print(f"phase 15: mesh over ['cuda:0'] * 8, shard_ways {MESH_WAYS}, "
          f"{STRIPES} x 1 MiB: parity == encode_batch == plain, decode of "
          f"{ERASURES} == lost chunks, all {len(patterns)} two-erasure "
          f"patterns at S = {MESH_PATTERN_S} == lost chunks; K1 launches "
          f"{launches} for {calls} mesh steps (8 positions each)")

    mesh_ms = {w: time_ms(lambda c=coders[w], x=sharded[w]: c.encode(x))
               for w in MESH_WAYS}
    batch_ms = time_ms(lambda: ec.encode_batch(data))
    # K1 at the narrowest column slice: shard_ways 4, stripe row 0
    w = max(MESH_WAYS)
    block = sharded[w].blocks[0][0]
    op = coders[w]._op("encode", coders[w].encode_matrix[K:], 0, dev)
    s_n, k_in, n_b = block.shape
    narrow_ms = device_ms(lambda: bm.gf_matmul_cuda(op.tables, block, M))
    narrow_plain_ms = time_ms(lambda: bm.gf_matmul_plain(op.mat_t, block),
                              reps=2, repeats=5)
    err = max_err(bm.gf_matmul_cuda(op.tables, block, M),
                  bm.gf_matmul_plain(op.mat_t, block))
    if err:
        raise AssertionError("K1 differs from plain at the narrow slice")
    narrow_bytes = s_n * (k_in + M) * n_b
    narrow_bound = narrow_bytes / HBM_BYTES_PER_S * 1e3
    wall = time.monotonic() - t_phase
    print(f"phase 15: mesh encode per {STRIPES} x 1 MiB by CUDA events: "
          + ", ".join(f"shard_ways {w} {t:.4f} ms" for w, t in
                      mesh_ms.items())
          + f"; encode_batch (one launch) {batch_ms:.4f} ms; K1 at the "
          f"narrow slice ({s_n}, {k_in}, {n_b}) -> r={M}: {narrow_ms:.4f} ms "
          f"on the card, bound {narrow_bound:.4f} ms by bytes "
          f"({narrow_bound / narrow_ms:.2f} of it), plain "
          f"{narrow_plain_ms:.4f} ms; phase {wall:.1f} s on {name_power}")
    return {"launches_mesh": launches, "mesh_steps": calls,
            "mesh_ms": {str(w): t for w, t in mesh_ms.items()},
            "mesh_encode_batch_ms": batch_ms,
            "narrow_shape": [s_n, k_in, n_b, M], "narrow_ms": narrow_ms,
            "narrow_bound_ms": narrow_bound, "narrow_bound_by": "bytes",
            "narrow_plain_ms": narrow_plain_ms, "max_abs_err_mesh": err,
            "phase_s": wall}


def fabric_phase(ec, ecutil, name_power: str, dev) -> dict:
    """Phase 16: ICIFabric over ["cuda:0"] * 8 with the `tpu` plugin on
    the card: FABRIC_OBJECTS objects of 4 MiB (stripe unit 4096 B); half
    staged first, then 12 threads fetch every shard of those while 2
    threads stage the other half and fetch their shards, as the
    reference's concurrency test does.  Every stream equals ecutil.encode;
    nothing stays staged after release."""
    import threading

    from ceph_tpu_torch.dist import ICIFabric
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    t_phase = time.monotonic()
    n = K + M
    cs = ec.get_chunk_size(K * STRIPE_UNIT)
    sinfo = ecutil.StripeInfo(K, K * cs)
    rng = np.random.default_rng(SEED + 3)
    objs = [rng.integers(0, 256, REPAIR_OBJECT, dtype=np.uint8).tobytes()
            for _ in range(FABRIC_OBJECTS)]
    fab = ICIFabric(devices=[dev] * 8)
    if not fab.supports(ec):
        raise AssertionError("the fabric refuses the tpu plugin")
    stage_s, fetch_s, results, errors = [], [], {}, []
    lock = make_lock("smoke.fabric")

    def stage(i):
        t0 = time.monotonic()
        fab.stage_encode(("obj", i), ec, objs[i], cs)
        with lock:
            stage_s.append(time.monotonic() - t0)

    def fetch(i, shard):
        t0 = time.monotonic()
        out = fab.fetch_chunk(("obj", i), shard)
        with lock:
            fetch_s.append(time.monotonic() - t0)
            results[(i, shard)] = out

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as ex:     # noqa: BLE001 — raised below
            with lock:
                errors.append(ex)

    def fetcher(shard):
        for i in range(FABRIC_OBJECTS // 2):
            guarded(fetch, i, shard)

    def stager(first):
        for i in range(first, FABRIC_OBJECTS, 2):
            guarded(stage, i)
            for shard in range(n):
                guarded(fetch, i, shard)

    bm.reset_launches()
    for i in range(FABRIC_OBJECTS // 2):
        stage(i)
    threads = [threading.Thread(target=fetcher, args=(s,)) for s in range(n)]
    threads += [threading.Thread(target=stager, args=(FABRIC_OBJECTS // 2 + j,))
                for j in range(2)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    concurrent_s = time.monotonic() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("fabric stage/fetch deadlocked")
    if errors:
        raise AssertionError(f"fabric errors: {errors[:3]}")
    launches = bm.LAUNCHES["gf_matmul"]
    t0 = time.monotonic()
    for i, obj in enumerate(objs):
        want = ecutil.encode(sinfo, ec, obj)
        for shard in range(n):
            if results[(i, shard)] != want[shard]:
                raise AssertionError(f"fabric object {i} shard {shard} "
                                     "differs from ecutil.encode")
    check_s = time.monotonic() - t0
    for i in range(FABRIC_OBJECTS):
        fab.release(("obj", i))
    if fab.staged_count() != 0 or fab.stats["staged"] != FABRIC_OBJECTS or \
            fab.stats["fetched"] != FABRIC_OBJECTS * n:
        raise AssertionError(f"fabric stats {fab.stats}, staged "
                             f"{fab.staged_count()}")
    if launches != 8 * FABRIC_OBJECTS:
        raise AssertionError(f"fabric: {launches} K1 launches for "
                             f"{FABRIC_OBJECTS} stages of 8 positions")
    wall = time.monotonic() - t_phase

    def summary(ts):
        return (f"median {statistics.median(ts) * 1e3:.3f} ms, max "
                f"{max(ts) * 1e3:.3f} ms, sum {sum(ts):.3f} s")
    print(f"phase 16: ICIFabric over ['cuda:0'] * 8: {FABRIC_OBJECTS} x "
          f"{REPAIR_OBJECT} B objects (chunk {cs} B), 12 fetch threads + 2 "
          f"stage threads {concurrent_s:.3f} s; every fetched stream == "
          f"ecutil.encode ({check_s:.1f} s); staged_count 0 after release; "
          f"K1 launches {launches}; host clock per stage {summary(stage_s)}; "
          f"per fetch {summary(fetch_s)}; phase {wall:.1f} s on {name_power}")
    return {"launches": launches, "stage_s": stage_s, "fetch_s": fetch_s,
            "concurrent_s": concurrent_s, "phase_s": wall}


def bench_phase(name_power: str) -> dict:
    """Phase 17: the ceph_erasure_code_benchmark CLI on the card for the
    tpu and isa plugins, k=8 m=4, 1 MiB, both workloads; decode runs
    random two-erasure patterns through the CLI's byte gate."""
    from ceph_tpu_torch.tools import ec_bench

    t_phase = time.monotonic()
    rows = {}
    for plugin in ("tpu", "isa"):
        for workload in ("encode", "decode"):
            argv = ["--plugin", plugin, "--workload", workload, "--size",
                    str(OBJECT), "--iterations", str(BENCH_ITERATIONS),
                    "--parameter", f"k={K}", "--parameter", f"m={M}"]
            if workload == "decode":
                argv += ["--erasures", "2"]
            out, _, _ = run_cli(ec_bench.main, argv)
            seconds, kib = out.strip().splitlines()[-1].split("\t")
            seconds = float(seconds)
            mbps = OBJECT * BENCH_ITERATIONS / seconds / 1e6
            rows[f"{plugin}/{workload}"] = {"seconds": seconds, "kib": kib,
                                            "MBps": mbps}
            print(f"phase 17: ec_bench --plugin {plugin} --workload "
                  f"{workload} k={K} m={M} --size {OBJECT} --iterations "
                  f"{BENCH_ITERATIONS}: {seconds:.6f} s\t{kib} KiB, "
                  f"{mbps:.1f} MB/s on {name_power}")
    wall = time.monotonic() - t_phase
    print(f"phase 17: phase {wall:.1f} s")
    return {"rows": rows, "phase_s": wall}


# ---------------------------------------------------------------------------
# The EC placement group's data plane: phase 18

EC_PG_OBJECTS = 16               # 4 MiB objects through ECBackend (cut from 64, 32)
EC_PG_CODE_OBJECTS = 16          # of them through jerasure, clay and lrc
EC_PG_RMW = 16                   # objects given an unaligned overwrite
EC_PG_PATCH = 100 << 10          # 100 KiB
EC_PG_KILLED = [1, 9]
PGID = "1.0"


@contextlib.contextmanager
def k1_events(bm):
    """Within the block, every K1 launch is bracketed by CUDA events;
    yields the list of (start, end) pairs.  The launch itself, and its
    count, are the wrapper's."""
    pairs = []
    launch = bm.gf_matmul_cuda

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    bm.gf_matmul_cuda = timed
    try:
        yield pairs
    finally:
        bm.gf_matmul_cuda = launch


class ECPG:
    """One EC placement group of the port: a MemStore and an ECPGShard per
    shard, wired to the primary's ECBackend (osd.0, shard 0) directly, as
    tests/test_ec_backend.py wires them.  Counts the full-chunk rebuilds
    the backend falls back to."""

    def __init__(self, ec, fabric=None):
        from ceph_tpu_torch import store
        from ceph_tpu_torch.common.perf_counters import PerfCounters
        from ceph_tpu_torch.msg import messages
        from ceph_tpu_torch.osd import ec_backend, pg_types

        self.messages, self.store, self.pg_types = messages, store, pg_types
        self.cid = ec_backend.pg_cid(PGID)
        self.k = ec.get_data_chunk_count()
        self.n = ec.get_chunk_count()
        self.stores = [store.MemStore() for _ in range(self.n)]
        self.shards = [ec_backend.ECPGShard(PGID, s, self.stores[s], self.k,
                                            self.n - self.k, fabric=fabric)
                       for s in range(self.n)]
        self.alive = [True] * self.n
        self.perf = PerfCounters("osd.0")
        for key in ("recovery_bytes_read", "recovery_bytes_rebuilt"):
            self.perf.add_u64_counter(key)
        self.backend = ec_backend.ECBackend(
            PGID, ec, 0, list(range(self.n)), self.shards[0], self._send,
            fabric=fabric)
        self.backend.perf = self.perf
        self.full_rebuilds = 0
        full = self.backend._recover_object_full

        def counted(*args, **kwargs):
            self.full_rebuilds += 1
            return full(*args, **kwargs)

        self.backend._recover_object_full = counted

    def _send(self, shard, msg):
        if not self.alive[shard]:
            return False
        if isinstance(msg, self.messages.ECSubWrite):
            reply = self.shards[shard].handle_sub_write(msg)
            if not self.backend.handle_recovery_write_reply(reply):
                self.backend.handle_sub_write_reply(reply)
        elif isinstance(msg, self.messages.ECSubRead):
            self.backend.handle_sub_read_reply(
                self.shards[shard].handle_sub_read(msg))
        return True

    def write(self, oid: str, off: int, data: bytes) -> None:
        out = []
        self.backend.submit_transaction(oid, [("write", off, data)],
                                        out.append)
        if out != [True]:
            raise AssertionError(f"write of {oid} at {off}: {out}")

    def read(self, oid: str) -> bytes:
        out = {}
        self.backend.objects_read_and_reconstruct(
            {oid: (0, 0)}, lambda r, e: out.update(results=r, errors=e))
        if not out or out["errors"]:
            raise AssertionError(f"read of {oid}: {out.get('errors')}")
        return out["results"][oid]

    def recover(self, oid: str, shard: int) -> None:
        out = []
        self.backend.recover_object(oid, [shard], out.append)
        if out != [True]:
            raise AssertionError(f"recovery of {oid} shard {shard}: {out}")

    def stream(self, shard: int, oid: str) -> bytes:
        return self.stores[shard].read(self.cid,
                                       self.store.ObjectId(oid, shard=shard))

    def kill(self, shard: int, oids) -> None:
        """The shard's OSD is down: peering would mark its objects
        missing."""
        self.alive[shard] = False
        for oid in oids:
            self.backend.peer_missing[shard].add(
                oid, self.pg_types.EVersion(1, 1))

    def revive(self, shard: int) -> None:
        self.alive[shard] = True
        self.backend.peer_missing[shard] = self.pg_types.PGMissing()

    def wipe(self, shard: int, oids) -> None:
        """The shard's chunks are lost (its OSD replaced, the log kept):
        remove them from its store and mark them missing."""
        txn = self.store.Transaction()
        for oid in oids:
            txn.remove(self.cid, self.store.ObjectId(oid, shard=shard))
        self.stores[shard].queue_transaction(txn)
        self.kill(shard, oids)
        self.alive[shard] = True


def write_split(pg: ECPG, oid: str, data: bytes) -> dict:
    """One more 4 MiB write, timed piece by piece on the host clock: the
    merge of old and new bytes, ecutil.encode, the HashInfo crc32c, the
    shard transactions' build, and MemStore applying them (data and log
    transactions of every shard)."""
    from ceph_tpu_torch.osd import ec_backend, ecutil
    from ceph_tpu_torch.store import MemStore

    marks: dict = {}
    apply_s = []
    saved = (ec_backend.ECBackend._encode_write, ecutil.encode,
             ecutil.HashInfo.append, MemStore.queue_transaction)
    enc_write, encode, append, apply = saved

    def t_enc_write(self, op):
        marks["enter"] = time.perf_counter()
        out = enc_write(self, op)
        marks["exit"] = time.perf_counter()
        return out

    def t_encode(*args, **kwargs):
        marks["encode0"] = time.perf_counter()
        out = encode(*args, **kwargs)
        marks["encode1"] = time.perf_counter()
        return out

    def t_append(self, *args, **kwargs):
        marks["crc0"] = time.perf_counter()
        out = append(self, *args, **kwargs)
        marks["crc1"] = time.perf_counter()
        return out

    def t_apply(self, txn):
        t0 = time.perf_counter()
        out = apply(self, txn)
        apply_s.append(time.perf_counter() - t0)
        return out

    ec_backend.ECBackend._encode_write = t_enc_write
    ecutil.encode = t_encode
    ecutil.HashInfo.append = t_append
    MemStore.queue_transaction = t_apply
    try:
        t0 = time.perf_counter()
        pg.write(oid, 0, data)
        total = time.perf_counter() - t0
    finally:
        (ec_backend.ECBackend._encode_write, ecutil.encode,
         ecutil.HashInfo.append, MemStore.queue_transaction) = saved
    split = {"merge": marks["encode0"] - marks["enter"],
             "ecutil.encode": marks["encode1"] - marks["encode0"],
             "hashinfo_crc32c": marks["crc1"] - marks["crc0"],
             "txn_build": marks["exit"] - marks["crc1"],
             "memstore_apply": sum(apply_s)}
    split["other"] = total - (marks["exit"] - marks["enter"]) - sum(apply_s)
    split["total"] = total
    return split


def recover_all(pg: ECPG, ec, objs: dict, bm) -> dict:
    """Phase 18's recovery: shard 0 of every object wiped and rebuilt
    through recover_object.  The signature's program is compiled first
    (its probes run the plugin's own decode, on the card for `tpu`), and
    timed apart; then each rebuild must be one compiled repair (one K1
    launch, one program run) and none a full-chunk rebuild, and the
    rebuilt streams equal those from before the failure.  Returns the
    host time, K1's events time and the read/rebuilt pair."""
    from ceph_tpu_torch.ec.repairc import cache_of, program_for
    from ceph_tpu_torch.osd import ecutil

    before = {oid: pg.stream(0, oid) for oid in objs}
    pg.wipe(0, objs)
    t0 = time.monotonic()
    program_for(ec, ecutil.repair_plan(ec, {0}, set(range(1, pg.n))))
    compile_s = time.monotonic() - t0
    stats = cache_of(ec).stats()
    runs0 = stats["hits"] + sum(stats["compiles"].values())
    launches0 = bm.LAUNCHES["gf_matmul"]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid in objs:
            pg.recover(oid, 0)
        wall = time.monotonic() - t0
    k1 = events_ms(ev)
    stats = cache_of(ec).stats()
    runs = stats["hits"] + sum(stats["compiles"].values()) - runs0
    launches = bm.LAUNCHES["gf_matmul"] - launches0
    if runs != len(objs) or launches != len(objs) or pg.full_rebuilds:
        raise AssertionError(f"recovery: {runs} compiled repairs, {launches} "
                             f"K1 launches, {pg.full_rebuilds} full "
                             f"rebuilds for {len(objs)} objects")
    for oid in objs:
        if pg.stream(0, oid) != before[oid]:
            raise AssertionError(f"rebuilt shard 0 of {oid} differs")
    perf = pg.perf.dump()
    return {"wall_s": wall, "k1_ms": k1, "compile_s": compile_s,
            "read": perf["recovery_bytes_read"],
            "rebuilt": perf["recovery_bytes_rebuilt"],
            "ratio": perf["recovery_bytes_read"] /
            perf["recovery_bytes_rebuilt"]}


def ec_pg_phase(ec, name_power: str, dev) -> dict:
    """Phase 18: the EC placement group's data plane (ECBackend and
    ECPGShard over the port's MemStores) on the card at the pool shape
    `tpu` k=8 m=4 reed_sol_van, stripe unit 4096 B, 4 MiB objects: writes,
    an unaligned overwrite of 16 objects, reads, a degraded read with two
    shards down, shard 0 recovered; the same recovery for REPAIR_r01.json's
    three codes; the writes again through the fabric."""
    from ceph_tpu_torch.dist import ICIFabric
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 18)
    objs = {f"obj{i}": rng.integers(0, 256, REPAIR_OBJECT,
                                    dtype=np.uint8).tobytes()
            for i in range(EC_PG_OBJECTS)}
    logical = len(objs) * REPAIR_OBJECT
    n = K + M
    pg = ECPG(ec)
    sinfo = pg.backend.sinfo
    if sinfo.chunk_size != STRIPE_UNIT:
        raise AssertionError(f"chunk {sinfo.chunk_size} B, want {STRIPE_UNIT}")
    rows = {}

    def row(name, nbytes, wall, k1_ms):
        rows[name] = {"MBps": nbytes / wall / 1e6, "wall_s": wall,
                      "k1_ms": k1_ms, "k1_share": k1_ms / 1e3 / wall}
        return rows[name]

    # -- writes, the overwrite, reads ---------------------------------------
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            pg.write(oid, 0, data)
        wall = time.monotonic() - t0
    row("write", logical, wall, events_ms(ev))
    written = {oid: [pg.stream(s, oid) for s in range(n)] for oid in objs}
    split = write_split(pg, "split", objs["obj0"])
    for i in range(EC_PG_RMW):
        oid = f"obj{i * (EC_PG_OBJECTS // EC_PG_RMW)}"
        off = 1_000_003 + 65_537 * i                 # unaligned to a stripe
        patch = rng.integers(0, 256, EC_PG_PATCH, dtype=np.uint8).tobytes()
        pg.write(oid, off, patch)
        objs[oid] = objs[oid][:off] + patch + objs[oid][off + len(patch):]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            if pg.read(oid) != data:
                raise AssertionError(f"read of {oid} differs")
        wall = time.monotonic() - t0
    row("read", logical, wall, events_ms(ev))
    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M),
                                      "technique": "reed_sol_van"},
                              device="cpu")
    for oid, data in objs.items():
        want = ecutil.encode(sinfo, ec_cpu, data)
        for s in range(n):
            if pg.stream(s, oid) != want[s]:
                raise AssertionError(f"{oid} shard {s} differs from the plain "
                                     "version's encode")
    # -- degraded read --------------------------------------------------------
    for s in EC_PG_KILLED:
        pg.kill(s, objs)
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            if pg.read(oid) != data:
                raise AssertionError(f"degraded read of {oid} differs")
        wall = time.monotonic() - t0
    row("degraded_read", logical, wall, events_ms(ev))
    for s in EC_PG_KILLED:
        pg.revive(s)
    # -- recovery of shard 0, then REPAIR_r01.json's codes --------------------
    rec = {"tpu": recover_all(pg, ec, objs, bm)}
    want_ratio = {"tpu": float(K)}
    write_s = {}
    for plugin, profile, ratio in REPAIR_CODES:
        ec2 = registry.factory(plugin, dict(profile))     # the card
        pg2 = ECPG(ec2)
        t0 = time.monotonic()
        for i, data in enumerate(itertools.islice(objs.values(),
                                                  EC_PG_CODE_OBJECTS)):
            pg2.write(f"obj{i}", 0, data)
        write_s[plugin] = time.monotonic() - t0
        rec[plugin] = recover_all(pg2, ec2, {
            f"obj{i}": None for i in range(EC_PG_CODE_OBJECTS)}, bm)
        want_ratio[plugin] = ratio
        del pg2
    for code, r in rec.items():
        if r["ratio"] != want_ratio[code]:
            raise AssertionError(f"{code}: read/rebuilt {r['read']}/"
                                 f"{r['rebuilt']} = {r['ratio']}, want "
                                 f"{want_ratio[code]}")
        row(f"rebuild_{code}", r["rebuilt"], r["wall_s"], r["k1_ms"])
    # -- the same writes through the fabric -----------------------------------
    fab = ICIFabric(devices=[dev] * 8)
    for osd in range(n):
        fab.register_resident(osd)
    pg3 = ECPG(ec, fabric=fab)
    rng = np.random.default_rng(SEED + 18)        # the first writes' bytes
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid in written:
            pg3.write(oid, 0, rng.integers(0, 256, REPAIR_OBJECT,
                                           dtype=np.uint8).tobytes())
        wall = time.monotonic() - t0
    row("fabric_write", logical, wall, events_ms(ev))
    for oid, streams in written.items():
        for s in range(n):
            if pg3.stream(s, oid) != streams[s]:
                raise AssertionError(f"fabric {oid} shard {s} differs from "
                                     "the host path's")
    if fab.stats["staged"] != len(written) or fab.staged_count():
        raise AssertionError(f"fabric stats {fab.stats}")
    wall = time.monotonic() - t_phase
    for name, r in rows.items():
        print(f"phase 18: {name} {r['MBps']:.1f} MB/s on the host clock "
              f"({r['wall_s']:.3f} s), K1 {r['k1_ms']:.3f} ms by CUDA events "
              f"({r['k1_share'] * 100:.2f} % of it) on {name_power}")
    print("phase 18: split of one 4 MiB write (host s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in split.items()) + f" on {name_power}")
    print(f"phase 18: ECBackend tpu k={K} m={M} stripe unit {STRIPE_UNIT} B: "
          f"{len(objs)} x {REPAIR_OBJECT} B written, {EC_PG_RMW} x "
          f"{EC_PG_PATCH} B unaligned overwrites, every read == the "
          f"script's bytes, every shard stream == the plain version's "
          f"encode; degraded read with shards {EC_PG_KILLED} down == the "
          f"bytes; shard 0 recovered == before the failure, read/rebuilt " +
          ", ".join(f"{c} {r['ratio']}" for c, r in rec.items()) +
          f", one compiled repair per object, 0 full rebuilds; "
          f"repair compiles (apart) " +
          ", ".join(f"{c} {r['compile_s']:.3f}" for c, r in rec.items()) +
          f" s; {', '.join(c for c, _, _ in REPAIR_CODES)} writes of "
          f"{EC_PG_CODE_OBJECTS} objects " +
          ", ".join(f"{v:.1f}" for v in write_s.values()) +
          f" s; fabric chunks == the host path's; phase {wall:.1f} s")
    return {"rows": rows, "split_s": split, "write_s": write_s,
            "ratios": {c: r["ratio"] for c, r in rec.items()},
            "phase_s": wall}


# ---------------------------------------------------------------------------
# The port's cluster: phase 19

CLUSTER_OSDS = 16                # __graft_entry__.py's cluster
CLUSTER_PG_NUM = 32              # osd_pool_default_pg_num (Octopus)
CLUSTER_OBJECTS = 64             # 4 MiB objects through librados
CLUSTER_FABRIC_OBJECTS = 16
CLUSTER_TIMEOUT_S = 300.0
TCP_OBJECTS = 8                  # 20 (a)'s objects, cut from 64, then 16 (PERF.md 4)


def _faults(c, tag: str = "phase 19") -> None:
    """Fail at once on a handler error a dispatch thread logged and
    survived, an OSD the cluster's tick reaped, a queued item that
    raised, a dropped pull or an undecodable purged-snaps cursor: a
    kernel or device fault on the cluster's threads must not show only
    as a stall."""
    if c.network.dispatch_errors:
        raise AssertionError(
            f"{tag}: {c.network.dispatch_errors} dispatch errors, the "
            f"last on {c.network.last_dispatch_error}")
    for osd, exc, tb in getattr(c, "reaped", ()):
        raise AssertionError(f"{tag}: osd.{osd} reaped in tick ({exc}):\n{tb}")
    from ceph_tpu_torch.osd.snap_mapper import PURGED_DECODE_ERRORS

    failed = _perf_sum(c, "queued_op_failures")
    dropped = _perf_sum(c, "recovery_push_errors")
    if failed or dropped or PURGED_DECODE_ERRORS["count"]:
        raise AssertionError(f"{tag}: {failed} failed queued items, "
                             f"{dropped} dropped pulls, "
                             f"{PURGED_DECODE_ERRORS['count']} undecodable "
                             "purged-snaps cursors")


def _cluster_state(c) -> str:
    """The map and peering state a failed wait leaves behind: the mon's
    epoch, down and out OSDs, pg_temp, each OSD's epoch, and the primary
    PGs that are not clean (phase, recovering, backfilling, acting)."""
    from ceph_tpu_torch.osd.peering import CLEAN

    m = c.mon.osdmap
    down = [o for o in range(m.max_osd) if not m.is_up(o)]
    out = [o for o in range(m.max_osd) if not m.is_in(o)]
    epochs = {o: d.osdmap.epoch for o, d in sorted(c.osds.items())}
    dirty = []
    for d in list(c.osds.values()):
        with d._lock:
            for pg, st in d.pgs.items():
                phase = st.peering.phase if st.peering is not None else None
                if st.backend is not None and (
                        phase != CLEAN or st.recovering or st.backfilling):
                    dirty.append(f"{pg}@osd.{d.whoami}:{phase}"
                                 f"{'+rec' if st.recovering else ''}"
                                 f"{'+bf' if st.backfilling else ''}"
                                 f" acting {list(st.acting)}")
    temps = {str(pg): (list(osds), list(m.pg_to_up_acting_osds(pg)[0]))
             for pg, osds in m.pg_temp.items()}
    return (f"mon e{m.epoch}, down {down}, out {out}, pg_temp (pin, up) "
            f"{temps}, OSD epochs {epochs}, {len(dirty)} primaries "
            f"not clean: {sorted(dirty)[:12]}")


def _wait(c, pred, what: str, timeout: float = CLUSTER_TIMEOUT_S,
          tag: str = "phase 19") -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        _faults(c, tag)
        if pred():
            return
        time.sleep(0.01)
    try:
        state = _cluster_state(c)
    except Exception as ex:          # a TCP cluster has no daemons here
        state = f"state unavailable ({type(ex).__name__})"
    raise AssertionError(f"{tag}: {what} within {timeout:.0f} s; {state}")


PROFILE_CMD = {"prefix": "osd erasure-code-profile set", "name": "tpu_k8m4",
               "profile": {"plugin": "tpu", "k": str(K), "m": str(M),
                           "technique": "reed_sol_van",
                           "crush-failure-domain": "host"}}


def _cluster(fabric=None, tcp: bool = False, dev="cuda"):
    """The port's cluster on the card with a k=8 m=4 `tpu` pool: a
    threaded MiniCluster over LocalNetwork, or (tcp) a TcpCluster with
    cephx on and secure mode off, every daemon and the client on its own
    socket.  Returns the cluster, the client and the pool's IoCtx."""
    from ceph_tpu_torch.dryrun import TcpCluster
    from ceph_tpu_torch.testing import MiniCluster

    tag = "phase 20" if tcp else "phase 19"
    if tcp:
        c = TcpCluster(n_osd=CLUSTER_OSDS, device=dev, auth="cephx",
                       op_timeout=CLUSTER_TIMEOUT_S)
        c.wait_all_up()
        r = c.rados
    else:
        c = MiniCluster(n_osd=CLUSTER_OSDS, osds_per_host=1, threaded=True,
                        fabric=fabric)
        c.wait_all_up()
        r = c.rados(timeout=CLUSTER_TIMEOUT_S)
    rc, outs, _ = r.mon_command(PROFILE_CMD)
    if rc != 0:
        raise AssertionError(f"{tag}: profile set: {outs}")
    r.pool_create("ecpool", pg_num=CLUSTER_PG_NUM, pool_type="erasure",
                  erasure_code_profile="tpu_k8m4")
    _wait(c, lambda: _all_clean(c, r), "the new pool's PGs peered", tag=tag)
    return c, r, r.open_ioctx("ecpool")


def _primaries(c, r) -> dict:
    """pg -> the primary daemon's PG state, for every PG of the pool."""
    out = {}
    for d in list(c.osds.values()):
        with d._lock:
            for pg, st in d.pgs.items():
                if st.backend is not None:
                    out[pg] = st
    return out


def _clean_pools(c, r) -> set:
    """The map's pools whose every PG has a primary at the mon's epoch
    whose peering is CLEAN and which neither recovers nor backfills (one
    pass over the OSDs)."""
    from ceph_tpu_torch.osd.peering import CLEAN

    m = c.mon.osdmap
    if not all(d.osdmap.epoch >= m.epoch for d in list(c.osds.values())):
        return set()
    count: dict = {}
    dirty: set = set()
    for pg, st in _primaries(c, r).items():
        count[pg.pool] = count.get(pg.pool, 0) + 1
        if st.peering is None or st.peering.phase != CLEAN or \
                st.recovering or st.backfilling:
            dirty.add(pg.pool)
    return {p for p, pool in m.pools.items()
            if p not in dirty and count.get(p, 0) == pool.pg_num}


def _all_clean(c, r) -> bool:
    return (_clean_pools(c, r) == set(c.mon.osdmap.pools) and
            all(d.pgs_recovering() == 0 for d in list(c.osds.values())))


def _perf_sum(c, key: str) -> int:
    return sum(d.perf.get(key) for d in list(c.osds.values()))


def acting_sets(m, pid: int, pg_num: int, PG) -> tuple[dict, dict]:
    """ps -> acting set, and osd -> the acting sets it is in."""
    before, count = {}, {}
    for ps in range(pg_num):
        before[ps] = list(m.pg_to_up_acting_osds(PG(pid, ps))[2])
        for o in before[ps]:
            if 0 <= o:
                count[o] = count.get(o, 0) + 1
    return before, count


def _victim(count: dict) -> int:
    """The OSD in the most acting sets (the lowest id among equals)."""
    return max(sorted(count), key=lambda o: count[o])


def drive_cluster(c, r, io, objs: dict, tag: str, dev,
                  snapshot: bool = False, healthy=None,
                  degraded=None) -> dict:
    """Writes, reads, the OSD in the most acting sets killed and marked
    down, degraded reads, `osd out` and recovery to clean, reads again;
    K1's launches and CUDA-event share of each leg.  Every read equals
    its payload; read/rebuilt is exactly 8.0 and no rebuild is full.
    With `snapshot`, every shard's bytes before the kill are kept
    (result "shards": (oid, shard) -> bytes).  `healthy()` runs after
    the reads and before the kill, `degraded()` after the degraded
    reads and before `osd out`; their results are returned under the
    same names."""
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.repairc import compiler as repairc_compiler
    from ceph_tpu_torch.osd.types import PG

    logical = len(objs) * REPAIR_OBJECT
    legs = {}

    def leg(name, nbytes, wall, ev, launches0):
        k1 = events_ms(ev)
        legs[name] = {"MBps": nbytes / wall / 1e6, "wall_s": wall,
                      "k1_ms": k1, "k1_share": k1 / 1e3 / wall,
                      "launches": bm.LAUNCHES["gf_matmul"] - launches0}

    def reads(what):
        l0 = bm.LAUNCHES["gf_matmul"]
        with k1_events(bm) as ev:
            t0 = time.monotonic()
            for oid, data in objs.items():
                if io.read(oid) != data:
                    raise AssertionError(f"{tag}: {what} read of {oid} "
                                         "differs")
            wall = time.monotonic() - t0
        leg(what, logical, wall, ev, l0)

    if any(d.device.type != torch.device(dev).type
           for d in c.osds.values()):
        raise AssertionError(f"{tag}: an OSD is not on the card")
    l0 = bm.LAUNCHES["gf_matmul"]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            io.write_full(oid, data)
        wall = time.monotonic() - t0
    leg("write", logical, wall, ev, l0)
    reads("read")
    extra = {"healthy": healthy() if healthy else None}
    # -- the OSD in the most acting sets dies ------------------------------
    pid = r.pool_lookup("ecpool")
    before, count = acting_sets(c.mon.osdmap, pid, CLUSTER_PG_NUM, PG)
    victim = _victim(count)
    shards = {}
    if snapshot:
        res = {"pid": pid, "victim": -1, "before": before}
        shards = {(oid, s): got for oid, s, _osd, got, _was, _pg
                  in _shards_on_acting(c, objs, res, tag)}
    c.kill_osd(victim)
    rc, outs, _ = r.mon_command({"prefix": "osd down", "ids": [victim]})
    if rc != 0:
        raise AssertionError(f"{tag}: osd down: {outs}")
    _wait(c, lambda: r.objecter.osdmap.is_down(victim) and
          _all_clean(c, r), "peering after osd down", tag=tag)
    reads("degraded_read")
    extra["degraded"] = degraded() if degraded else None
    # -- out: EC peering rebuilds the lost shards ----------------------------
    read0 = _perf_sum(c, "recovery_bytes_read")
    rebuilt0 = _perf_sum(c, "recovery_bytes_rebuilt")
    l0 = bm.LAUNCHES["gf_matmul"]
    comp0 = dict(repairc_compiler.COMPILES)
    pools = {name: pid_ for pid_, name in c.mon.osdmap.pool_names.items()}
    clean_s: dict = {}

    def out_clean() -> bool:
        # each pool's own time to clean, then the whole cluster's
        if not c.mon.osdmap.is_out(victim):
            return False
        clean = _clean_pools(c, r)
        for name, pid_ in pools.items():
            if name not in clean_s and pid_ in clean:
                clean_s[name] = time.monotonic() - t0
        return len(clean_s) == len(pools) and _all_clean(c, r)

    with k1_events(bm) as ev:
        t0 = time.monotonic()
        rc, outs, _ = r.mon_command({"prefix": "osd out", "ids": [victim]})
        if rc != 0:
            raise AssertionError(f"{tag}: osd out: {outs}")
        _wait(c, out_clean, "recovery to clean", tag=tag)
        recover_s = time.monotonic() - t0
    compiles = {key: repairc_compiler.COMPILES[key] - comp0[key]
                for key in comp0}
    rebuilt = _perf_sum(c, "recovery_bytes_rebuilt") - rebuilt0
    read = _perf_sum(c, "recovery_bytes_read") - read0
    leg("recovery", rebuilt, recover_s, ev, l0)
    reads("read_after_clean")
    _faults(c, tag)
    full = _perf_sum(c, "recovery_full_rebuild")
    if not rebuilt or read / rebuilt != float(K) or full:
        raise AssertionError(
            f"{tag}: recovery read {read} B / rebuilt {rebuilt} B, "
            f"{full} full rebuilds")
    return {"legs": legs, "victim": victim, "count": count,
            "before": before, "shards": shards, "pid": pid,
            "recover_s": recover_s, "clean_s": clean_s, "rebuilt": rebuilt,
            "read": read, "compiles": compiles, **extra}


def _shards_on_acting(c, objs: dict, res: dict, tag: str):
    """Yield (oid, shard, osd, stored bytes, the OSD that held the shard
    before the kill) for every shard of every object on its acting OSD
    now; fail if an object still maps to the dead OSD."""
    from ceph_tpu_torch.osd import ec_backend
    from ceph_tpu_torch.store import ObjectId

    m, pid, victim = c.mon.osdmap, res["pid"], res["victim"]
    for oid in objs:
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        acting = m.pg_to_up_acting_osds(raw)[2]
        if victim in acting:
            raise AssertionError(f"{tag}: {oid} still maps to the dead "
                                 f"osd.{victim}")
        for s, osd in enumerate(acting):
            got = c.osds[osd].store.read(ec_backend.pg_cid(pg),
                                         ObjectId(oid, shard=s))
            yield oid, s, osd, got, res["before"][pg.ps][s], pg

# -- phase 19 (d): the paged artifact store; (e): the scheduled scrub -------

SERVE_SHARDS = 4                 # checkpoint shards of 8 MiB: 32 MiB
SERVE_SHARD_B = 8 << 20          # cut from 64, 32, 16 MiB (the smoke's wall)
SERVE_RAGGED = 4097              # the last shard's missing tail
SERVE_KV_PAGES = 1024            # KV pool of 64 KiB pages
SERVE_WAVES = 4                  # page waves per half, cut from 32, then 8
SERVE_WAVE_PAGES = 64            # seeded random page ids per wave
SCRUB_INTERVAL_S = 300.0         # both scrub intervals in (e), sim clock
SCRUB_STEP_S = 5.0               # sim seconds per tick
SCRUB_T0 = 10_000.0
SCRUB_MAX_TICKS = 200


def serve_data(seed: int):
    """The checkpoint's shards (the last ragged), the KV pool's pages
    (kept as sha256) and the page waves."""
    rng = np.random.default_rng(seed)
    ckpt = {f"shard{i}": rng.bytes(SERVE_SHARD_B - (
        SERVE_RAGGED if i == SERVE_SHARDS - 1 else 0))
        for i in range(SERVE_SHARDS)}
    kv = [rng.bytes(1 << 16) for _ in range(SERVE_KV_PAGES)]
    waves = [rng.integers(0, SERVE_KV_PAGES, SERVE_WAVE_PAGES).tolist()
             for _ in range(SERVE_WAVES)]
    return ckpt, kv, waves


def serve_half(store, ckpt: dict, kv_sums: list, waves: list,
               half: str) -> dict:
    """Stream every checkpoint shard under `checkpoint`, then the page
    waves through a fresh `kvcache` handle; every byte is held to what
    was put (pages by sha256).  Host clock; K1 by CUDA events."""
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    l0 = bm.LAUNCHES["gf_matmul"]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        h = store.open("ckpt", policy="checkpoint")
        for name, blob in ckpt.items():
            if h.read_shard(name) != blob:
                raise AssertionError(f"phase 19 (d): {half} stream of "
                                     f"{name} differs")
        stream_s = time.monotonic() - t0
        stream_stats = dict(h.stats)
        h.close()
        h = store.open("kv", policy="kvcache")
        lat = []
        for ids in waves:
            t1 = time.monotonic()
            pages = h.get_pages("kv", ids)
            lat.append(time.monotonic() - t1)
            for pid, blob in zip(ids, pages):
                if hashlib.sha256(blob).digest() != kv_sums[pid]:
                    raise AssertionError(f"phase 19 (d): {half} page "
                                         f"{pid} differs")
        kv_stats = dict(h.stats)
        h.close()
        wall = time.monotonic() - t0
    k1 = events_ms(ev)
    lat.sort()
    return {"stream_MBps": sum(map(len, ckpt.values())) / stream_s / 1e6,
            "stream_s": stream_s, "stream_stats": stream_stats,
            "wave_p50_ms": statistics.median(lat) * 1e3,
            "wave_p99_ms": lat[-(-len(lat) * 99 // 100) - 1] * 1e3,
            "kv_stats": kv_stats, "wall_s": wall, "k1_ms": k1,
            "k1_share": k1 / 1e3 / wall,
            "launches": bm.LAUNCHES["gf_matmul"] - l0}


class ServeLeg:
    """Phase 19 (d) on the cluster's pool: an ArtifactStore with its
    default layout (64 KiB pages, 1 MiB objects) holding a 32 MiB
    checkpoint of 4 shards and a 1,024-page KV pool; `healthy` puts and
    reads them, `degraded` (the victim down) reads them again and
    deletes both artifacts, so recovery rebuilds what it did before."""

    def __init__(self, io):
        from ceph_tpu_torch.serve import ArtifactStore

        self.store = ArtifactStore(io)
        self.ckpt, self.kv, self.waves = serve_data(SEED + 191)
        self.kv_sums = [hashlib.sha256(p).digest() for p in self.kv]
        self.out: dict = {}

    def healthy(self) -> None:
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm

        l0 = bm.LAUNCHES["gf_matmul"]
        with k1_events(bm) as ev:
            t0 = time.monotonic()
            m = self.store.put("ckpt", shards=self.ckpt)
            self.store.put("kv", pages={"kv": self.kv})
            wall = time.monotonic() - t0
        nbytes = sum(map(len, self.ckpt.values())) + sum(map(len, self.kv))
        k1 = events_ms(ev)
        self.out["write"] = {
            "MBps": nbytes / wall / 1e6, "wall_s": wall, "k1_ms": k1,
            "k1_share": k1 / 1e3 / wall,
            "launches": bm.LAUNCHES["gf_matmul"] - l0,
            "objects": len(m.data_oids()) + len(
                self.store.manifest("kv").data_oids())}
        self.out["healthy"] = serve_half(self.store, self.ckpt,
                                         self.kv_sums, self.waves, "healthy")

    def degraded(self) -> None:
        self.out["degraded"] = serve_half(self.store, self.ckpt,
                                          self.kv_sums, self.waves,
                                          "degraded")
        if not self.out["degraded"]["launches"]:
            raise AssertionError("phase 19 (d): the degraded reads "
                                 "launched no K1 decode")
        self.out["deleted"] = (self.store.delete("ckpt") +
                               self.store.delete("kv"))


def _scrubbing(c) -> bool:
    for d in list(c.osds.values()):
        with d._lock:
            if any(st.scrub is not None or st.scrub_reserving is not None
                   for st in d.pgs.values()):
                return True
    return False


def scrub_leg(c, r, objs: dict) -> dict:
    """Phase 19 (e): bitrot under one OSD's MemStore, then the heartbeat
    tick on a sim clock with both scrub intervals cut to
    SCRUB_INTERVAL_S, and no pg_scrub call: the scheduled deep scrub
    finds the shard, repairs it on K1 and verifies it; every scrub
    result is recorded as the primary logs it."""
    from ceph_tpu_torch.common.options import global_config
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.repairc import compiler as repairc_compiler
    from ceph_tpu_torch.osd import ec_backend, ecutil
    from ceph_tpu_torch.store import ObjectId, Transaction

    tag = "phase 19 (e)"
    cfg = global_config()
    pid = r.pool_lookup("ecpool")
    m = c.mon.osdmap
    oid = next(iter(objs))
    raw = m.object_locator_to_pg(oid, pid)
    pg = m.pools[pid].raw_pg_to_pg(raw)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    shard = next(s for s in range(K) if acting[s] != primary)
    cid, soid = ec_backend.pg_cid(pg), ObjectId(oid, shard=shard)
    mstore = c.osds[acting[shard]].store
    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M),
                                      "technique": "reed_sol_van"},
                              device="cpu")
    want = ecutil.encode(ecutil.StripeInfo(K, K * STRIPE_UNIT), ec_cpu,
                         objs[oid])[shard]
    if mstore.read(cid, soid) != want:
        raise AssertionError(f"{tag}: {oid} shard {shard} before the rot")
    mstore.queue_transaction(Transaction().write(cid, soid, 0, b"BITROT!!"))
    saved = {k: cfg[k] for k in ("osd_scrub_min_interval",
                                 "osd_deep_scrub_interval")}
    results: list = []
    for d in c.osds.values():
        def record(pg_, result, d=d, orig=d.clog_scrub_result):
            results.append((d.whoami, pg_, dict(result)))
            orig(pg_, result)
        d.clog_scrub_result = record
    # both intervals through the mon's centralized config: committed,
    # pushed to every OSD as MConfig and applied there
    keys = ("osd_scrub_min_interval", "osd_deep_scrub_interval")
    t_cfg = time.monotonic()
    for k in keys:
        rc, outs, _ = r.mon_command({"prefix": "config set", "who": "osd",
                                     "name": k,
                                     "value": str(SCRUB_INTERVAL_S)})
        if rc != 0:
            raise AssertionError(f"{tag}: config set osd {k}: {outs}")
    _wait(c, lambda: all(set(keys) <= d._mon_config_keys
                         for d in c.osds.values()),
          "every OSD applied the scrub intervals", tag=tag)
    cfg_s = time.monotonic() - t_cfg
    got = {(o, k): c.mon.handle_command({"prefix": "config get",
                                         "who": f"osd.{o}", "name": k})
           for o in c.osds for k in keys}
    if any(v != (0, "", str(SCRUB_INTERVAL_S)) for v in got.values()) or \
            any(cfg[k] != SCRUB_INTERVAL_S for k in keys):
        raise AssertionError(f"{tag}: config get {got}")
    l0 = bm.LAUNCHES["gf_matmul"]
    comp0 = dict(repairc_compiler.COMPILES)
    now, found, logged = SCRUB_T0, None, None
    want_line = f"pg {pg} scrub: 1 inconsistent, 1 repaired and re-verified"

    def scrub_lines():
        entries = c.mon.handle_command({"prefix": "log last", "num": 50,
                                        "level": "warn"})[2]
        return [e for e in entries if " scrub: " in e["text"]]
    try:
        with k1_events(bm) as ev:
            t0 = time.monotonic()
            for ticks in range(1, SCRUB_MAX_TICKS + 1):
                c.tick(now)
                now += SCRUB_STEP_S
                time.sleep(0.01)        # ping replies land in sim time
                _wait(c, lambda: not _scrubbing(c), "scrubs settled",
                      tag=tag)
                if found is None:
                    found = next((res for _o, pg_, res in results
                                  if pg_ == pg and res["inconsistent"]),
                                 None)
                # the primary's clog line goes out on its next tick
                if found is not None and any(e["text"] == want_line
                                             for e in scrub_lines()):
                    logged = scrub_lines()
                    break
            wall = time.monotonic() - t0
    finally:
        for k in keys:
            c.mon.handle_command({"prefix": "config rm", "who": "osd",
                                  "name": k})
        for d in c.osds.values():
            d.__dict__.pop("clog_scrub_result", None)
    _wait(c, lambda: not any(set(keys) & d._mon_config_keys
                             for d in c.osds.values()),
          "every OSD dropped the scrub intervals", tag=tag)
    if any(cfg[k] != saved[k] for k in keys):
        raise AssertionError(f"{tag}: after config rm {[cfg[k] for k in keys]}"
                             f" != the defaults {saved}")
    if logged is None or [(e["name"], e["level"], e["text"])
                          for e in logged] != [(f"osd.{primary}", "warn",
                                                want_line)]:
        raise AssertionError(f"{tag}: log last 50 warn holds the scrub "
                             f"lines {logged}, not osd.{primary}'s "
                             f"{want_line!r} alone")
    k1 = events_ms(ev)
    launches = bm.LAUNCHES["gf_matmul"] - l0
    probes = repairc_compiler.COMPILES["probe_launches"] - \
        comp0["probe_launches"]
    repaired = mstore.read(cid, soid)
    if found != {"inconsistent": [oid], "repaired": 1, "unrepairable": [],
                 "verified": True}:
        raise AssertionError(f"{tag}: the scheduled scrub of pg {pg} gave "
                             f"{found} in {SCRUB_MAX_TICKS} ticks")
    if repaired != want or hashlib.sha256(repaired).digest() != \
            hashlib.sha256(want).digest():
        raise AssertionError(f"{tag}: {oid} shard {shard} after the repair "
                             "differs from the plain encode")
    others = [res for _o, pg_, res in results if pg_ != pg]
    bad = [res for res in others
           if res["inconsistent"] or res["unrepairable"]]
    limit = cfg["osd_max_scrubs"]
    peak_local = max(d.scrub_peak_local for d in c.osds.values())
    peak_remote = max(d.scrub_peak_remote for d in c.osds.values())
    if bad or peak_local > limit or peak_remote > limit or not launches:
        raise AssertionError(f"{tag}: other results {bad}, peaks "
                             f"{peak_local}/{peak_remote} (max {limit}), "
                             f"K1 {launches}")
    down = [o for o in c.osds if not c.mon.osdmap.is_up(o)]
    if down:
        raise AssertionError(f"{tag}: osds {down} marked down by the "
                             "sim-clock ticks")
    _faults(c, tag)
    return {"ticks": ticks, "sim_s": ticks * SCRUB_STEP_S, "wall_s": wall,
            "scrubs": len(results), "result": found,
            "unrepairable": sorted({o for _d, _p, res in results
                                    for o in res["unrepairable"]}),
            "peak_local": peak_local, "peak_remote": peak_remote,
            "limit": limit, "launches": launches, "probe_launches": probes,
            "k1_ms": k1, "pg": str(pg), "primary": primary,
            "rot_osd": acting[shard], "shard": shard, "config_s": cfg_s,
            "config_osds": len(c.osds), "log_line": logged[0]["text"]}


# -- phase 19 (f): the replicated pool beside the EC pool ---------------------

REP_PG_NUM = 32                  # osd_pool_default_pg_num (Octopus)
REP_SIZE, REP_MIN_SIZE = 3, 2    # osd_pool_default_size / _min_size
REP_OBJECTS = 64                 # 4 MiB objects, each one WriteOp
REP_DOWN_OBJECTS = 16            # written while the victim is down
REP_INDEX_OBJECTS = 16           # bucket-index-like omap objects
REP_INDEX_KEYS = 1024            # 32-byte keys, 64-byte values
REP_STRIPED_B = 16 << 20         # one RadosStriper object


def _rep_xattrs(i: int) -> dict:
    return {"owner": b"chip_smoke", "seq": str(i).encode()}


def _digest(data: bytes, attrs: dict, omap: dict, hdr: bytes) -> str:
    """sha256 over an object's data, user xattrs, omap and omap header."""
    h = hashlib.sha256(data)
    for part in (attrs, omap):
        for k in sorted(part):
            h.update(k.encode() + b"\0" + bytes(part[k]) + b"\0")
        h.update(b"\1")
    h.update(hdr)
    return h.hexdigest()


class RepLeg:
    """Phase 19 (f): `reppool` (replicated, pg_num 32, size 3, min_size 2)
    on phase 19's cluster beside `ecpool`.  `create` and `healthy` run
    after (e); `degraded` while the victim is down; `verify` after the
    recovery that `osd out` starts; `scrub` last."""

    def __init__(self, c, r, ec_objs: dict):
        from ceph_tpu_torch.osdc.striper import StripeLayout

        self.c, self.r, self.ec_objs = c, r, ec_objs
        rng = np.random.default_rng(SEED + 196)
        self.objs = {f"rep{i}": rng.bytes(REPAIR_OBJECT)
                     for i in range(REP_OBJECTS + REP_DOWN_OBJECTS)}
        self.index = {f"index{i}": {rng.bytes(16).hex(): rng.bytes(64)
                                    for _ in range(REP_INDEX_KEYS)}
                      for i in range(REP_INDEX_OBJECTS)}
        self.striped = rng.bytes(REP_STRIPED_B)
        self.ec_writeop = rng.bytes(REPAIR_OBJECT)
        #: each head's user xattrs; the snapshot leg changes some heads
        #: and removes one (`removed`)
        self.attrs = {name: _rep_xattrs(int(name[3:])) for name in self.objs}
        self.removed: set = set()
        self.layout = StripeLayout(stripe_unit=1 << 16, stripe_count=4,
                                   object_size=1 << 18)
        self.out: dict = {}

    def _perf(self) -> dict:
        # recovery_push counts the pushes primaries send (backfill ones
        # too); every other push applied answers a pull
        return {k: _perf_sum(self.c, k) for k in (
            "recovery_push", "push_in", "push_in_bytes",
            "push_in_clone_bytes", "backfill_push_in",
            "recovery_push_errors")}

    def create(self) -> None:
        t0 = time.monotonic()
        self.r.pool_create("reppool", pg_num=REP_PG_NUM)
        # the rbd leg's mirror and migration target
        self.r.pool_create("rbdbak", pg_num=RBD_BAK_PG_NUM)
        self.pid = self.r.pool_lookup("reppool")
        pool = self.c.mon.osdmap.pools[self.pid]
        if (pool.type, pool.size, pool.min_size) != (1, REP_SIZE,
                                                      REP_MIN_SIZE):
            raise AssertionError(f"phase 19 (f): reppool is type {pool.type} "
                                 f"size {pool.size}/{pool.min_size}")
        _wait(self.c, lambda: _all_clean(self.c, self.r),
              "reppool's and rbdbak's PGs peered", tag="phase 19 (f)")
        self.io = self.r.open_ioctx("reppool")
        self.out["create_s"] = time.monotonic() - t0

    def _write(self, names) -> float:
        from ceph_tpu_torch.client import WriteOp

        t0 = time.monotonic()
        for name in names:
            op = WriteOp().write_full(self.objs[name])
            for k, v in self.attrs[name].items():
                op.set_xattr(k, v)
            self.io.operate(name, op)
        return time.monotonic() - t0

    def _read_all(self, names, what: str) -> float:
        t0 = time.monotonic()
        for name in names:
            if self.io.read(name) != self.objs[name]:
                raise AssertionError(f"phase 19 (f): {what} read of {name} "
                                     "differs")
        return time.monotonic() - t0

    def healthy(self) -> None:
        from ceph_tpu_torch.client import WriteOp
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.osdc.rados_striper import RadosStriper
        from ceph_tpu_torch.osdc.striper import Striper

        tag = "phase 19 (f)"
        self.create()
        names = [f"rep{i}" for i in range(REP_OBJECTS)]
        wall = self._write(names)
        self.out["write"] = {"MBps": len(names) * REPAIR_OBJECT / wall / 1e6,
                             "wall_s": wall}
        t0 = time.monotonic()
        for name, kv in self.index.items():
            self.io.operate(name, WriteOp().create().set_omap(kv)
                            .set_omap_header(name.encode()))
        self.out["index_s"] = time.monotonic() - t0
        self.striper = RadosStriper(self.io, self.layout)
        t0 = time.monotonic()
        self.striper.write("striped", self.striped)
        self.out["striper_write_s"] = time.monotonic() - t0
        self.striped_objs = sorted(
            {f"striped.{n:016x}" for n in {0} | {
                e.objectno for e in Striper.file_to_extents(
                    self.layout, 0, REP_STRIPED_B)}})
        # the EC pool's compound op: data plus an xattr, one K1 encode
        ec_io = self.r.open_ioctx("ecpool")
        l0 = bm.LAUNCHES["gf_matmul"]
        ec_io.operate("ec_writeop", WriteOp().write_full(self.ec_writeop)
                      .set_xattr("kind", b"writeop"))
        self.out["ec_writeop_launches"] = bm.LAUNCHES["gf_matmul"] - l0
        if not self.out["ec_writeop_launches"] or \
                ec_io.read("ec_writeop") != self.ec_writeop or \
                ec_io.get_xattr("ec_writeop", "kind") != b"writeop":
            raise AssertionError(f"{tag}: the EC WriteOp ({self.out}) ")
        # listing: exactly what was written, in both pools
        want_rep = sorted(names + list(self.index) + self.striped_objs)
        want_ec = sorted(list(self.ec_objs) + ["ec_writeop"])
        t0 = time.monotonic()
        got_rep, got_ec = self.io.list_objects(), ec_io.list_objects()
        self.out["list_s"] = time.monotonic() - t0
        if got_rep != want_rep or got_ec != want_ec:
            raise AssertionError(f"{tag}: list_objects gave {len(got_rep)} / "
                                 f"{len(got_ec)} objects, not {len(want_rep)} "
                                 f"/ {len(want_ec)}")
        wall = self._read_all(names, "healthy")
        self.out["read"] = {"MBps": len(names) * REPAIR_OBJECT / wall / 1e6,
                            "wall_s": wall}
        if self.striper.read("striped") != self.striped:
            raise AssertionError(f"{tag}: striped read differs")
        if self.striper.swallowed:
            raise AssertionError(f"{tag}: the striper swallowed "
                                 f"{self.striper.swallowed} errors")

    def degraded(self) -> None:
        tag = "phase 19 (f)"
        names = [f"rep{i}" for i in range(REP_OBJECTS)
                 if f"rep{i}" not in self.removed]
        wall = self._read_all(names, "degraded")
        self.out["degraded_read"] = {
            "MBps": len(names) * REPAIR_OBJECT / wall / 1e6, "wall_s": wall}
        for name, kv in self.index.items():
            if self.io.get_omap_vals(name) != (kv, False) or \
                    self.io.get_omap_header(name) != name.encode():
                raise AssertionError(f"{tag}: degraded omap of {name}")
        if self.striper.read("striped") != self.striped:
            raise AssertionError(f"{tag}: degraded striped read differs")
        down = [f"rep{i}" for i in range(REP_OBJECTS,
                                         REP_OBJECTS + REP_DOWN_OBJECTS)]
        wall = self._write(down)
        self.out["down_write"] = {
            "MBps": len(down) * REPAIR_OBJECT / wall / 1e6, "wall_s": wall}
        self.perf0 = self._perf()

    def _replicas(self, oid: str):
        """(osd, digest) of every acting replica of `oid`."""
        m = self.c.mon.osdmap
        raw = m.object_locator_to_pg(oid, self.pid)
        pg = m.pools[self.pid].raw_pg_to_pg(raw)
        acting = m.pg_to_up_acting_osds(raw)[2]
        if len(acting) != REP_SIZE:
            raise AssertionError(f"phase 19 (f): {oid} acting {acting}")
        for osd in acting:
            d = self.c.osds[osd]
            with d._lock:
                yield osd, _digest(*d.pgs[pg].shard.push_payload(oid))

    def verify(self, victim: int) -> None:
        """After recovery to clean: every replica on its acting OSDs
        equals its payload, xattrs and omap (by sha256)."""
        tag = "phase 19 (f)"
        t0 = time.monotonic()
        perf = self._perf()
        self.out["recovery"] = {k: perf[k] - self.perf0[k] for k in perf}
        want = {name: _digest(data, self.attrs[name], {}, b"")
                for name, data in self.objs.items()
                if name not in self.removed}
        want.update({name: _digest(b"", {}, kv, name.encode())
                     for name, kv in self.index.items()})
        for name in self.striped_objs:
            want[name] = _digest(self.io.read(name),
                                 self.io.get_xattrs(name), {}, b"")
        checked = 0
        for oid, digest in want.items():
            for osd, got in self._replicas(oid):
                if osd == victim or got != digest:
                    raise AssertionError(f"{tag}: {oid} on osd.{osd} differs "
                                         "from its payload, xattrs and omap")
                checked += 1
        if self.striper.read("striped") != self.striped:
            raise AssertionError(f"{tag}: striped read after recovery")
        rec = self.out["recovery"]
        if not rec["push_in"] or rec["recovery_push_errors"]:
            raise AssertionError(f"{tag}: recovery pushes {rec}")
        self.out["replicas_checked"] = checked
        self.out["verify_s"] = time.monotonic() - t0

    def scrub(self) -> None:
        """Flip one byte of one replica under its MemStore; the scrub
        lists it, the repair repairs and verifies it, a third scrub is
        clean."""
        from ceph_tpu_torch.osd import ec_backend
        from ceph_tpu_torch.store import ObjectId, Transaction

        tag = "phase 19 (f)"
        oid = "rep0"
        m = self.c.mon.osdmap
        raw = m.object_locator_to_pg(oid, self.pid)
        pg = m.pools[self.pid].raw_pg_to_pg(raw)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        replica = next(o for o in acting if o != primary)
        store = self.c.osds[replica].store
        cid = ec_backend.pg_cid(pg)
        byte = store.read(cid, ObjectId(oid), 4096, 1)
        store.queue_transaction(Transaction().write(
            cid, ObjectId(oid), 4096, bytes([byte[0] ^ 0x5A])))
        want = [{"inconsistent": [oid], "repaired": 0, "unrepairable": []},
                {"inconsistent": [oid], "repaired": 1, "unrepairable": [],
                 "verified": True},
                {"inconsistent": [], "repaired": 0, "unrepairable": []}]
        self.out["scrubs"] = []
        for repair, expect in zip((False, True, False), want):
            t0 = time.monotonic()
            got = self.r.pg_scrub(self.pid, pg.ps, repair=repair)
            self.out["scrubs"].append({"repair": repair, "result": got,
                                       "wall_s": time.monotonic() - t0})
            if got != expect:
                raise AssertionError(f"{tag}: pg_scrub(repair={repair}) of pg "
                                     f"{pg} gave {got}, not {expect}")
        if dict(self._replicas(oid))[replica] != _digest(
                self.objs[oid], self.attrs[oid], {}, b""):
            raise AssertionError(f"{tag}: the repaired replica differs")
        self.out["scrub_pg"] = (str(pg), primary, replica)


# -- phase 19 (f): snapshots, object classes and watch/notify ----------------

SNAP_OVERWRITES = 16             # reppool objects overwritten under s19
WATCH_CLIENTS = 4                # extra librados clients, each on 4 objects
WATCH_NOTIFIES = 64              # timed notifies, every reply collected
WATCH_TIMEOUT_S = 2.0            # the dead watcher's notify
CLS_AIO_ADDS = 16                # concurrent numops adds on one key
CLS_LOG_ENTRIES = 1024           # cls log entries added, listed and trimmed
CLS_LOG_PAGE = 128               # entries per list / trim call
TRIM_MAX_TICKS = 60              # sim-clock ticks the trim may take


def _sha(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _errno(fn, *args, **kw) -> str:
    """The RadosError errno name `fn` raised, or "ok"."""
    from ceph_tpu_torch.client import RadosError

    try:
        fn(*args, **kw)
    except RadosError as e:
        return e.errno_name
    return "ok"


class SnapLeg:
    """Phase 19 (f)'s snapshot, object-class and watch/notify legs on
    reppool beside ecpool.  `before_kill` runs after RepLeg.healthy and
    before the victim dies; `after_clean` after the recovery to clean
    that `osd out` starts, and before RepLeg.verify."""

    def __init__(self, c, r, rep, ec_objs: dict):
        self.c, self.r, self.rep, self.ec_objs = c, r, rep, ec_objs
        self.rng = np.random.default_rng(SEED + 198)
        self.names = [f"rep{i}" for i in range(REP_OBJECTS)]
        self.first = {n: _sha(rep.objs[n]) for n in self.names}
        self.out: dict = {}

    # -- before the kill ----------------------------------------------------
    def before_kill(self, victim: int) -> None:
        # the overwritten objects: those the victim holds a replica of
        # first, so the recovery after `osd out` has clones to push
        m, pid = self.c.mon.osdmap, self.rep.pid
        held = [n for n in self.names if victim in m.pg_to_up_acting_osds(
            m.object_locator_to_pg(n, pid))[2]]
        self.over = (held + [n for n in self.names
                             if n not in held])[:SNAP_OVERWRITES]
        self.new = {n: self.rng.bytes(REPAIR_OBJECT) for n in self.over}
        self.gone = [n for n in self.names if n not in self.over][-1]
        self.rolled = self.over[-1]
        self.rolled_data = self.rep.objs[self.rolled]
        self.late = self.rng.bytes(REPAIR_OBJECT)
        self.snapshot()
        self.refusals()
        self.clients = [self.r] + [
            self.c.rados(timeout=CLUSTER_TIMEOUT_S)
            for _ in range(WATCH_CLIENTS)]
        self.object_classes()
        self.watch(victim)

    def snapshot(self) -> None:
        from ceph_tpu_torch.client import WriteOp

        tag, io, rep = "phase 19 (f)", self.rep.io, self.rep
        t0 = time.monotonic()
        io.snap_create("s19")
        self.sid = io.snap_lookup("s19")
        self.out["snap_create_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        for n in self.over:
            io.operate(n, WriteOp().write_full(self.new[n])
                       .set_xattr("seq", b"after s19"))
        self.out["clone_s"] = time.monotonic() - t0
        io.remove(self.gone)
        io.write_full("rep_late", self.late)
        for n in self.over:
            rep.objs[n] = self.new[n]
            rep.attrs[n] = {**rep.attrs[n], "seq": b"after s19"}
        rep.removed.add(self.gone)
        rep.objs["rep_late"], rep.attrs["rep_late"] = self.late, {}
        t0 = time.monotonic()
        self._check_s19(tag)
        self.out["s19_read_s"] = time.monotonic() - t0
        for n in self.over:
            if _sha(io.read(n)) != _sha(self.new[n]):
                raise AssertionError(f"{tag}: head of {n} after the overwrite")
        if _errno(io.read, self.gone) != "ENOENT" or \
                _errno(io.read, "rep_late", snapid=self.sid) != "ENOENT":
            raise AssertionError(f"{tag}: {self.gone} at head or rep_late at "
                                 "s19 is readable")
        want = {self.sid: [self.sid]}
        for n in self.names + ["rep_late"]:
            clones = io.list_snaps(n)["clones"]
            if clones != (want if n in self.over or n == self.gone else {}):
                raise AssertionError(f"{tag}: list_snaps({n}) = {clones}")
        self.out["clones"] = self._clone_objects(tag)
        # rollback: data and xattrs of s19 again
        t0 = time.monotonic()
        io.snap_rollback(self.rolled, "s19")
        self.out["rollback_s"] = time.monotonic() - t0
        first_attrs = _rep_xattrs(int(self.rolled[3:]))
        if _sha(io.read(self.rolled)) != self.first[self.rolled] or \
                io.get_xattrs(self.rolled) != first_attrs:
            raise AssertionError(f"{tag}: rollback of {self.rolled}")
        rep.attrs[self.rolled] = first_attrs
        rep.objs[self.rolled] = self.rolled_data

    def _check_s19(self, tag: str) -> None:
        io = self.rep.io
        for n in self.names:
            if _sha(io.read(n, snapid=self.sid)) != self.first[n]:
                raise AssertionError(f"{tag}: {n} at s19 differs from its "
                                     "first payload")

    def _clone_objects(self, tag: str) -> int:
        """Clone objects of s19 on reppool's acting OSDs: one per replica
        of each object the snap kept apart from its head."""
        from ceph_tpu_torch.osd import ec_backend
        from ceph_tpu_torch.store import ObjectId

        m, pid = self.c.mon.osdmap, self.rep.pid
        found = 0
        for n in self.over + [self.gone]:
            raw = m.object_locator_to_pg(n, pid)
            cid = ec_backend.pg_cid(m.pools[pid].raw_pg_to_pg(raw))
            for osd in m.pg_to_up_acting_osds(raw)[2]:
                found += self.c.osds[osd].store.exists(
                    cid, ObjectId(n, snap=self.sid))
        if found != (SNAP_OVERWRITES + 1) * REP_SIZE:
            raise AssertionError(f"{tag}: {found} clone objects on the "
                                 "acting OSDs")
        return found

    def refusals(self) -> None:
        ec_io = self.r.open_ioctx("ecpool")
        oid = next(iter(self.ec_objs))
        got = {"snap_create": _errno(ec_io.snap_create, "s19_ec"),
               "selfmanaged_snap_create": _errno(
                   ec_io.selfmanaged_snap_create),
               "exec": _errno(ec_io.exec, oid, "lock", "get_info",
                              {"name": "l"})}
        if set(got.values()) != {"EOPNOTSUPP"}:
            raise AssertionError(f"phase 19 (f): ecpool answered {got}")
        self.out["refusals"] = got

    def object_classes(self) -> None:
        tag, io = "phase 19 (f)", self.rep.io
        other = self.clients[1].open_ioctx("reppool")
        times = {}
        t0 = time.monotonic()
        lk = {"name": "l19", "type": "exclusive", "cookie": "c"}
        me, them = self.r.objecter.name, self.clients[1].objecter.name
        steps = [
            (io, "lock", dict(lk, client=me), "ok"),
            (other, "lock", dict(lk, client=them), "EBUSY"),
            (io, "unlock", {"name": "l19", "client": me, "cookie": "c"},
             "ok"),
            (other, "lock", dict(lk, client=them), "ok"),
            (other, "unlock", {"name": "l19", "client": them,
                               "cookie": "c"}, "ok")]
        for ctx, method, ind, want in steps:
            got = _errno(ctx.exec, "cls_lock", "lock", method, ind)
            if got != want:
                raise AssertionError(f"{tag}: lock.{method} {ind} -> {got}")
        times["lock"] = time.monotonic() - t0
        t0 = time.monotonic()
        io.write_full("cls_ref", b"shared")
        for tg in ("t1", "t2"):
            io.exec("cls_ref", "refcount", "get", {"tag": tg})
        refs = io.exec("cls_ref", "refcount", "read", {})["refs"]
        for tg in ("t1", "t2"):
            io.exec("cls_ref", "refcount", "put", {"tag": tg})
        if refs != ["t1", "t2"] or _errno(io.read, "cls_ref") != "ENOENT":
            raise AssertionError(f"{tag}: refcount {refs}")
        times["refcount"] = time.monotonic() - t0
        t0 = time.monotonic()
        io.write_full("cls_ver", b"v")
        io.exec("cls_ver", "version", "set", {"ver": 5})
        io.exec("cls_ver", "version", "inc", {})
        gate = [_errno(io.exec, "cls_ver", "version", "check",
                       {"ver": v, "cond": "eq"}) for v in (6, 7)]
        io.exec("cls_ver", "version", "inc", {"ver": 6, "cond": "eq"})
        ver = io.exec("cls_ver", "version", "read", {})["ver"]
        if gate != ["ok", "ECANCELED"] or ver != 7:
            raise AssertionError(f"{tag}: version gate {gate}, ver {ver}")
        times["version"] = time.monotonic() - t0
        t0 = time.monotonic()
        futs = [io.aio_exec("cls_num", "numops", "add",
                            {"key": "c", "value": 1})
                for _ in range(CLS_AIO_ADDS)]
        outs = sorted(io._wait(f).attrs["out"]["value"] for f in futs)
        count = io.get_omap_vals("cls_num")[0].get("c")
        if outs != list(range(1, CLS_AIO_ADDS + 1)) or \
                count != str(CLS_AIO_ADDS).encode():
            raise AssertionError(f"{tag}: numops adds {outs}, omap {count}")
        times["numops"] = time.monotonic() - t0
        t0 = time.monotonic()
        for s in range(0, CLS_LOG_ENTRIES, CLS_LOG_PAGE):
            io.exec("cls_log", "log", "add", {"entries": [
                {"timestamp": float(i), "section": "smoke",
                 "name": f"e{i}", "data": i}
                for i in range(s, s + CLS_LOG_PAGE)]})
        listed, marker = [], ""
        while True:
            page = io.exec("cls_log", "log", "list",
                           {"marker": marker, "max_entries": CLS_LOG_PAGE})
            listed += [e["name"] for e in page["entries"]]
            if not page["truncated"]:
                break
            marker = page["marker"]
        info = io.exec("cls_log", "log", "info", {})
        trimmed = 0
        while True:
            n = io.exec("cls_log", "log", "trim",
                        {"to_time": float(CLS_LOG_ENTRIES)})["trimmed"]
            if not n:
                break
            trimmed += n
        left = io.exec("cls_log", "log", "list", {})["entries"]
        if listed != [f"e{i}" for i in range(CLS_LOG_ENTRIES)] or \
                info["entries"] != CLS_LOG_ENTRIES or \
                trimmed != CLS_LOG_ENTRIES or left:
            raise AssertionError(f"{tag}: cls log listed {len(listed)}, "
                                 f"info {info}, trimmed {trimmed}, left "
                                 f"{len(left)}")
        times["log"] = time.monotonic() - t0
        # every replica of the class objects holds the same data, xattrs
        # and omap
        for oid in ("cls_lock", "cls_ver", "cls_num", "cls_log"):
            digests = {d for _osd, d in self.rep._replicas(oid)}
            if len(digests) != 1:
                raise AssertionError(f"{tag}: the replicas of {oid} differ")
        self.out["cls_s"] = times

    def _watched(self, victim: int) -> list:
        """Two ecpool and two reppool objects; in each pool, one whose
        primary is the victim (so its watches must move) when one is."""
        m = self.c.mon.osdmap
        out = []
        for pool, names in (("ecpool", list(self.ec_objs)),
                            ("reppool", [n for n in self.names
                         if n not in self.over and n != self.gone])):
            pid = self.r.pool_lookup(pool)
            prim = {n: m.pg_to_up_acting_osds(
                m.object_locator_to_pg(n, pid))[3] for n in names}
            moving = [n for n in names if prim[n] == victim][:1]
            out += [(pool, n) for n in moving + [
                n for n in names if n not in moving][:2 - len(moving)]]
        return out

    def _notify(self, ioctxs: dict, oid: str, pool: str, payload,
                want_from, timeout: float = 10.0) -> tuple:
        replies, timeouts = ioctxs[pool].notify(oid, payload=payload,
                                                timeout=timeout)
        want = {f"{self.clients[i].objecter.name}/w19.{i}.{oid}":
                {"client": i, "n": payload["n"]} for i in want_from}
        if replies != want:
            raise AssertionError(f"phase 19 (f): notify {payload} on "
                                 f"{pool}/{oid}: replies {replies}, not "
                                 f"{want}; timed out {timeouts}")
        return True, timeouts

    def watch(self, victim: int) -> None:
        tag = "phase 19 (f)"
        self.watched = self._watched(victim)
        self.got: list = []
        for i, cl in enumerate(self.clients[1:], 1):
            for pool, oid in self.watched:
                def cb(nid, notifier, payload, i=i):
                    self.got.append(i)
                    return {"client": i, "n": payload["n"]}
                cl.open_ioctx(pool).watch(oid, cb, cookie=f"w19.{i}.{oid}")
        self.ioctxs = {p: self.r.open_ioctx(p) for p in ("ecpool", "reppool")}
        everyone = range(1, WATCH_CLIENTS + 1)
        lat = []
        for k in range(WATCH_NOTIFIES):
            pool, oid = self.watched[k % len(self.watched)]
            t0 = time.monotonic()
            ok, timeouts = self._notify(self.ioctxs, oid, pool, {"n": k},
                                        everyone)
            lat.append(time.monotonic() - t0)
            if not ok or timeouts:
                raise AssertionError(f"{tag}: notify {k} on {pool}/{oid}: "
                                     f"replies short, timeouts {timeouts}")
        if len(self.got) != WATCH_NOTIFIES * WATCH_CLIENTS:
            raise AssertionError(f"{tag}: {len(self.got)} callbacks")
        lat.sort()
        self.out["notify"] = {
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            "watches": len(self.watched) * WATCH_CLIENTS}
        m = self.c.mon.osdmap
        self.primaries = {oid: m.pg_to_up_acting_osds(m.object_locator_to_pg(
            oid, self.r.pool_lookup(pool)))[3] for pool, oid in self.watched}

    # -- after the recovery to clean -----------------------------------------
    def after_clean(self) -> None:
        tag = "phase 19 (f)"
        self.relinger(tag)
        t0 = time.monotonic()
        self._check_s19(tag)
        self.out["s19_read_after_s"] = time.monotonic() - t0
        self.out["clones_after"] = self._clone_objects(tag)

    def relinger(self, tag: str) -> None:
        m = self.c.mon.osdmap
        now = {oid: m.pg_to_up_acting_osds(m.object_locator_to_pg(
            oid, self.r.pool_lookup(pool)))[3] for pool, oid in self.watched}
        moved = [oid for oid in now if now[oid] != self.primaries[oid]]
        if not moved:
            raise AssertionError(f"{tag}: no watched object's primary "
                                 f"moved ({now})")

        def registered() -> bool:
            for i, cl in enumerate(self.clients[1:], 1):
                for oid in now:
                    w = cl.objecter.watches.get(f"w19.{i}.{oid}")
                    if w is None or w["osd"] != now[oid]:
                        return False
            return True
        t0 = time.monotonic()
        _wait(self.c, registered, "the watches re-registered", tag=tag)
        self.out["relinger_s"] = time.monotonic() - t0
        everyone = range(1, WATCH_CLIENTS + 1)
        replies = 0
        for k, (pool, oid) in enumerate(self.watched):
            ok, timeouts = self._notify(self.ioctxs, oid, pool,
                                        {"n": 1000 + k}, everyone)
            if not ok or timeouts:
                raise AssertionError(f"{tag}: notify after the move on "
                                     f"{pool}/{oid}: timeouts {timeouts}")
            replies += WATCH_CLIENTS
        # a watcher client that dies shows up among the timed out
        dead = self.clients.pop()
        dead_i = WATCH_CLIENTS
        dead.shutdown()
        pool, oid = self.watched[0]
        t0 = time.monotonic()
        ok, timeouts = self._notify(self.ioctxs, oid, pool, {"n": 2000},
                                    range(1, dead_i),
                                    timeout=WATCH_TIMEOUT_S)
        self.out["dead_notify_s"] = time.monotonic() - t0
        if not ok or timeouts != [f"{dead.objecter.name}/w19.{dead_i}.{oid}"]:
            raise AssertionError(f"{tag}: the dead watcher's notify: "
                                 f"timeouts {timeouts}")
        self.out["moved"] = {"objects": len(moved),
                             "watches": len(moved) * WATCH_CLIENTS,
                             "replies": replies, "timed_out": timeouts}

    def close_clients(self) -> None:
        """Unwatch and shut the live watcher clients down (after the rbd
        leg, which holds vm0's lock through the second)."""
        for i, cl in enumerate(self.clients[1:], 1):
            for p, o in self.watched:
                cl.open_ioctx(p).unwatch(o, f"w19.{i}.{o}")
            cl.shutdown()

    def trim(self) -> None:
        """snap_remove("s19"), then the heartbeat tick on a sim clock
        until every PG's snap index is empty, `df` shows no trimming PG
        and reppool's store bytes are its logical bytes again.  The
        replicas' trim acks are held for the first tick, so the trimming
        state reaches a pg-stat report before the round completes."""
        from ceph_tpu_torch.common.options import global_config
        from ceph_tpu_torch.msg.messages import SnapTrimReply
        from ceph_tpu_torch.osd.snap_mapper import SnapMapper

        tag = "phase 19 (f)"
        if global_config()["osd_snap_trim_sleep"] != 0:
            raise AssertionError(f"{tag}: osd_snap_trim_sleep is not 0")
        c, io, pid = self.c, self.rep.io, self.rep.pid

        def index() -> int:
            n = 0
            for d in list(c.osds.values()):
                with d._lock:
                    for pg, st in d.pgs.items():
                        if pg.pool == pid:
                            n += len(SnapMapper(d.store, st.shard.cid).dump())
            return n

        def df() -> dict:
            return c.mon.handle_command({"prefix": "df"})[2]["pools"].get(
                "reppool", {})
        entries = index()
        clock = SimClock(c, max(c._sim_now or SCRUB_T0, SCRUB_T0) +
                         ELASTIC_STEP_S)
        t0 = time.monotonic()
        io.snap_remove("s19")
        c.network.filter = lambda src, dst, msg: \
            not isinstance(msg, SnapTrimReply)
        try:
            clock.step()
            _wait(c, lambda: df().get("snaptrim_pgs", 0) > 0,
                  "df shows PGs in snaptrim", tag=tag)
        finally:
            c.network.filter = None
        seen = df()["snaptrim_pgs"]
        for ticks in range(2, TRIM_MAX_TICKS + 1):
            clock.step()
            d = df()
            if not index() and d["snaptrim_pgs"] == 0 and \
                    abs(d["store_bytes"] - d["bytes"]) <= 1:
                break
        else:
            raise AssertionError(f"{tag}: trim not done in {TRIM_MAX_TICKS} "
                                 f"ticks: index {index()}, df {df()}")
        wall = time.monotonic() - t0
        for n in self.names + ["rep_late"]:
            if n != self.gone and io.list_snaps(n)["clones"]:
                raise AssertionError(f"{tag}: {n} keeps clones after the trim")
        if _errno(io.read, self.over[0], snapid=self.sid) == "ok":
            raise AssertionError(f"{tag}: s19 still readable after the trim")
        self.out["trim"] = {"ticks": ticks, "sim_s": ticks * ELASTIC_STEP_S,
                            "wall_s": wall, "index_entries": entries,
                            "snaptrim_pgs_seen": seen, "df": df()}
        _faults(c, tag)


# -- phase 19 (f): block images and the journal on reppool -----------------

RBD_IMAGE_B = 1 << 30            # vm0: 1 GiB
RBD_ORDER = 22                   # 4 MiB objects (rbd_default_order)
RBD_OBJ = 1 << RBD_ORDER
RBD_SEQ_OBJECTS = 64             # 64 x 4 MiB written in order: 256 MiB
RBD_RANDOM_WRITES = 256          # seeded 4 KiB writes inside those 256 MiB,
                                 # cut from 1,024, then 512 (the smoke's
                                 # wall, PERF.md 4)
RBD_CLONE_WRITES = 128           # seeded 4 KiB writes to the clone (copyups),
                                 # cut from 256 (the smoke's wall)
RBD_HANDOFF_WRITES = 16          # the second client's 4 KiB writes after base
RBD_SMALL_B = 64 << 20           # jvm and the migrated image: 64 MiB
RBD_JOURNAL_WRITES = 256         # jvm's writes of 4-64 KiB before the kill
RBD_MIRROR_MORE = 64             # and after the recovery
RBD_MIGRATE_WRITES = 64          # 4 KiB writes while migration_execute runs
RBD_BAK_PG_NUM = 8               # rbdbak: the mirror's and migration's target


def _rbd_counts() -> dict:
    from ceph_tpu_torch import journal
    from ceph_tpu_torch.rbd import image

    return {"swallowed": sum(image.SWALLOWED.values()) +
            sum(journal.SWALLOWED.values()),
            "locks_broken": image.LOCKS["broken"],
            "released_on_request": image.LOCKS["released_on_request"]}


class RbdLeg:
    """Phase 19 (f)'s block images on `reppool` (and `rbdbak`, which
    RepLeg.create makes beside it), through the phase's librados clients:
    the main one and SnapLeg's second.  `before_kill` runs after
    SnapLeg.before_kill; `after_clean` after the recovery to clean that
    `osd out` starts, while SnapLeg's clients still live.  Every read is
    held to a host model byte for byte."""

    def __init__(self, c, r, rep, snap):
        self.c, self.r, self.rep, self.snap = c, r, rep, snap
        self.rng = np.random.default_rng(SEED + 199)
        self.out: dict = {}

    def _writes(self, n: int, span: int, lo: int = 4096,
                hi: int = 4096) -> list:
        """n seeded (offset, bytes): 4 KiB-aligned offsets inside `span`,
        lengths from lo to hi in 4 KiB steps."""
        out = []
        for _ in range(n):
            length = int(self.rng.integers(lo // 4096, hi // 4096 + 1)) * 4096
            off = int(self.rng.integers(0, (span - length) // 4096 + 1)) * 4096
            out.append((off, self.rng.bytes(length)))
        return out

    @staticmethod
    def _apply(model: bytearray, writes) -> None:
        for off, data in writes:
            model[off:off + len(data)] = data

    def _check(self, img, model, what: str) -> float:
        """Read the image's first len(model) bytes, 16 objects at a time
        (an uncached read sends their ops together), and hold each
        chunk to the model byte for byte; returns the wall."""
        step = 16 * RBD_OBJ
        t0 = time.monotonic()
        for off in range(0, len(model), step):
            n = min(step, len(model) - off)
            if img.read(off, n) != model[off:off + n]:
                raise AssertionError(f"phase 19 (f): {what} differs from "
                                     f"the model in [{off}, {off + n})")
        return time.monotonic() - t0

    def _verify(self, ioctx, name: str, model, what: str,
                snapshot: str | None = None) -> float:
        """Open `name` (at `snapshot`) with rbd_cache off, so every byte
        comes from the OSDs, and hold it to `model`."""
        from ceph_tpu_torch.common.options import global_config
        from ceph_tpu_torch.rbd import Image

        global_config().set("rbd_cache", False)
        try:
            img = Image(ioctx, name, snapshot=snapshot)
        finally:
            global_config().set("rbd_cache", True)
        try:
            return self._check(img, model, what)
        finally:
            img.close()

    # -- before the kill ----------------------------------------------------
    def before_kill(self) -> None:
        from ceph_tpu_torch.common.options import global_config
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rbd import RBD, Image

        tag, io, out = "phase 19 (f)", self.rep.io, self.out
        global_config().set("rbd_cache", True)
        self.counts0 = _rbd_counts()
        l0 = bm.LAUNCHES["gf_matmul"]
        t_leg = time.monotonic()
        # -- vm0: sequential then random writes through the cache ------------
        span = RBD_SEQ_OBJECTS * RBD_OBJ
        self.model = bytearray(self.rng.bytes(span))
        RBD().create(io, "vm0", RBD_IMAGE_B, order=RBD_ORDER)
        img = Image(io, "vm0")
        t0 = time.monotonic()
        for i in range(RBD_SEQ_OBJECTS):
            img.write(i * RBD_OBJ, bytes(self.model[i * RBD_OBJ:
                                                    (i + 1) * RBD_OBJ]))
        img.flush()
        wall = time.monotonic() - t0
        out["seq_write"] = {"MBps": span / wall / 1e6, "wall_s": wall}
        writes = self._writes(RBD_RANDOM_WRITES, span)
        t0 = time.monotonic()
        for off, data in writes:
            img.write(off, data)
        img.flush()
        wall = time.monotonic() - t0
        out["random_write"] = {"per_s": len(writes) / wall, "wall_s": wall}
        self._apply(self.model, writes)
        wall = self._check(img, self.model, "vm0's read-back")
        out["read"] = {"MBps": span / wall / 1e6, "wall_s": wall}
        used = img.du()
        if used != span or img.stat()["num_objs"] != RBD_IMAGE_B // RBD_OBJ:
            raise AssertionError(f"{tag}: vm0 du {used} B, not {span}")
        out["du_objects"] = used // RBD_OBJ
        # -- snapshot, protect, clone, copyups --------------------------------
        t0 = time.monotonic()
        img.snap_create("base")
        img.snap_protect("base")
        RBD().clone(io, "vm0", "base", io, "vm0c")
        out["snap_clone_s"] = time.monotonic() - t0
        self.base = bytes(self.model)
        self.child = bytearray(self.base)
        child = Image(io, "vm0c")
        writes = self._writes(RBD_CLONE_WRITES, span)
        t0 = time.monotonic()
        for off, data in writes:
            child.write(off, data)
        child.flush()
        wall = time.monotonic() - t0
        copyups = len(child.object_map.existing())
        out["copyup"] = {"objects": copyups, "wall_s": wall,
                         "writes": len(writes)}
        if copyups != len({off // RBD_OBJ for off, _ in writes}):
            raise AssertionError(f"{tag}: {copyups} objects copied up")
        self._apply(self.child, writes)
        child.close()
        out["child_read_s"] = self._verify(io, "vm0c", self.child, "vm0c")
        out["base_read_s"] = self._verify(io, "vm0", self.base, "vm0@base",
                                          snapshot="base")
        # -- the exclusive lock: the second client's writes hand it over ------
        other = self.snap.clients[1].open_ioctx("reppool")
        self.holder = Image(other, "vm0")
        writes = self._writes(RBD_HANDOFF_WRITES, span)
        t0 = time.monotonic()
        self.holder.write(*writes[0])
        out["handoff_s"] = time.monotonic() - t0
        for w in writes[1:]:
            self.holder.write(*w)
        if img.lock_owner or not self.holder.lock_owner:
            raise AssertionError(f"{tag}: the lock was not handed over")
        self._apply(self.model, writes)
        diff = self.holder.diff_since("base")
        want = sorted({off // RBD_OBJ for off, _ in writes})
        if [d["objectno"] for d in diff] != want:
            raise AssertionError(f"{tag}: diff since base "
                                 f"{[d['objectno'] for d in diff]}, not {want}")
        out["diff_objects"] = len(diff)
        img.close()
        # -- the journaled, mirrored image ------------------------------------
        self.bak = self.r.open_ioctx("rbdbak")
        self.jmodel = bytearray(RBD_SMALL_B)
        RBD().create(io, "jvm", RBD_SMALL_B, order=RBD_ORDER, journaling=True)
        from ceph_tpu_torch.rbd.mirror import ImageMirror, mirror_enable

        mirror_enable(io, "jvm")
        writes = self._writes(RBD_JOURNAL_WRITES, RBD_SMALL_B, 4096,
                              64 << 10)
        jvm = Image(io, "jvm")
        t0 = time.monotonic()
        for off, data in writes:
            jvm.write(off, data)
        jvm.close()
        out["journal_write_s"] = time.monotonic() - t0
        self._apply(self.jmodel, writes)
        self.mirror = ImageMirror(io, self.bak, "jvm")
        out["mirror"] = [self._sync(len(writes))]
        # -- migration with writes during execute -----------------------------
        out["migration"] = self.migrate()
        out["launches"] = bm.LAUNCHES["gf_matmul"] - l0
        out["before_s"] = time.monotonic() - t_leg
        self._counts(tag)

    def _sync(self, want: int) -> dict:
        t0 = time.monotonic()
        applied = self.mirror.sync()
        wall = time.monotonic() - t0
        if applied != want:
            raise AssertionError(f"phase 19 (f): the mirror sync applied "
                                 f"{applied} entries, not {want}")
        for ioctx, what in ((self.rep.io, "jvm"), (self.bak, "jvm on rbdbak")):
            self._verify(ioctx, "jvm", self.jmodel, what)
        return {"entries": applied, "wall_s": wall}

    def migrate(self) -> dict:
        import threading

        from ceph_tpu_torch.rbd import RBD, Image

        tag, io = "phase 19 (f)", self.rep.io
        model = bytearray(self.rng.bytes(RBD_SMALL_B))
        RBD().create(io, "mig", RBD_SMALL_B, order=RBD_ORDER)
        img = Image(io, "mig")
        for off in range(0, RBD_SMALL_B, RBD_OBJ):
            img.write(off, bytes(model[off:off + RBD_OBJ]))
        img.close()
        writes = self._writes(RBD_MIGRATE_WRITES, RBD_SMALL_B)
        t0 = time.monotonic()
        RBD().migration_prepare(io, "mig", self.bak, "mig")
        writer = Image(self.snap.clients[1].open_ioctx("rbdbak"), "mig")
        errors: list = []

        def write_all():
            try:
                for off, data in writes:
                    writer.write(off, data)
                writer.flush()
            except Exception as e:      # reported below: the leg fails
                errors.append(repr(e))
        th = threading.Thread(target=write_all)
        th.start()
        t1 = time.monotonic()
        RBD().migration_execute(self.bak, "mig")
        execute_s = time.monotonic() - t1
        th.join()
        writer.close()
        if errors:
            raise AssertionError(f"{tag}: writes during the migration: "
                                 f"{errors[0]}")
        RBD().migration_commit(self.bak, "mig")
        wall = time.monotonic() - t0
        self._apply(model, writes)
        dst = Image(self.bak, "mig")
        parent = dst.parent
        dst.close()
        if parent is not None:
            raise AssertionError(f"{tag}: the migrated image has a parent")
        self._verify(self.bak, "mig", model, "the migrated image")
        if "mig" in RBD().list(io):
            raise AssertionError(f"{tag}: the migration source is listed")
        return {"wall_s": wall, "execute_s": execute_s,
                "writes": len(writes)}

    def _counts(self, tag: str) -> None:
        got = _rbd_counts()
        if got["swallowed"] != self.counts0["swallowed"] or \
                got["locks_broken"] != self.counts0["locks_broken"]:
            raise AssertionError(f"{tag}: rbd counts {self.counts0} -> {got}")

    # -- after the recovery to clean -----------------------------------------
    def after_clean(self) -> None:
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rbd import RBD, Image
        from ceph_tpu_torch.rbd.image import RBD_LOCK_NAME, header_name
        from ceph_tpu_torch.rbd.mirror import demote, mirror_state, promote

        tag, io, out = "phase 19 (f)", self.rep.io, self.out
        l0 = bm.LAUNCHES["gf_matmul"]
        t_leg = time.monotonic()
        # the holder still holds the lock and still answers on the header
        hdr = header_name("vm0")
        key = f"{self.snap.clients[1].objecter.name}/"
        t0 = time.monotonic()
        end = t0 + CLUSTER_TIMEOUT_S
        while True:
            replies, _ = io.notify(hdr, payload={"op": "ping"}, timeout=2.0)
            if [v for k, v in replies.items() if k.startswith(key)] == \
                    [{"owner": True}]:
                break
            if time.monotonic() > end:
                raise AssertionError(f"{tag}: the lock holder's header watch "
                                     f"answered {replies}")
            time.sleep(0.05)
        out["holder_answer_s"] = time.monotonic() - t0
        lockers = io.exec(hdr, "lock", "get_info",
                          {"name": RBD_LOCK_NAME})["lockers"]
        if not self.holder.lock_owner or [lk["client"] for lk in lockers] != \
                [self.snap.clients[1].objecter.name]:
            raise AssertionError(f"{tag}: the lock after the recovery: "
                                 f"{lockers}")
        # every image and the snapshot read back equal to the model
        reads = {}
        for name, snap, model in (("vm0", None, self.model),
                                  ("vm0c", None, self.child),
                                  ("vm0", "base", self.base)):
            key = f"{name}@{snap}" if snap else name
            reads[key] = self._verify(io, name, model,
                                      f"{key} after the recovery", snap)
        out["reads_after_s"] = reads
        # the mirror replays 64 more writes, then an orderly failback
        writes = self._writes(RBD_MIRROR_MORE, RBD_SMALL_B, 4096, 64 << 10)
        jvm = Image(io, "jvm")
        for off, data in writes:
            jvm.write(off, data)
        jvm.close()
        self._apply(self.jmodel, writes)
        out["mirror"].append(self._sync(len(writes)))
        t0 = time.monotonic()
        demote(io, "jvm")
        drained = self.mirror.sync()
        promote(self.bak, "jvm")
        out["failback_s"] = time.monotonic() - t0
        if drained or mirror_state(io, "jvm")["primary"] or \
                not mirror_state(self.bak, "jvm")["primary"]:
            raise AssertionError(f"{tag}: the failback: drained {drained}, "
                                 f"{mirror_state(io, 'jvm')}, "
                                 f"{mirror_state(self.bak, 'jvm')}")
        # flatten the clone, then the images go (so (g) moves none of them)
        child = Image(io, "vm0c")
        t0 = time.monotonic()
        child.flatten()
        out["flatten_s"] = time.monotonic() - t0
        if child.parent is not None or self.holder.children():
            raise AssertionError(f"{tag}: vm0c still has its parent")
        child.close()
        self.holder.snap_unprotect("base")
        self.holder.snap_remove("base")
        self.holder.close()
        t0 = time.monotonic()
        for name in ("vm0c", "vm0", "jvm"):
            RBD().remove(io, name)
        rc, outs, _ = self.r.mon_command({
            "prefix": "osd pool delete", "pool": "rbdbak",
            "yes_i_really_really_mean_it": True})
        if rc != 0:
            raise AssertionError(f"{tag}: rbdbak delete: {outs}")
        _wait(self.c, lambda: "rbdbak" not in
              self.c.mon.osdmap.pool_names.values() and
              _all_clean(self.c, self.r), "the PGs after rbdbak's delete",
              tag=tag)
        out["cleanup_s"] = time.monotonic() - t0
        listed = [o for o in io.list_objects() if o.startswith(("rbd_",
                                                                "journal"))]
        if listed:
            raise AssertionError(f"{tag}: {len(listed)} rbd objects left, "
                                 f"{listed[:4]}")
        out["launches_after"] = bm.LAUNCHES["gf_matmul"] - l0
        out["after_s"] = time.monotonic() - t_leg
        self._counts(tag)
        if out["launches"] or out["launches_after"]:
            raise AssertionError(f"{tag}: K1 launched {out['launches']} / "
                                 f"{out['launches_after']} times in the rbd leg")
        out["counts"] = _rbd_counts()


# -- phase 19 (f): the S3/Swift gateway on its own replicated pool -----------

RGW_POOL = "rgw"                 # made by the gateway itself (pg_num 32)
RGW_OBJ = 4 << 20                # radosgw's stripe size (rgw_obj_stripe_size)
RGW_LARGE = 64                   # 4 MiB objects in bk0: 256 MiB
RGW_LARGE_THREADS = 4
RGW_SMALL = 960                  # 4 KiB objects in bk0, over all 8 shards:
                                 # cut from 1,024 for the smoke's wall, and
                                 # with the 64 large ones still 2 pages
RGW_SMALL_B = 4 << 10
RGW_SMALL_THREADS = 8
RGW_PART_B = 8 << 20             # the AWS CLI's multipart_chunksize
RGW_PARTS = 8                    # one 64 MiB upload
RGW_MAX_KEYS = 1000              # S3's default page
RGW_VERSION_B = 64 << 10         # bkv's versions
RGW_EVENTS = 16                  # notification events, PUT then DELETE
RGW_DEGRADED_SMALL = 64          # small objects read while the victim is down
RGW_USER = "client.s3"           # the S3 user (SigV4 on every request)
RGW_OTHER = "client.s3other"     # a user the STS role does not trust
RGW_VERS_ON = (b"<VersioningConfiguration><Status>Enabled</Status>"
               b"</VersioningConfiguration>")
RGW_LC = (b"<LifecycleConfiguration><Rule><ID>nc</ID><Prefix>lc/</Prefix>"
          b"<Status>Enabled</Status><NoncurrentVersionExpiration>"
          b"<NoncurrentDays>1</NoncurrentDays></NoncurrentVersionExpiration>"
          b"</Rule></LifecycleConfiguration>")
RGW_NOTIF = (b"<NotificationConfiguration><TopicConfiguration><Id>n</Id>"
             b"<Topic>arn:aws:sns:::t0</Topic>"
             b"<Event>s3:ObjectCreated:*</Event>"
             b"<Event>s3:ObjectRemoved:*</Event>"
             b"</TopicConfiguration></NotificationConfiguration>")


class S3Client:
    """SigV4-signed requests to one gateway (the port's `sign_request`),
    one keep-alive connection per thread; `token` adds an STS session
    token; no `access`: unsigned.  Returns (status, headers, body).
    `close` ends every connection: a gateway's shutdown waits for its
    connections' handler threads."""

    def __init__(self, port: int, access: str, secret: str,
                 token: str | None = None):
        self.port, self.access, self.secret = port, access, secret
        self.extra = {"x-amz-security-token": token} if token else {}
        self._local = threading.local()
        self._conns: list = []
        self._lock = make_lock("smoke.s3client")

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()

    def __call__(self, method: str, path: str, body: bytes = b"",
                 headers: dict | None = None):
        from ceph_tpu_torch.rgw.auth import sign_request

        hdrs = dict(self.extra, **(headers or {}))
        hdrs["host"] = f"127.0.0.1:{self.port}"
        if self.access:
            hdrs = sign_request(method, path, hdrs, body, self.access,
                                self.secret)
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection(
                "127.0.0.1", self.port, timeout=CLUSTER_TIMEOUT_S)
            # a body of 2 KiB or more leaves after its headers: send it
            # without waiting for the gateway's delayed ACK
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
        # no resend: the gateway closes a keep-alive connection only when
        # a handler dies, and that must fail the leg
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()


def _s3_ok(res, want: int, what: str, tag: str = "phase 19 (f) rgw"):
    if res[0] != want:
        raise AssertionError(f"{tag}: {what}: HTTP {res[0]}, not {want}: "
                             f"{res[2][:300]!r}")
    return res


def _pmap(fn, items, threads: int) -> list:
    with ThreadPoolExecutor(max_workers=threads) as ex:
        return list(ex.map(fn, items))


def _pcts(values) -> tuple:
    vals = sorted(values)
    return (vals[len(vals) // 2], vals[min(len(vals) - 1,
                                           int(len(vals) * 0.99))])


class _Receiver:
    """The notification endpoint: records each event with its arrival on
    the host clock."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.events: list = []
        rec = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                rec.events.append((time.monotonic(), json.loads(body)))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


class RgwLeg:
    """Phase 19 (f)'s S3/Swift gateway (the port's `rgw`) on its own
    replicated pool `rgw`, which the gateway makes (pg_num 32) on phase
    19's cluster: a bucket index in omap, which an EC pool refuses, so K1
    runs beside it (`ecpool`), not under it.  SigV4 on every S3 request.
    `before_kill` after RbdLeg.before_kill, `degraded` while the victim
    is down, `after_clean` after RbdLeg.after_clean.  Every byte read is
    held to a host model.  The counts default to the smoke's: `large` 4
    MiB and `small` 4 KiB objects in bk0, `parts` 8 MiB multipart parts,
    `degraded_small` small objects read while the victim is down, and a
    listing page of `max_keys`."""

    def __init__(self, c, r, large: int = RGW_LARGE, small: int = RGW_SMALL,
                 parts: int = RGW_PARTS,
                 degraded_small: int = RGW_DEGRADED_SMALL,
                 max_keys: int = RGW_MAX_KEYS):
        self.c, self.r = c, r
        self.depth = {"large": large, "small": small, "parts": parts,
                      "degraded_small": degraded_small, "max_keys": max_keys}
        self.rng = np.random.default_rng(SEED + 200)
        self.out: dict = {"depth": self.depth}
        # bucket -> {key: bytes} of what must read back; bkv's versions
        # are kept by version id beside it
        self.model: dict = {}
        self.versions: dict = {}
        # bucket -> keys whose index entry is a tombstone
        self.gone: dict = {}
        self.etags: dict = {}    # (bucket, key) -> ETag where it is not md5
        self.gw = None
        self.clients: list = []

    def client(self, access: str, secret: str, token=None) -> S3Client:
        cl = S3Client(self.gw.port, access, secret, token)
        self.clients.append(cl)
        return cl

    def close(self) -> None:
        """Close every client connection and shut the gateway down (a
        no-op for a gateway already shut down)."""
        for cl in self.clients:
            cl.close()
        if self.gw is not None:
            self.gw.shutdown()
            self.gw = None

    def _index_keys(self, bucket: str) -> dict:
        """shard -> sorted omap keys of each index shard object."""
        from ceph_tpu_torch.rgw.gateway import _index_obj

        n = self.gw._nshards(bucket)
        return {s: sorted(self.gw.io.get_omap_vals(_index_obj(bucket, s))[0])
                for s in range(n)}

    def _model_index(self, bucket: str) -> dict:
        from ceph_tpu_torch.rgw.gateway import _shard_of

        keys = set(self.model.get(bucket, {})) | \
            set(self.versions.get(bucket, {})) | \
            set(self.gone.get(bucket, ()))
        n = self.gw._nshards(bucket)
        return {s: sorted(k for k in keys if _shard_of(k, n) == s)
                for s in range(n)}

    def _get_all(self, bucket: str, keys, threads: int, what: str) -> float:
        """GET every key, each equal to the model; returns the wall."""
        s3, model = self.s3, self.model[bucket]

        def get(key):
            st, hdrs, body = _s3_ok(s3("GET", f"/{bucket}/{key}"), 200,
                                    f"{what} GET {bucket}/{key}")
            etag = self.etags.get((bucket, key)) or \
                hashlib.md5(model[key]).hexdigest()
            if body != model[key] or hdrs["ETag"] != f'"{etag}"':
                raise AssertionError(f"phase 19 (f) rgw: {what} GET "
                                     f"{bucket}/{key} differs from the model")
        t0 = time.monotonic()
        _pmap(get, list(keys), threads)
        return time.monotonic() - t0

    def _list(self, bucket: str, what: str) -> tuple:
        """ListObjectsV2 page by page at `max_keys`; the keys must be the
        model's, in order.  -> (pages, seconds per page)."""
        keys, token, pages, t0 = [], "", 0, time.monotonic()
        while True:
            path = (f"/{bucket}?list-type=2&max-keys="
                    f"{self.depth['max_keys']}")
            if token:
                path += f"&continuation-token={token}"
            body = _s3_ok(self.s3("GET", path), 200, f"{what} list")[2]
            pages += 1
            keys += re.findall(r"<Key>([^<]+)</Key>", body.decode())
            m = re.search(r"<NextContinuationToken>([^<]+)<", body.decode())
            if not m:
                break
            token = m.group(1)
        wall = time.monotonic() - t0
        if keys != sorted(self.model[bucket]):
            raise AssertionError(f"phase 19 (f) rgw: {what} listing of "
                                 f"{bucket}: {len(keys)} keys, not the "
                                 f"model's {len(self.model[bucket])}")
        return pages, wall / pages

    def _versions(self, what: str) -> None:
        """bkv's ?versions equals the model's stacks; every version reads
        back by versionId."""
        body = _s3_ok(self.s3("GET", "/bkv?versions"), 200,
                      f"{what} ?versions")[2].decode()
        got = re.findall(r"<(Version|DeleteMarker)><Key>([^<]+)</Key>"
                         r"<VersionId>([^<]+)</VersionId>", body)
        want = [("DeleteMarker" if data is None else "Version", key, vid)
                for key, stack in sorted(self.versions["bkv"].items())
                for vid, data in stack]
        if got != want:
            raise AssertionError(f"phase 19 (f) rgw: {what} ?versions "
                                 f"{got}, not {want}")
        for key, stack in self.versions["bkv"].items():
            for vid, data in stack:
                if data is None:
                    continue
                body = _s3_ok(self.s3("GET", f"/bkv/{key}?versionId={vid}"),
                              200, f"{what} GET {key}@{vid}")[2]
                if body != data:
                    raise AssertionError(f"phase 19 (f) rgw: {what} {key}@"
                                         f"{vid} differs from the model")
            _s3_ok(self.s3("GET", f"/bkv/{key}"), 404,
                   f"{what} GET {key} behind its delete marker")

    def _check_index(self, what: str, buckets=None) -> dict:
        """Every bucket's (or each of `buckets`') index shards hold
        exactly the model's keys."""
        counts = {}
        for bucket in buckets or sorted(set(self.model) | set(self.versions)):
            got, want = self._index_keys(bucket), self._model_index(bucket)
            if got != want:
                raise AssertionError(f"phase 19 (f) rgw: {what}: {bucket}'s "
                                     f"index shards hold "
                                     f"{[len(v) for v in got.values()]} "
                                     f"keys, the model "
                                     f"{[len(v) for v in want.values()]}")
            counts[bucket] = [len(v) for v in got.values()]
        return counts

    def _counts(self, tag: str) -> None:
        from ceph_tpu_torch.rgw.gateway import SWALLOWED

        if sum(SWALLOWED.values()) != self.swallowed0:
            raise AssertionError(f"{tag}: rgw swallowed {dict(SWALLOWED)}")

    # -- before the kill ----------------------------------------------------
    def before_kill(self) -> None:
        from ceph_tpu_torch.auth import KeyRing, generate_key
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rgw import SWALLOWED, RGWGateway

        tag, out, d = "phase 19 (f) rgw", self.out, self.depth
        l0 = bm.LAUNCHES["gf_matmul"]
        self.swallowed0 = sum(SWALLOWED.values())
        t_leg = time.monotonic()
        self.keys = {RGW_USER: generate_key(), RGW_OTHER: generate_key()}
        t0 = time.monotonic()
        self.gw = RGWGateway(self.r, pool=RGW_POOL,
                             keyring=KeyRing(self.keys))
        self.gw.start()
        out["gateway_s"] = time.monotonic() - t0
        pool = self.r.objecter.osdmap.pools[self.r.pool_lookup(RGW_POOL)]
        if (pool.type, pool.size, pool.pg_num) != (1, REP_SIZE, 32):
            raise AssertionError(f"{tag}: the gateway's pool is type "
                                 f"{pool.type} size {pool.size} pg_num "
                                 f"{pool.pg_num}")
        self.s3 = s3 = self.client(RGW_USER, self.keys[RGW_USER])
        # -- bk0: large objects, then small ones over every index shard ------
        _s3_ok(s3("PUT", "/bk0"), 200, "PUT bk0")
        large = {f"l/{i:02d}": self.rng.bytes(RGW_OBJ)
                 for i in range(d["large"])}
        small = {f"s/{i:04d}": self.rng.bytes(RGW_SMALL_B)
                 for i in range(d["small"])}
        self.model["bk0"] = {**large, **small}

        def put(key):
            data = self.model["bk0"][key]
            hdrs = _s3_ok(s3("PUT", f"/bk0/{key}", data), 200,
                          f"PUT bk0/{key}")[1]
            if hdrs["ETag"] != f'"{hashlib.md5(data).hexdigest()}"':
                raise AssertionError(f"{tag}: PUT bk0/{key}'s ETag "
                                     f"{hdrs['ETag']}")
        t0 = time.monotonic()
        _pmap(put, list(large), RGW_LARGE_THREADS)
        wall = time.monotonic() - t0
        out["large_put"] = {"MBps": d["large"] * RGW_OBJ / wall / 1e6,
                            "wall_s": wall}
        wall = self._get_all("bk0", large, RGW_LARGE_THREADS, "healthy")
        out["large_get"] = {"MBps": d["large"] * RGW_OBJ / wall / 1e6,
                            "wall_s": wall}
        t0 = time.monotonic()
        _pmap(put, list(small), RGW_SMALL_THREADS)
        wall = time.monotonic() - t0
        out["small_put"] = {"per_s": d["small"] / wall, "wall_s": wall}
        pages, per_page = self._list("bk0", "healthy")
        if pages != 2:
            raise AssertionError(f"{tag}: bk0 listed in {pages} pages")
        out["list"] = {"pages": pages, "s_per_page": per_page,
                       "keys": len(self.model["bk0"])}
        # -- multipart: 8 x 8 MiB parts ---------------------------------------
        _s3_ok(s3("PUT", "/bkmp"), 200, "PUT bkmp")
        parts = [self.rng.bytes(RGW_PART_B) for _ in range(d["parts"])]
        t0 = time.monotonic()
        body = _s3_ok(s3("POST", "/bkmp/big?uploads"), 200, "initiate")[2]
        uid = re.search(rb"<UploadId>([^<]+)<", body).group(1).decode()
        for n, part in enumerate(parts, start=1):
            _s3_ok(s3("PUT", f"/bkmp/big?partNumber={n}&uploadId={uid}",
                      part), 200, f"part {n}")
        body = _s3_ok(s3("POST", f"/bkmp/big?uploadId={uid}", (
            "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber></Part>"
                for n in range(1, len(parts) + 1)) +
            "</CompleteMultipartUpload>").encode()), 200, "complete")[2]
        out["multipart_s"] = time.monotonic() - t0
        etag = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                    for p in parts)).hexdigest()
        if f"&quot;{etag}-{len(parts)}&quot;".encode() not in body:
            raise AssertionError(f"{tag}: multipart ETag {body[:300]!r}")
        self.model["bkmp"] = {"big": b"".join(parts)}
        self.etags[("bkmp", "big")] = f"{etag}-{len(parts)}"
        self._get_all("bkmp", ["big"], 1, "healthy")
        # -- bkv: versions, delete markers, then lifecycle on lc/ -------------
        _s3_ok(s3("PUT", "/bkv"), 200, "PUT bkv")
        _s3_ok(s3("PUT", "/bkv?versioning", RGW_VERS_ON), 200, "versioning")
        self.model["bkv"] = {}
        self.versions["bkv"] = {}
        for key in ("doc", "lc/doc"):
            stack = []
            for _ in range(3):
                data = self.rng.bytes(RGW_VERSION_B)
                vid = _s3_ok(s3("PUT", f"/bkv/{key}", data), 200,
                             f"PUT bkv/{key}")[1]["x-amz-version-id"]
                stack.insert(0, (vid, data))
            hdrs = _s3_ok(s3("DELETE", f"/bkv/{key}"), 204,
                          f"DELETE bkv/{key}")[1]
            if hdrs.get("x-amz-delete-marker") != "true":
                raise AssertionError(f"{tag}: DELETE bkv/{key}: {hdrs}")
            stack.insert(0, (hdrs["x-amz-version-id"], None))
            self.versions["bkv"][key] = stack
        self._versions("healthy")
        _s3_ok(s3("PUT", "/bkv?lifecycle", RGW_LC), 200, "lifecycle")
        t0 = time.monotonic()
        acted = self.gw.lc_tick(time.time() + 2 * 86400)
        out["lc_tick_s"] = time.monotonic() - t0
        if acted != 3:
            raise AssertionError(f"{tag}: lc_tick acted {acted} times")
        self.versions["bkv"]["lc/doc"] = self.versions["bkv"]["lc/doc"][:1]
        self._versions("after lc_tick")
        # -- Swift: TempAuth, then bk0's listing ------------------------------
        anon = self.client("", "")
        hdrs = _s3_ok(anon("GET", "/auth/v1.0", headers={
            "X-Auth-User": RGW_USER, "X-Auth-Key": self.keys[RGW_USER]}),
            204, "TempAuth")[1]
        t0 = time.monotonic()
        rows = json.loads(_s3_ok(anon(
            "GET", "/swift/v1/bk0?format=json",
            headers={"X-Auth-Token": hdrs["X-Auth-Token"]}), 200,
            "Swift listing")[2])
        out["swift_list_s"] = time.monotonic() - t0
        want = [{"name": k, "bytes": len(v),
                 "hash": hashlib.md5(v).hexdigest()}
                for k, v in sorted(self.model["bk0"].items())]
        if [{k: r[k] for k in ("name", "bytes", "hash")} for r in rows] != \
                want:
            raise AssertionError(f"{tag}: the Swift listing of bk0 differs "
                                 "from the S3 listing")
        # -- STS: a role, AssumeRole, a PUT with the temporary keys -----------
        self.gw.sts.create_role("smoke", [RGW_USER])
        arn = "arn%3Aaws%3Aiam%3A%3A%3Arole%2Fsmoke"
        body = _s3_ok(s3("POST", f"/?Action=AssumeRole&RoleArn={arn}&"
                         "DurationSeconds=900"), 200, "AssumeRole")[2]
        akid, secret, token = (re.search(rf"<{f}>([^<]+)<".encode(),
                                         body).group(1).decode()
                               for f in ("AccessKeyId", "SecretAccessKey",
                                         "SessionToken"))
        tmp = self.client(akid, secret, token)
        self.model["bksts"] = {"obj": self.rng.bytes(RGW_SMALL_B)}
        _s3_ok(tmp("PUT", "/bksts"), 200, "STS PUT bksts")
        _s3_ok(tmp("PUT", "/bksts/obj", self.model["bksts"]["obj"]), 200,
               "STS PUT bksts/obj")
        if _s3_ok(tmp("GET", "/bksts/obj"), 200, "STS GET")[2] != \
                self.model["bksts"]["obj"]:
            raise AssertionError(f"{tag}: STS GET differs")
        other = self.client(RGW_OTHER, self.keys[RGW_OTHER])
        _s3_ok(other("POST", f"/?Action=AssumeRole&RoleArn={arn}"), 403,
               "the untrusted caller's AssumeRole")
        # -- notifications: 16 events in order to the smoke's receiver --------
        out["notify"] = self.notifications()
        out["launches"] = bm.LAUNCHES["gf_matmul"] - l0
        out["index"] = self._check_index("healthy")
        out["before_s"] = time.monotonic() - t_leg
        self._counts(tag)

    def notifications(self) -> dict:
        tag, s3 = "phase 19 (f) rgw", self.s3
        rcv = _Receiver()
        try:
            _s3_ok(s3("POST", "/?Action=CreateTopic&Name=t0&push-endpoint="
                      f"http%3A%2F%2F127.0.0.1%3A{rcv.port}%2F"), 200,
                   "CreateTopic")
            _s3_ok(s3("PUT", "/bkn"), 200, "PUT bkn")
            _s3_ok(s3("PUT", "/bkn?notification", RGW_NOTIF), 200,
                   "notification config")
            keys = [f"n{i}" for i in range(RGW_EVENTS // 2)]
            want, sent = [], []
            for method in ("PUT", "DELETE"):
                for key in keys:
                    data = self.rng.bytes(RGW_SMALL_B) if method == "PUT" \
                        else b""
                    sent.append(time.monotonic())
                    _s3_ok(s3(method, f"/bkn/{key}", data),
                           200 if method == "PUT" else 204,
                           f"{method} bkn/{key}")
                    want.append((key, "s3:ObjectCreated:Put" if method ==
                                 "PUT" else "s3:ObjectRemoved:Delete"))
            end = time.monotonic() + 30.0
            while len(rcv.events) < len(want) and time.monotonic() < end:
                time.sleep(0.005)
            got = [(e["Records"][0]["s3"]["object"]["key"],
                    e["Records"][0]["eventName"]) for _, e in rcv.events]
            if got != want:
                raise AssertionError(f"{tag}: events {got}, not {want}")
            lat = [(t - s) * 1e3 for (t, _), s in zip(rcv.events, sent)]
        finally:
            rcv.close()
        self.model["bkn"] = {}
        self.gone["bkn"] = keys
        p50, p99 = _pcts(lat)
        return {"events": len(got), "p50_ms": p50, "p99_ms": p99}

    # -- while the victim is down --------------------------------------------
    def degraded(self) -> None:
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm

        l0 = bm.LAUNCHES["gf_matmul"]
        large = [k for k in self.model["bk0"] if k.startswith("l/")]
        small = [k for k in self.model["bk0"]
                 if k.startswith("s/")][:self.depth["degraded_small"]]
        wall = self._get_all("bk0", large, RGW_LARGE_THREADS, "degraded")
        self.out["degraded_get"] = {"MBps": len(large) * RGW_OBJ / wall / 1e6,
                                    "wall_s": wall}
        wall = self._get_all("bk0", small, RGW_SMALL_THREADS, "degraded")
        self.out["degraded_small_get"] = {"per_s": len(small) / wall,
                                          "wall_s": wall}
        self.out["launches_degraded"] = bm.LAUNCHES["gf_matmul"] - l0

    # -- after the recovery to clean ------------------------------------------
    def after_clean(self) -> None:
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rgw import SWALLOWED

        tag, out, s3 = "phase 19 (f) rgw", self.out, self.s3
        l0 = bm.LAUNCHES["gf_matmul"]
        t_leg = time.monotonic()
        large = [k for k in self.model["bk0"] if k.startswith("l/")]
        small = [k for k in self.model["bk0"] if k.startswith("s/")]
        wall = self._get_all("bk0", large, RGW_LARGE_THREADS, "after clean")
        out["clean_get"] = {"MBps": len(large) * RGW_OBJ / wall / 1e6,
                            "wall_s": wall}
        wall = self._get_all("bk0", small, RGW_SMALL_THREADS, "after clean")
        out["clean_small_get"] = {"per_s": len(small) / wall, "wall_s": wall}
        self._get_all("bkmp", ["big"], 1, "after clean")
        self._get_all("bksts", ["obj"], 1, "after clean")
        self._versions("after clean")
        for bucket in ("bk0", "bkmp", "bksts", "bkn"):
            self._list(bucket, "after clean")
        out["index_after"] = self._check_index("after clean")
        parts = [o for o in self.gw.io.list_objects()
                 if o.startswith(".part.")]
        if parts:
            raise AssertionError(f"{tag}: {len(parts)} multipart parts left")
        self._counts(tag)
        # -- then bk0's large objects and every other bucket go through S3;
        # bk0's small objects go with the pool ----------------------------
        t0 = time.monotonic()
        _pmap(lambda k: _s3_ok(s3("DELETE", f"/bk0/{k}"), 204,
                               f"DELETE bk0/{k}"), large, RGW_LARGE_THREADS)
        paths = [f"/{b}/{k}" for b in ("bkmp", "bksts")
                 for k in self.model[b]]
        paths += [f"/bkv/{key}?versionId={vid}"
                  for key, stack in self.versions["bkv"].items()
                  for vid, _ in stack]
        paths += ["/bkmp", "/bksts", "/bkv", "/bkn"]
        for path in paths:
            _s3_ok(s3("DELETE", path), 204, f"DELETE {path}")
        _s3_ok(s3("DELETE", "/bk0"), 409, "DELETE bk0 with its small objects")
        body = _s3_ok(s3("GET", "/"), 200, "ListBuckets")[2]
        if re.findall(rb"<Bucket><Name>([^<]+)<", body) != [b"bk0"]:
            raise AssertionError(f"{tag}: buckets left: {body[:300]!r}")
        for key in large:
            del self.model["bk0"][key]
        self.gone["bk0"] = large
        self._list("bk0", "after the deletes")
        out["index_deleted"] = self._check_index("after the deletes",
                                                 ["bk0"])
        out["deleted"] = len(large) + len(paths)
        out["delete_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        self.close()
        self._counts(tag)
        rc, outs, _ = self.r.mon_command({
            "prefix": "osd pool delete", "pool": RGW_POOL,
            "yes_i_really_really_mean_it": True})
        if rc != 0:
            raise AssertionError(f"{tag}: {RGW_POOL} delete: {outs}")
        _wait(self.c, lambda: RGW_POOL not in
              self.c.mon.osdmap.pool_names.values() and
              _all_clean(self.c, self.r), f"the PGs after {RGW_POOL}'s "
              "delete", tag=tag)
        out["shutdown_s"] = time.monotonic() - t0
        out["launches_after"] = bm.LAUNCHES["gf_matmul"] - l0
        out["after_s"] = time.monotonic() - t_leg
        out["swallowed"] = sum(SWALLOWED.values()) - self.swallowed0
        launches = (out["launches"], out["launches_degraded"],
                    out["launches_after"])
        if any(launches):
            raise AssertionError(f"{tag}: K1 launched {launches} times in "
                                 "the rgw leg")


def print_rgw(ro: dict, name_power: str) -> None:
    tag, d = "phase 19 (f) rgw", ro["depth"]
    lp, lg, sp, ls = (ro["large_put"], ro["large_get"], ro["small_put"],
                      ro["list"])
    print(f"{tag}: gateway gw0 (SigV4, pool {RGW_POOL} made by it: "
          f"replicated, size {REP_SIZE}, pg_num 32, 8 index shards) up in "
          f"{ro['gateway_s']:.3f} s; bk0: {d['large']} x {RGW_OBJ} B PUT by "
          f"{RGW_LARGE_THREADS} threads at {lp['MBps']:.1f} MB/s "
          f"({lp['wall_s']:.3f} s), GET == the model (ETag == md5) at "
          f"{lg['MBps']:.1f} MB/s ({lg['wall_s']:.3f} s); {d['small']} x "
          f"{RGW_SMALL_B} B PUT by {RGW_SMALL_THREADS} threads at "
          f"{sp['per_s']:.1f} PUTs/s ({sp['wall_s']:.3f} s); ListObjectsV2 "
          f"max-keys {d['max_keys']}: {ls['keys']} keys in {ls['pages']} "
          f"pages == the model, {ls['s_per_page']:.3f} s per page on the "
          f"host clock on {name_power}")
    nt = ro["notify"]
    print(f"{tag}: multipart {d['parts']} x {RGW_PART_B} B in "
          f"{ro['multipart_s']:.3f} s (ETag md5 of the part md5s -"
          f"{d['parts']}); bkv: 2 keys x 3 versions + a delete marker, "
          f"?versions and every versionId == the model; NoncurrentDays 1 "
          f"on lc/, lc_tick(now + 2 days) removed 3 versions in "
          f"{ro['lc_tick_s']:.3f} s; Swift TempAuth listing of bk0 == the "
          f"S3 listing ({ro['swift_list_s']:.3f} s); STS AssumeRole + PUT/GET "
          f"with the temporary keys, the untrusted caller 403; "
          f"{nt['events']} notification events in order: delivery p50 "
          f"{nt['p50_ms']:.3f} ms, p99 {nt['p99_ms']:.3f} ms; index shards "
          f"== the model {ro['index']}; K1 launches {ro['launches']}; "
          f"{ro['before_s']:.3f} s before the kill on {name_power}")
    dg, ds = ro["degraded_get"], ro["degraded_small_get"]
    print(f"{tag}: victim down: {d['large']} x {RGW_OBJ} B GET == the model "
          f"at {dg['MBps']:.1f} MB/s ({dg['wall_s']:.3f} s), "
          f"{d['degraded_small']} small at {ds['per_s']:.1f} GETs/s; K1 "
          f"launches {ro['launches_degraded']} on {name_power}")
    cg, cs = ro["clean_get"], ro["clean_small_get"]
    print(f"{tag}: after the kill, out and clean: {d['large']} x {RGW_OBJ} B "
          f"GET == the model at {cg['MBps']:.1f} MB/s ({cg['wall_s']:.3f} "
          f"s), {d['small']} small at {cs['per_s']:.1f} GETs/s, the "
          f"multipart object, every version, listings and index shards == "
          f"the model {ro['index_after']}; {ro['deleted']} DELETEs (bk0's "
          f"large objects, then every other object, version and bucket; "
          f"bk0's listing and index shards == the model "
          f"{ro['index_deleted']}) in {ro['delete_s']:.3f} s, the gateway "
          f"shut down and {RGW_POOL} removed with bk0's small objects in "
          f"{ro['shutdown_s']:.3f} s; K1 launches {ro['launches_after']}; "
          f"swallowed {ro['swallowed']}; {ro['after_s']:.3f} s after the "
          f"recovery on {name_power}")


# -- phase 19 (f): CephFS with its file data on the EC pool ----------------
FS_META = "cephfs_metadata"      # Ceph's default pool names: the MDS makes
FS_DATA = "cephfs_data"          # the metadata pool; the data pool is EC
#: Ceph's default file layout (file_layout_t: 4 MiB objects, no striping)
FS_LAYOUT = {"stripe_unit": 4 << 20, "stripe_count": 1,
             "object_size": 4 << 20}
FS_PG_NUM = 8                    # cephfs_data's PGs: cut from phase 19's 32
                                 # (the smoke's wall, PERF.md 4)
FS_LARGE = 16                    # 4 MiB files, 8 in each of two directories
FS_LARGE_B = 4 << 20
FS_SMALL = 32                    # 4 KiB files in one directory, two writers;
#                                  cut from 256, then 64 (the smoke's wall,
#                                  PERF.md 4)
FS_SMALL_B = 4 << 10
FS_EXCL_B = 1 << 20              # the file of the cap revoke
#: tests/test_mds_failover.py:17's beacons
FS_BEACON = {"mds_beacon_interval": 0.2, "mds_beacon_grace": 1.0}
FS_TAKEOVER_ROUNDS = 40          # MDSThrasher.wait_takeover's default
FS_ATTEMPT_S = 1.0               # the in-flight create's reply slice


class FsLeg:
    """Phase 19 (f)'s file system (the port's `fs`): CephFS on EC as the
    Ceph documentation lays it out (`doc/cephfs/createfs.rst`): the
    metadata on a replicated pool the MDS makes (`cephfs_metadata`, size
    3, pg_num 32), the file data on an EC pool made before the first MDS
    starts (`cephfs_data`, phase 19's `tpu` k=8 m=4 profile, pg_num
    `FS_PG_NUM`).
    One active rank and one standby, beaconing every 0.2 s with a 1 s
    grace; two clients; every file in Ceph's default layout (4 MiB
    objects).  `before_kill` after RgwLeg's, `degraded` while the victim
    is down, `after_clean` after RgwLeg's; every byte read is held to a
    host model by sha256.  K1 is counted by kind (encode, decode, repair)
    for `cephfs_data` from `before_kill` to `after_clean`, the recovery
    between included.  `profile`, `pg_num`, `large` and `small` take a
    rehearsal's smaller cluster and counts."""

    def __init__(self, c, r, large: int = FS_LARGE, small: int = FS_SMALL,
                 profile: str = "tpu_k8m4", pg_num: int = CLUSTER_PG_NUM):
        self.c, self.r = c, r
        self.profile, self.pg_num = profile, pg_num
        self.depth = {"large": large, "small": small}
        self.rng = np.random.default_rng(SEED + 300)
        self.out: dict = {"depth": self.depth}
        self.model: dict = {}            # path -> bytes
        self.clients: list = []
        self.sb = None
        self._split_cm = self.split = None
        self._cfg: dict = {}

    # -- helpers --------------------------------------------------------------
    def _write(self, fs, path: str, data: bytes) -> None:
        fh = fs.open(path, "w", layout=FS_LAYOUT)
        fh.write(0, data)
        fh.close()

    def _read(self, fs, path: str) -> bytes:
        fh = fs.open(path, "r")
        try:
            return fh.read(0)
        finally:
            fh.close()

    def _pwrite(self, lists) -> float:
        """Each client writes its list of paths in a thread of its own."""
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(lists)) as ex:
            for f in [ex.submit(lambda fs=fs, ps=ps: [
                    self._write(fs, p, self.model[p]) for p in ps])
                      for fs, ps in zip(self.clients, lists)]:
                f.result()
        return time.monotonic() - t0

    def _check_all(self, what: str) -> dict:
        """Every file read back equal to the model (sha256), the large
        ones and the small ones each split over the two clients."""
        tag = "phase 19 (f) fs"
        out = {}
        large = [p for p in self.model if len(self.model[p]) >= FS_EXCL_B]
        small = [p for p in self.model if p not in large]
        for kind, paths in (("large", large), ("small", small)):
            halves = [paths[0::2], paths[1::2]]

            def check(fs, ps):
                for p in ps:
                    got = self._read(fs, p)
                    if _sha(got) != _sha(self.model[p]):
                        raise AssertionError(f"{tag}: {what} read of {p} "
                                             "differs from the model")
            t0 = time.monotonic()
            with ThreadPoolExecutor(2) as ex:
                for f in [ex.submit(check, fs, ps)
                          for fs, ps in zip(self.clients, halves)]:
                    f.result()
            wall = time.monotonic() - t0
            nbytes = sum(len(self.model[p]) for p in paths)
            out[kind] = {"files": len(paths), "wall_s": wall,
                         "MBps": nbytes / wall / 1e6,
                         "per_s": len(paths) / wall}
        return out

    def _k1(self) -> dict:
        pid = self.r.pool_lookup(FS_DATA)
        return dict(self.split["pools"].get(pid, {}))

    def close(self) -> None:
        """Take K1's counting wrappers off and the beacon settings back
        (a no-op after after_clean)."""
        from ceph_tpu_torch.common.options import global_config

        if self._split_cm is not None:
            self._split_cm.__exit__(None, None, None)
            self._split_cm = None
        for k, v in self._cfg.items():
            global_config().set(k, v)
        self._cfg = {}

    # -- the hooks --------------------------------------------------------------
    def before_kill(self) -> None:
        from ceph_tpu_torch.common.options import global_config
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.fs import SWALLOWED, CephFS
        from ceph_tpu_torch.fs.mds import CAP_EXCL

        tag, out, d = "phase 19 (f) fs", self.out, self.depth
        t_leg = time.monotonic()
        cfg = global_config()
        self._cfg = {k: cfg[k] for k in FS_BEACON}
        for k, v in FS_BEACON.items():
            cfg.set(k, v)
        self.swallowed0 = sum(SWALLOWED.values())
        # K1 by kind and pool from here to after_clean
        self._split_cm = k1_by_caller(bm)
        self.split = self._split_cm.__enter__()
        c, r = self.c, self.r
        t0 = time.monotonic()
        r.pool_create(FS_DATA, pg_num=self.pg_num, pool_type="erasure",
                      erasure_code_profile=self.profile)
        _wait(c, lambda: _all_clean(c, r), f"{FS_DATA}'s PGs peered",
              tag=tag)
        out["pool_s"] = time.monotonic() - t0
        c.start_mds(0)
        self.sb = c.start_mds_standby()
        c.wait_mds_active(0)
        _wait(c, lambda: bool(c.fsmap().standbys) and _all_clean(c, r),
              "the standby registered and the file system's pools peered",
              tag=tag)
        m = r.objecter.osdmap
        meta = m.pools[r.pool_lookup(FS_META)]
        data = m.pools[r.pool_lookup(FS_DATA)]
        if not meta.is_replicated() or meta.size != 3 or \
                meta.pg_num != 32 or data.is_replicated() or \
                data.pg_num != self.pg_num:
            raise AssertionError(f"{tag}: pools {meta} / {data}")
        out["up_s"] = time.monotonic() - t0
        out["mds_s"] = out["up_s"] - out["pool_s"]
        out["epoch_up"] = c.fsmap().epoch
        self.clients = [CephFS(c.rados()), CephFS(c.rados())]
        fa, fb = self.clients
        for dname in ("/fs/d0", "/fs/d1", "/fs/small"):
            fa.mkdirs(dname)
        # -- two clients write: the large files, then the small ones -----
        large = [f"/fs/d{i % 2}/f{i:02d}" for i in range(d["large"])]
        for p in large:
            self.model[p] = self.rng.bytes(FS_LARGE_B)
        wall = self._pwrite([large[0::2], large[1::2]])
        out["write"] = {"MBps": len(large) * FS_LARGE_B / wall / 1e6,
                        "wall_s": wall}
        small = [f"/fs/small/s{i:04d}" for i in range(d["small"])]
        for p in small:
            self.model[p] = self.rng.bytes(FS_SMALL_B)
        wall = self._pwrite([small[0::2], small[1::2]])
        out["creates"] = {"per_s": len(small) / wall, "wall_s": wall}
        out["healthy"] = self._check_all("healthy")
        # -- a 4 KiB overwrite mid-file: a read-modify-write on the pool ---
        p, off = large[0], FS_LARGE_B // 2 + 1000
        patch = self.rng.bytes(4096)
        t0 = time.monotonic()
        fh = fa.open(p, "r+")
        fh.write(off, patch)
        fh.close()
        out["rmw_s"] = time.monotonic() - t0
        self.model[p] = self.model[p][:off] + patch + \
            self.model[p][off + len(patch):]
        if self._read(fb, p) != self.model[p]:
            raise AssertionError(f"{tag}: the overwritten {p} differs")
        # -- a hardlink and a rename ---------------------------------------
        fa.link(large[-1], "/fs/d1/hard")
        self.model["/fs/d1/hard"] = self.model[large[-1]]
        st1, st2 = fa.stat(large[-1]), fb.stat("/fs/d1/hard")
        if st1["ino"] != st2["ino"] or st2.get("nlink") != 2:
            raise AssertionError(f"{tag}: the hardlink {st1} / {st2}")
        fb.rename(small[0], "/fs/d1/moved")
        self.model["/fs/d1/moved"] = self.model.pop(small[0])
        if fa.exists(small[0]):
            raise AssertionError(f"{tag}: {small[0]} still there")
        # -- a cap revoke: a writer holds CAP_EXCL, a reader opens ---------
        w = fa.open("/fs/excl", "w", layout=FS_LAYOUT)
        if not w.caps & CAP_EXCL:
            raise AssertionError(f"{tag}: the writer got caps {w.caps}")
        self.model["/fs/excl"] = self.rng.bytes(FS_EXCL_B)
        w.write(0, self.model["/fs/excl"])          # buffered under EXCL
        t0 = time.monotonic()
        rd = fb.open("/fs/excl", "r")               # revokes the EXCL
        out["revoke_s"] = time.monotonic() - t0
        if rd.size != FS_EXCL_B or w.caps & CAP_EXCL:
            raise AssertionError(f"{tag}: after the revoke the reader saw "
                                 f"{rd.size} B, the writer holds {w.caps}")
        if rd.read(0) != self.model["/fs/excl"]:
            raise AssertionError(f"{tag}: the reader read other bytes")
        rd.close()
        w.close()
        out["k1_before"] = self._k1()
        out["before_s"] = time.monotonic() - t_leg

    def degraded(self) -> None:
        from ceph_tpu_torch.fs.mds import dir_obj
        from ceph_tpu_torch.msg.messages import MClientReply
        from ceph_tpu_torch.testing.thrasher import MDSThrasher

        tag, out, c = "phase 19 (f) fs", self.out, self.c
        t_leg = time.monotonic()
        k1_0 = self._k1()
        out["degraded"] = self._check_all("degraded")
        k1_1 = self._k1()
        out["degraded_decodes"] = k1_1.get("decode", 0) - \
            k1_0.get("decode", 0)
        # -- the active MDS dies under a create in flight ------------------
        fa = self.clients[0]
        parent = fa.stat("/fs")["ino"]
        meta = self.r.open_ioctx(FS_META)
        fa._session.ATTEMPT_SLICE = FS_ATTEMPT_S
        c.network.filter = lambda src, dst, msg: not (
            src == "mds.0" and isinstance(msg, MClientReply))
        result, errors = [], []

        def create():
            try:
                result.append(fa._session.call("create", {
                    "path": "/fs/inflight", "layout": FS_LAYOUT,
                    "truncate": True}, timeout=60.0))
            except Exception as ex:      # noqa: BLE001
                errors.append(ex)

        t = threading.Thread(target=create, daemon=True)
        t.start()
        try:
            _wait(c, lambda: "inflight" in meta.get_omap_vals(
                dir_obj(parent))[0], "the in-flight create's dentry",
                timeout=30.0, tag=tag)
        finally:
            gid_dead = c.fsmap().ranks[0].gid
            th = MDSThrasher(SimClock(c, 0.0))
            if c._sim_now is not None:
                # phase 19's sim clock, forward only: the beacons are
                # stamped with it, so the thrasher goes on from where it
                # stands (without one it seeds past the host clock)
                th.now = c._sim_now
            sim0 = th.now
            t0 = time.monotonic()
            th.kill_rank(0)
            c.network.filter = None
        th.wait_takeover(0, timeout_rounds=FS_TAKEOVER_ROUNDS)
        out["takeover_s"] = time.monotonic() - t0
        out["takeover_sim_s"] = th.now - sim0
        t.join(60.0)
        if t.is_alive() or errors or not result:
            raise AssertionError(f"{tag}: the in-flight create never "
                                 f"completed ({errors})")
        info = c.fsmap().ranks[0]
        if info.gid == gid_dead or info.gid != self.sb.gid or \
                info.state != "active":
            raise AssertionError(f"{tag}: rank 0 after the kill: {info}")
        # exactly once: the replayed create answered from the table, and
        # the next create takes the next ino
        fh = fa.open("/fs/after", "w", layout=FS_LAYOUT)
        fh.close()
        ino, ino_after = result[0]["ino"], fa.stat("/fs/after")["ino"]
        if fa.stat("/fs/inflight")["ino"] != ino or ino_after != ino + 1 \
                or fa.listdir("/fs").count("inflight") != 1:
            raise AssertionError(f"{tag}: the create landed as ino {ino}, "
                                 f"the next as {ino_after}")
        self.model["/fs/inflight"] = self.model["/fs/after"] = b""
        out["inflight_ino"] = ino
        out["epoch_takeover"] = c.fsmap().epoch
        out["k1_degraded"] = self._k1()
        out["degraded_s"] = time.monotonic() - t_leg

    def after_clean(self, clean_s: dict | None = None) -> None:
        from ceph_tpu_torch.fs import SWALLOWED
        from ceph_tpu_torch.fs.client import fs_data_obj

        tag, out, c, r = "phase 19 (f) fs", self.out, self.c, self.r
        t_leg = time.monotonic()
        out["after"] = self._check_all("after clean")
        rc, outs, st = r.mon_command({"prefix": "fs status"})
        ranks = {int(k): v for k, v in (st or {}).get("ranks", {}).items()}
        if rc != 0 or ranks.get(0, {}).get("state") != "active" or \
                ranks[0].get("gid") != self.sb.gid or st["standbys"]:
            raise AssertionError(f"{tag}: fs status {rc} {outs} {st}")
        out["fs_status"] = outs
        out["epoch_after"] = st["epoch"]
        if not out["epoch_up"] < out["epoch_takeover"] <= st["epoch"]:
            raise AssertionError(f"{tag}: fsmap epochs {out['epoch_up']}, "
                                 f"{out['epoch_takeover']}, {st['epoch']}")
        # -- every data object's shards == the plain version's encode -------
        pid = r.pool_lookup(FS_DATA)
        width = K * STRIPE_UNIT          # the OSD pads to a full stripe
        objs = {}
        for p, data in self.model.items():
            if data:
                objs[fs_data_obj(self.clients[0].stat(p)["ino"], 0)] = \
                    data + bytes(-len(data) % width)
        listed = set(r.open_ioctx(FS_DATA).list_objects())
        if listed != set(objs):
            raise AssertionError(f"{tag}: {FS_DATA} holds {len(listed)} "
                                 f"objects, the model {len(objs)}")
        t0 = time.monotonic()
        out["shards_checked"] = _ec_shards_plain(c, pid, objs, {}, tag)
        out["shards_s"] = time.monotonic() - t0
        out["clean_s"] = (clean_s or {}).get(FS_DATA)
        # -- the file system goes: its daemons, then both pools -------------
        out["k1"] = self._k1()
        self.close()
        for sb in list(c.standbys.values()):
            sb.shutdown()
        for mds in list(c.mdss.values()):
            mds.shutdown()
        c.standbys.clear()
        c.mdss.clear()
        for pool in (FS_DATA, FS_META):
            rc, outs, _ = r.mon_command({
                "prefix": "osd pool delete", "pool": pool,
                "yes_i_really_really_mean_it": True})
            if rc != 0:
                raise AssertionError(f"{tag}: {pool} delete: {outs}")
        _wait(c, lambda: not {FS_DATA, FS_META} &
              set(c.mon.osdmap.pool_names.values()) and _all_clean(c, r),
              "the PGs after the file system's pools went", tag=tag)
        out["faults"] = {"swallowed": sum(SWALLOWED.values()) -
                         self.swallowed0,
                         "dispatch_errors": c.network.dispatch_errors}
        if any(out["faults"].values()):
            raise AssertionError(f"{tag}: fault counts {out['faults']}")
        k1 = out["k1"]
        if not (k1.get("encode") and k1.get("decode") and k1.get("repair")):
            raise AssertionError(f"{tag}: K1 launches for {FS_DATA} {k1}")
        out["after_s"] = time.monotonic() - t_leg
        out["leg_s"] = out["before_s"] + out["degraded_s"] + out["after_s"]


def print_fs(fo: dict, name_power: str) -> None:
    tag, d = "phase 19 (f) fs", fo["depth"]
    w, cr = fo["write"], fo["creates"]
    print(f"{tag}: {FS_META} (replicated, size 3, pg_num 32, made by the "
          f"MDS) and {FS_DATA} (EC, phase 19's profile, made first and "
          f"peered in {fo['pool_s']:.3f} s); mds.0 active and a standby "
          f"registered {fo['mds_s']:.3f} s later; "
          f"{d['large']} x {FS_LARGE_B} B files (Ceph's default layout, "
          f"4 MiB objects) by two clients at {w['MBps']:.1f} MB/s "
          f"({w['wall_s']:.3f} s); {d['small']} x {FS_SMALL_B} B files "
          f"created at {cr['per_s']:.1f} files/s ({cr['wall_s']:.3f} s) "
          f"on {name_power}")
    for half in ("healthy", "degraded", "after"):
        h = fo[half]
        print(f"{tag}: {half}: every file == the model (sha256): large "
              f"{h['large']['files']} at {h['large']['MBps']:.1f} MB/s "
              f"({h['large']['wall_s']:.3f} s), small {h['small']['files']} "
              f"at {h['small']['per_s']:.1f} files/s "
              f"({h['small']['wall_s']:.3f} s) on {name_power}")
    print(f"{tag}: a 4 KiB overwrite mid-file (EC read-modify-write) "
          f"{fo['rmw_s']:.3f} s; a hardlink and a rename; a reader's open "
          f"revoked the writer's CAP_EXCL and read its buffered bytes in "
          f"{fo['revoke_s']:.3f} s on {name_power}")
    print(f"{tag}: mds.0 killed under an in-flight create: the standby "
          f"active {fo['takeover_s']:.3f} s after the kill "
          f"({fo['takeover_sim_s']:.1f} s of phase 19's sim clock); the "
          f"create landed once (ino {fo['inflight_ino']:#x}, the next "
          f"create's the next ino); fsmap epochs {fo['epoch_up']} -> "
          f"{fo['epoch_takeover']} -> {fo['epoch_after']}; fs status "
          f"{fo['fs_status']!r} on {name_power}")
    k1 = fo["k1"]
    clean = fo["clean_s"]
    print(f"{tag}: K1 launches for {FS_DATA}: encode {k1.get('encode', 0)}, "
          f"decode {k1.get('decode', 0)} ({fo['degraded_decodes']} in the "
          f"degraded reads), repair {k1.get('repair', 0)}; {FS_DATA} osd out "
          f"to clean " + (f"{clean:.3f} s" if clean is not None else "n/a") +
          f"; {fo['shards_checked']} shards == the plain version's encode "
          f"({fo['shards_s']:.3f} s); faults {fo['faults']}; the leg "
          f"{fo['leg_s']:.1f} s (before {fo['before_s']:.1f}, degraded "
          f"{fo['degraded_s']:.1f}, after {fo['after_s']:.1f}) on "
          f"{name_power}")


# -- phase 19 (g): elastic pools -- the split, the reseed, the mgr, thrash ---

# the autoscaler's pool_bytes, weighted to the EC data pool as the
# reference's acceptance test (tests/test_ec_peering.py) weights it
ELASTIC_POOL_BYTES = {"ecpool": 1 << 30}
ELASTIC_STEP_S = 5.0             # sim s per tick: osd_mon_report_interval
ELASTIC_TICK_EVERY_S = 0.5       # host s between report ticks while waiting
THRASH_ROUNDS = 4                # cut from 8 (the smoke's wall with phase 22)
THRASH_WRITES = 2                # seeded 4 MiB objects between actions
THRASH_MIN = K + M               # min_in and min_live: full-width mappings


class SimClock:
    """One sim clock for (e)'s scrub ticks, (g)'s report ticks and the
    thrasher's.  A tick returns only once no live OSD would report a
    live heartbeat peer at a tick the thrasher's step (grace / 2 + 1)
    later: each has heard the tick's ping reply, or its window for the
    peer opened within that step (a peer that just came up).  So a peer
    busy mapping a burst of epochs under the GIL is never reported down
    by a clock that ran ahead of it.  The thrasher drives its ticks
    through this object (it passes every other attribute to the
    cluster)."""

    def __init__(self, c, now: float):
        self._c, self.now = c, now

    def __getattr__(self, name):
        return getattr(self._c, name)

    def tick(self, now: float | None = None) -> None:
        from ceph_tpu_torch.common.options import global_config

        c = self._c
        now = self.now if now is None else now
        self.now = max(self.now, now)
        c.tick(now)
        floor = now - global_config()["osd_heartbeat_grace"] / 2 + 1

        def heard() -> bool:
            live = set(c.osds)
            for d in list(c.osds.values()):
                with d._lock:
                    for p in d.heartbeat_peers() & live:
                        last = d._hb_last.get(p, d._hb_first.get(p, now))
                        if last < floor:
                            return False
            return True
        _wait(c, heard, "every ping reply of a tick", tag="phase 19 (g)")

    def step(self) -> None:
        self.tick(self.now + ELASTIC_STEP_S)


def _ec_shards_plain(c, pid: int, objs: dict, want: dict, tag: str) -> int:
    """Every shard of every object on its current acting OSD equals the
    plain version's encode (`want` caches it by object); returns the
    shards checked."""
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.osd import ec_backend, ecutil
    from ceph_tpu_torch.store import ObjectId

    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M),
                                      "technique": "reed_sol_van"},
                              device="cpu")
    sinfo = ecutil.StripeInfo(K, K * STRIPE_UNIT)
    m = c.mon.osdmap
    checked = 0
    for oid, data in objs.items():
        if oid not in want:
            want[oid] = ecutil.encode(sinfo, ec_cpu, data)
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        acting = m.pg_to_up_acting_osds(raw)[2]
        for s, osd in enumerate(acting):
            if osd not in c.osds:
                raise AssertionError(f"{tag}: {oid} shard {s} maps to "
                                     f"osd.{osd}, which is not running")
            got = c.osds[osd].store.read(ec_backend.pg_cid(pg),
                                         ObjectId(oid, shard=s))
            if got != want[oid][s]:
                raise AssertionError(f"{tag}: {oid} shard {s} on osd.{osd} "
                                     "differs from the plain version's encode")
            checked += 1
    return checked


def _read_all(io, objs: dict, tag: str) -> None:
    for oid, data in objs.items():
        if io.read(oid) != data:
            raise AssertionError(f"{tag}: {oid} reads back wrong")


def _placements(m, pid: int, oids) -> dict:
    out = {}
    for oid in oids:
        raw = m.object_locator_to_pg(oid, pid)
        out[oid] = list(m.pg_to_up_acting_osds(raw)[2])
    return out


@contextlib.contextmanager
def rebuild_paths():
    """Count, within the block, the full rebuilds EC recovery starts
    (gather k chunks across the old and new sets, decode, re-encode):
    those with no repair plan to take instead (a pgp_num reseed moves
    more shards of a PG than m, which no compiled repair covers: the
    full rebuild is its designed path), and the compiled repairs that
    raised a plan or code error and so fell back to it, a fault.  The
    rest fell back on a gap: a helper's chunk read failed (an injected
    EIO) or its OSD died mid-gather."""
    from ceph_tpu_torch.ec.interface import ErasureCodeError
    from ceph_tpu_torch.ec.repairc import RepairPlanError
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.ec_peering import ECPGPeering

    counts = {"full": 0, "no_plan": 0, "repair_errors": 0}
    try_plan, full = (ECPGPeering._try_subchunk_rebuild,
                      ECPGPeering._rebuild_full)
    repair = ecutil.compiled_repair_streams

    def planned(self, *args, **kwargs):
        ok = try_plan(self, *args, **kwargs)
        counts["no_plan"] += not ok
        return ok

    def counted(self, *args, **kwargs):
        counts["full"] += 1
        return full(self, *args, **kwargs)

    def repaired(*args, **kwargs):
        try:
            return repair(*args, **kwargs)
        except (RepairPlanError, ErasureCodeError):
            counts["repair_errors"] += 1
            raise

    ECPGPeering._try_subchunk_rebuild = planned
    ECPGPeering._rebuild_full = counted
    ecutil.compiled_repair_streams = repaired
    try:
        yield counts
    finally:
        ECPGPeering._try_subchunk_rebuild = try_plan
        ECPGPeering._rebuild_full = full
        ecutil.compiled_repair_streams = repair


def _elastic_faults(c, mgr, tag: str, paths: dict) -> dict:
    _faults(c, tag)
    counts = {"repair_errors": paths["repair_errors"],
              "queued_op_failures": _perf_sum(c, "queued_op_failures"),
              "recovery_push_errors": _perf_sum(c, "recovery_push_errors"),
              "tick_errors": _perf_sum(c, "tick_errors"),
              "dispatch_errors": c.network.dispatch_errors,
              "reaped": len(c.reaped),
              "mgr_failed_commands": mgr.failed_commands}
    if any(counts.values()):
        raise AssertionError(f"{tag}: fault counts {counts}")
    return counts


def split_reseed(c, r, io, clock, objs: dict, want: dict,
                 paths: dict) -> dict:
    """(g1): the mgr's autoscaler splits `ecpool` to its target, its
    next tick reseeds pgp_num, then one balancer round on K3."""
    from ceph_tpu_torch.common.options import global_config
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.repairc import compiler as repairc_compiler
    from ceph_tpu_torch.mgr.pg_autoscaler import next_pow2
    from ceph_tpu_torch.osd.peering import CLEAN

    tag = "phase 19 (g1)"
    pid, rpid = r.pool_lookup("ecpool"), r.pool_lookup("reppool")
    pool_bytes = {r.pool_lookup(n): b for n, b in ELASTIC_POOL_BYTES.items()}
    # the host time of each OSD's _update_pgs, per map epoch
    update_s: list = []
    for d in list(c.osds.values()):
        def timed(d=d, orig=d._update_pgs):
            t0 = time.monotonic()
            orig()
            update_s.append((d.whoami, d.osdmap.epoch,
                             time.monotonic() - t0))
        d._update_pgs = timed
    mgr = c.start_mgr()
    mgr.start_pg_autoscaler()
    mgr.start_progress()
    # insights from the start of (g): its window's first sample of the
    # cluster log's counts is taken here, (g3) reads the window
    mgr.start_insights()
    _wait(c, lambda: mgr.osdmap.epoch == c.mon.osdmap.epoch,
          "the mgr's first map", tag=tag)
    mgr.observability_tick()

    def state() -> str:
        m = c.mon.osdmap
        prim = _primaries(c, r)
        busy = sum(1 for st in prim.values()
                   if st.peering is None or st.peering.phase != CLEAN or
                   st.recovering or st.backfilling)
        return (f"e{m.epoch}, OSDs at e{min(d.osdmap.epoch for d in c.osds.values())}"
                f"..e{max(d.osdmap.epoch for d in c.osds.values())}, "
                f"pg_temp {len(m.pg_temp)}, {len(prim)} primaries, {busy} "
                f"not clean, recovering {sum(d.pgs_recovering() for d in c.osds.values())}, "
                f"_update_pgs {len(update_s)} calls "
                f"{sum(x for _o, _e, x in update_s):.1f} s")

    def settle(what: str, pred=None) -> None:
        # report ticks while waiting: progress samples the pg dump they fill
        last = shown = 0.0
        t0 = time.monotonic()
        end = t0 + CLUSTER_TIMEOUT_S
        while time.monotonic() < end:
            _faults(c, tag)
            if _all_clean(c, r) and (pred is None or pred()):
                return
            if time.monotonic() - last >= ELASTIC_TICK_EVERY_S:
                clock.step()
                mgr.progress_tick()
                last = time.monotonic()
            if time.monotonic() - shown >= 15.0:
                shown = time.monotonic()
                print(f"{tag}: {what}: {shown - t0:.1f} s, {state()}",
                      flush=True)
            time.sleep(0.01)
        raise AssertionError(f"{tag}: {what} within {CLUSTER_TIMEOUT_S:.0f} "
                             f"s: {state()}")

    def perf():
        return {k: _perf_sum(c, k) for k in ("recovery_bytes_rebuilt",
                                             "recovery_bytes_read",
                                             "push_in", "push_in_bytes")}

    out: dict = {}
    # -- the split: pg_num grows, objects move inside each OSD -------------
    # the target for the EC pool's whole share: 32 -> 128 with 15 OSDs in
    m = c.mon.osdmap
    n_in = sum(1 for o in range(m.max_osd) if m.is_in(o))
    target = next_pow2(int(n_in * global_config()["mon_target_pg_per_osd"]
                           / (K + M)))
    p0, l0, e0 = perf(), bm.LAUNCHES["gf_matmul"], m.epoch
    t0 = time.monotonic()
    sent = mgr.autoscale_tick(pool_bytes)
    out["plan"] = mgr.pg_autoscaler.status()
    plan = {p["pool_name"]: p for p in out["plan"]}
    if sent != 1 or plan["ecpool"]["target"] != target or \
            not plan["ecpool"]["would_adjust"] or \
            plan["reppool"]["would_adjust"]:
        raise AssertionError(f"{tag}: the autoscaler's plan {out['plan']} "
                             f"({sent} commands), not {target} for ecpool")
    settle("the split", lambda: c.mon.osdmap.pools[pid].pg_num == target)
    out["split_s"] = time.monotonic() - t0
    _read_all(io, objs, tag)
    p1 = perf()
    out["split_epochs"] = c.mon.osdmap.epoch - e0
    out["split_launches"] = bm.LAUNCHES["gf_matmul"] - l0
    if any(p1[k] != p0[k] for k in p0):
        raise AssertionError(f"{tag}: the split moved data between OSDs "
                             f"({p0} -> {p1})")
    # -- the reseed: pgp_num follows, data moves to the new placements -----
    before = _placements(c.mon.osdmap, pid, objs)
    l0, e0 = bm.LAUNCHES["gf_matmul"], c.mon.osdmap.epoch
    comp0 = dict(repairc_compiler.COMPILES)
    t0 = time.monotonic()
    sent = mgr.autoscale_tick(pool_bytes)
    if sent != 1:
        raise AssertionError(f"{tag}: the reseed tick sent {sent} commands")
    settle("the reseed", lambda: c.mon.osdmap.pools[pid].pgp_num ==
           target and not c.mon.osdmap.pg_temp)
    out["reseed_s"] = time.monotonic() - t0
    out["reseed_epochs"] = c.mon.osdmap.epoch - e0
    p2 = perf()
    after = _placements(c.mon.osdmap, pid, objs)
    out["shards_moved"] = sum(a != b for oid in objs
                              for a, b in zip(before[oid], after[oid]))
    out["objects_moved"] = sum(before[oid] != after[oid] for oid in objs)
    out["rebuilt"] = p2["recovery_bytes_rebuilt"] - p1["recovery_bytes_rebuilt"]
    out["reseed_launches"] = bm.LAUNCHES["gf_matmul"] - l0
    out["reseed_probes"] = repairc_compiler.COMPILES["probe_launches"] - \
        comp0["probe_launches"]
    if not out["objects_moved"] or not out["rebuilt"] or \
            not out["reseed_launches"]:
        raise AssertionError(f"{tag}: the reseed moved {out['objects_moved']}"
                             f" objects, rebuilt {out['rebuilt']} B, K1 "
                             f"{out['reseed_launches']}")
    # -- one balancer round on K3 ----------------------------------------
    _wait(c, lambda: mgr.osdmap.epoch == c.mon.osdmap.epoch,
          "the mgr at the reseeded map", tag=tag)
    k3_0, l0, p2 = cb.LAUNCHES["crush_do_rule"], bm.LAUNCHES["gf_matmul"], perf()
    e0 = c.mon.osdmap.epoch
    t0 = time.monotonic()
    out["upmaps"] = mgr.tick()
    out["balance_tick_s"] = time.monotonic() - t0
    out["balance_k3"] = cb.LAUNCHES["crush_do_rule"] - k3_0
    if not out["balance_k3"] or not out["upmaps"]:
        raise AssertionError(f"{tag}: the balancer round launched K3 "
                             f"{out['balance_k3']} times, {out['upmaps']} "
                             "upmap changes")
    # the mgr's osd upmap-batch commits asynchronously: wait for its epoch
    settle("the balanced map", lambda: c.mon.osdmap.epoch > e0 and
           mgr.osdmap.epoch == c.mon.osdmap.epoch and
           not c.mon.osdmap.pg_temp)
    out["balance_epochs"] = c.mon.osdmap.epoch - e0
    out["balance_s"] = time.monotonic() - t0
    p3 = perf()
    out["balance_rebuilt"] = p3["recovery_bytes_rebuilt"] - \
        p2["recovery_bytes_rebuilt"]
    out["balance_push_bytes"] = p3["push_in_bytes"] - p2["push_in_bytes"]
    out["balance_launches"] = bm.LAUNCHES["gf_matmul"] - l0
    # -- checks ----------------------------------------------------------
    _read_all(io, objs, tag)
    out["shards_checked"] = _ec_shards_plain(c, pid, objs, want, tag)
    for _ in range(3):          # fresh reports retire the last events
        clock.step()
        if not mgr.progress_tick():
            break
    done = mgr.progress.history()
    if not done or mgr.progress.ls() or \
            any(e["progress"] != 1.0 for e in done):
        raise AssertionError(f"{tag}: progress live {mgr.progress.ls()}, "
                             f"completed {done}")
    out["progress"] = [(e["message"], e["peak"]) for e in done]
    probe = {"MGR_ELASTIC": {"severity": "HEALTH_WARN",
                             "summary": "phase 19 (g) probe", "detail": []}}
    mgr.set_health_checks("smoke", probe)
    seen = r.mon_command({"prefix": "health"})[2]["checks"]
    mgr.set_health_checks("smoke", {})
    mgr.observability_tick()
    gone = r.mon_command({"prefix": "health"})[2]["checks"]
    if "MGR_ELASTIC" not in seen or "MGR_ELASTIC" in gone:
        raise AssertionError(f"{tag}: the mon's health {seen} / {gone}")
    out["faults"] = _elastic_faults(c, mgr, tag, paths)
    out["full_rebuilds"] = dict(paths)
    pool = c.mon.osdmap.pools[pid]
    out["pool"] = (pool.pg_num, pool.pgp_num)
    out["reppool"] = c.mon.osdmap.pools[rpid].pg_num
    for d in list(c.osds.values()):
        d.__dict__.pop("_update_pgs", None)
    out["update_s"] = update_s
    return out


def thrash_ec(c, r, io, clock, objs: dict, want: dict,
              paths: dict) -> dict:
    """(g2): OSDThrasher over `ecpool` with seeded 4 MiB writes between
    its actions, shard EIO in the mix, then heal and check."""
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.testing import OSDThrasher

    tag = "phase 19 (g2)"
    pid = r.pool_lookup("ecpool")
    rng = np.random.default_rng(SEED + 197)
    written: dict = {}
    futures: dict = {}

    def between(i):
        for j in range(THRASH_WRITES):
            oid = f"thrash{i}_{j}"
            written[oid] = rng.bytes(REPAIR_OBJECT)
            futures[oid] = io.aio_write_full(oid, written[oid])

    l0 = bm.LAUNCHES["gf_matmul"]
    t0 = time.monotonic()
    thr = OSDThrasher(clock, seed=SEED, min_in=THRASH_MIN,
                      min_live=THRASH_MIN, ec_pools=["ecpool"], rados=r)
    thr.now = clock.now
    thr.do_thrash(THRASH_ROUNDS, between=between)
    if not thr.injected and not any(e.startswith("eio") for e in thr.log):
        thr.inject_shard_eio()
    # read every object with a live EIO mark: the primary decodes around it
    eio = sorted({soid.name for _osd, _cid, soid in thr.injected})
    e0 = bm.LAUNCHES["gf_matmul"]
    everything = {**objs, **written}
    for oid in eio:
        fut = futures.get(oid)
        if fut is not None:
            _wait(c, fut.done, f"the write of {oid}", tag=tag)
        if io.read(oid) != everything[oid]:
            raise AssertionError(f"{tag}: {oid} read around its EIO shard")
    eio_launches = bm.LAUNCHES["gf_matmul"] - e0
    thr.heal(timeout_rounds=600)
    clock.now = max(clock.now, thr.now)
    _wait(c, lambda: all(f.done() for f in futures.values()),
          "the thrash writes", tag=tag)
    failed = {o: f.errno_name for o, f in futures.items() if f.result < 0}
    if failed:
        raise AssertionError(f"{tag}: writes failed {failed}; log {thr.log}")
    _wait(c, lambda: _all_clean(c, r) and not c.mon.osdmap.pg_temp,
          "clean after heal", tag=tag)
    wall = time.monotonic() - t0
    _read_all(io, everything, tag)
    checked = _ec_shards_plain(c, pid, everything, want, tag)
    m = c.mon.osdmap
    if any(not (m.is_up(o) and m.is_in(o)) for o in c.osds):
        raise AssertionError(f"{tag}: not every OSD up and in after heal")
    return {"log": list(thr.log), "wall_s": wall, "written": len(written),
            "launches": bm.LAUNCHES["gf_matmul"] - l0,
            "eio_objects": eio, "eio_launches": eio_launches,
            "shards_checked": checked}


def telemetry_report_checks(rep: dict, pools: list) -> list:
    """The anonymized report's contract on phase 19's cluster; the
    list of what failed (empty when it holds)."""
    js = json.dumps(rep, sort_keys=True)
    names = re.findall(r"\b(?:osd|mon|mgr|client)\.\d+", js)
    basic = rep.get("basic", {})
    bad = []
    if basic.get("osds", {}).get("total") != CLUSTER_OSDS:
        bad.append(f"osds {basic.get('osds')}")
    if basic.get("pools", {}).get("count") != len(pools):
        bad.append(f"pools {basic.get('pools')}")
    if basic.get("pools", {}).get("ec_profiles") != [
            {"k": K, "m": M, "plugin": "tpu"}]:
        bad.append(f"profiles {basic.get('pools', {}).get('ec_profiles')}")
    if socket.gethostname() in js or "/" in js or names or \
            any(p in js for p in pools):
        bad.append(f"names {names} or a host, path or pool name in it")
    if not re.fullmatch(r"[0-9a-f]{32}", str(rep.get("cluster_id"))):
        bad.append(f"cluster_id {rep.get('cluster_id')}")
    return bad


def mgr_proxy(c, r) -> dict:
    """(g3): the mgr's telemetry and insights through the mon, a
    telemetry send to a file:// target, then the mgr killed: the next
    command answers EAGAIN, it does not hang."""
    from ceph_tpu_torch.common.options import global_config
    from ceph_tpu_torch.ec.kernels import _build

    tag = "phase 19 (g3)"
    work = _build.BUILD_DIR / "smoke" / "phase19"
    mgr = c.mgr
    t0 = time.monotonic()
    mgr.start_telemetry()
    mgr.observability_tick()          # compiles the report, samples insights
    tick_s = time.monotonic() - t0
    t0 = time.monotonic()
    first = r.mon_command({"prefix": "telemetry show"})
    first_s = time.monotonic() - t0
    pools = ["ecpool", "reppool"]
    bad = telemetry_report_checks(first[2] or {}, pools)
    if first[0] != 0 or bad:
        raise AssertionError(f"{tag}: telemetry show through the mon "
                             f"{first[:2]}: {bad}")
    work.mkdir(parents=True, exist_ok=True)
    sink = work / "telemetry.jsonl"
    with contextlib.suppress(FileNotFoundError):
        sink.unlink()
    cfg = global_config()
    cfg.set("mgr_telemetry_url", f"file://{sink}")
    try:
        sent = r.mon_command({"prefix": "telemetry send"})
    finally:
        cfg.set("mgr_telemetry_url", "")
    lines = sink.read_text().splitlines() if sink.exists() else []
    if sent[:2] != (0, "report sent") or \
            [json.loads(x) for x in lines] != [first[2]]:
        raise AssertionError(f"{tag}: telemetry send {sent[:2]}, the "
                             f"target holds {len(lines)} lines")
    ins = r.mon_command({"prefix": "insights"})
    samples = list(mgr.insights._log_counts)
    counts = c.mon.handle_command({"prefix": "log counts"})[2]
    delta = {lvl: samples[-1][1].get(lvl, 0) - samples[0][1].get(lvl, 0)
             for lvl in ("warn", "error")}
    if ins[0] != 0 or ins[2]["cluster_log"] != delta or \
            samples[-1][1].get("warn", 0) < 1 or \
            counts.get("warn", 0) < samples[-1][1].get("warn", 0):
        raise AssertionError(f"{tag}: insights {ins[:2]} cluster_log "
                             f"{(ins[2] or {}).get('cluster_log')}, samples "
                             f"{samples}, the mon's counts {counts}")
    c.mgr.shutdown()
    c.mgr = None
    t0 = time.monotonic()
    second = r.mon_command({"prefix": "insights"})
    second_s = time.monotonic() - t0
    if second[0] != -11 or not second[1].startswith("EAGAIN(mgr): ") or \
            second_s > 10.0:
        raise AssertionError(f"{tag}: with the mgr dead: {second} in "
                             f"{second_s:.3f} s")
    return {"relayed": first[:2], "relayed_s": first_s, "tick_s": tick_s,
            "basic": first[2]["basic"], "sent": len(lines),
            "insights": ins[2]["cluster_log"], "log_counts": counts,
            "samples": len(samples), "dead": second, "dead_s": second_s}


# -- phase 19 (g4): rgw multisite, the mgr's prometheus and restful ----------

MS_ZONES = ("z1", "z2")          # z1 is the metadata master
MS_SHARDS = 8                    # radosgw's index shards, as in (f)
MS_INTERVAL_S = 0.05             # the sync agents' poll (MiniCluster's)
MS_LARGE = 16                    # 4 MiB objects PUT to z1
MS_LARGE_THREADS = 4
MS_SMALL = 256                   # 4 KiB objects PUT to z1
MS_SMALL_THREADS = 8
MS_Z2_SMALL = 64                 # 4 KiB objects in a bucket made on z2
MS_VERSIONS = 4                  # versions of one key, then a delete marker
MS_DELETES = 16                  # DELETEs on z1
MS_KILL_SMALL = 64               # 4 KiB PUTs to z1 while z2 is killed
MS_SYS = "client.rgwsync"        # the multisite system user


def _http_get(port: int, path: str, headers: dict | None = None):
    """GET over loopback -> the body as text; an HTTP error raises."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=CLUSTER_TIMEOUT_S) as resp:
        return resp.read().decode()


def _samples(text: str) -> dict:
    """A prometheus exposition text's samples: name{labels} -> value."""
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


class MultisiteLeg:
    """Phase 19 (g4), after (g3): two zones (`z1` the metadata master,
    `z2`) on phase 19's cluster, each a gateway on its own replicated
    pool `rgw-<zone>` (pg_num 32, 8 index shards, SigV4, the peers' pulls
    signed as the multisite system user), syncing every 0.05 s.  Writes
    to both zones, a kill and restart of z2, a partition of z2 from z1
    on the fault plane and its heal; after each, both zones converge:
    every index shard's object entries and every object's sha256 equal
    across the zones and to the leg's model.  Then the mgr's /metrics
    and restful API over HTTP, and `rados rgw sync-status` in process.
    No zone's data meets K1 (an EC pool refuses omap).  The counts
    default to the smoke's: `large` 4 MiB and `small` 4 KiB objects on
    z1, `z2_small` on z2, `versions` of one key, `deletes`, and
    `kill_small` PUTs while z2 is down."""

    def __init__(self, c, r, large: int = MS_LARGE, small: int = MS_SMALL,
                 z2_small: int = MS_Z2_SMALL, versions: int = MS_VERSIONS,
                 deletes: int = MS_DELETES, kill_small: int = MS_KILL_SMALL):
        self.c, self.r = c, r
        self.depth = {"large": large, "small": small, "z2_small": z2_small,
                      "versions": versions, "deletes": deletes,
                      "kill_small": kill_small}
        self.rng = np.random.default_rng(SEED + 194)
        self.out: dict = {"depth": self.depth}
        #: bucket -> {key: bytes} of what must read back on both zones
        self.model: dict = {}
        #: bucket -> keys deleted (their index entries are tombstones)
        self.gone: dict = {}
        #: bucket -> keys with a version stack (checked on their own)
        self.versioned: dict = {}
        self.clients: list = []
        self.gws: list = []

    # -- helpers ------------------------------------------------------------
    def _client(self, gw) -> S3Client:
        cl = S3Client(gw.port, RGW_USER, self.keys[RGW_USER])
        self.clients.append(cl)
        return cl

    def _put_all(self, s3, bucket: str, items: dict, threads: int,
                 what: str) -> float:
        def put(kv):
            _s3_ok(s3("PUT", f"/{bucket}/{kv[0]}", kv[1]), 200,
                   f"{what} PUT {bucket}/{kv[0]}", tag=self.tag)
        t0 = time.monotonic()
        _pmap(put, list(items.items()), threads)
        self.model.setdefault(bucket, {}).update(items)
        return time.monotonic() - t0

    def _settled(self, gws, since: float | None = None) -> float:
        """Wait until every agent has run two rounds past now and each
        reports caught up; -> seconds from `since` (or from now)."""
        t0 = time.monotonic() if since is None else since
        start = {id(g): g.sync._rounds for g in gws}
        _wait(self.c, lambda: all(g.sync._rounds >= start[id(g)] + 2
                                  for g in gws) and
              all(g.sync.caught_up() for g in gws),
              f"zones {[g.zone for g in gws]} caught up", tag=self.tag)
        return time.monotonic() - t0

    def _index(self, gw, bucket: str) -> dict:
        """shard -> {key: entry} of the bucket's object entries on `gw`
        (datalog records and in-flight uploads apart), each entry's data
        object replaced by its bytes' sha256."""
        from ceph_tpu_torch.cls.rgw import DL_META
        from ceph_tpu_torch.rgw.datalog import is_dl_key
        from ceph_tpu_torch.rgw.gateway import _index_obj

        out = {}
        for s in range(gw._nshards(bucket)):
            ents = {}
            for k, v in gw.io.get_omap_vals(_index_obj(bucket, s))[0].items():
                if is_dl_key(k) or k == DL_META or k.startswith(".upload."):
                    continue
                ent = json.loads(v)
                for ver in [ent] + list(ent.get("versions") or ()):
                    if ver.get("obj"):
                        ver["obj"] = hashlib.sha256(
                            gw.io.read(ver.pop("obj"))).hexdigest()
                ents[k] = ent
            out[s] = ents
        return out

    def _converged(self, what: str, get: bool = True) -> dict:
        """Every bucket's index shards equal on both zones, their live
        keys the model's (the deleted ones tombstones), every data
        object's sha256 the model's, and with `get` every object read
        back through the replica's (z2's) S3 equal to the model."""
        from ceph_tpu_torch.cls.rgw import is_tomb

        counts = {"shards": 0, "entries": 0, "objects": 0, "gets": 0}
        for bucket in sorted(set(self.model) | set(self.gone) |
                             set(self.versioned)):
            views = [self._index(gw, bucket) for gw in self.gws]
            if views[0] != views[1]:
                bad = [s for s in views[0] if views[0][s] != views[1][s]]
                raise AssertionError(f"{self.tag}: {what}: {bucket}'s index "
                                     f"shards {bad} differ between the zones")
            live = {k for ents in views[0].values() for k, e in ents.items()
                    if not is_tomb(e) and e.get("versions") is None}
            stacks = {k for ents in views[0].values() for k, e in ents.items()
                      if e.get("versions") is not None}
            if stacks != self.versioned.get(bucket, set()):
                raise AssertionError(f"{self.tag}: {what}: {bucket}'s "
                                     f"version stacks {sorted(stacks)}")
            dead = {k for ents in views[0].values() for k, e in ents.items()
                    if is_tomb(e)}
            if live != set(self.model.get(bucket, {})) or \
                    not dead <= set(self.gone.get(bucket, ())):
                raise AssertionError(f"{self.tag}: {what}: {bucket} holds "
                                     f"{len(live)} live keys and "
                                     f"{len(dead)} tombstones, the model "
                                     f"{len(self.model.get(bucket, {}))} "
                                     f"and {len(self.gone.get(bucket, ()))}")
            counts["shards"] += len(views[0])
            counts["entries"] += sum(map(len, views[0].values()))
            for ents in views[0].values():
                for k, e in ents.items():
                    if is_tomb(e) or e.get("versions") is not None:
                        continue
                    want = hashlib.sha256(self.model[bucket][k]).hexdigest()
                    if e["obj"] != want:
                        raise AssertionError(f"{self.tag}: {what}: "
                                             f"{bucket}/{k} differs from the "
                                             "model")
                    counts["objects"] += 1
            for s3 in self.s3s[1:] if get else ():
                def get(key, s3=s3, bucket=bucket):
                    body = _s3_ok(s3("GET", f"/{bucket}/{key}"), 200,
                                  f"{what} GET {bucket}/{key}",
                                  tag=self.tag)[2]
                    if body != self.model[bucket][key]:
                        raise AssertionError(f"{self.tag}: {what}: GET "
                                             f"{bucket}/{key} differs")
                _pmap(get, sorted(self.model.get(bucket, {})),
                      MS_SMALL_THREADS)
                counts["gets"] += len(self.model.get(bucket, {}))
        return counts

    def _faultless(self, what: str) -> dict:
        from ceph_tpu_torch import rgw
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rgw import multisite

        got = {"swallowed": sum(multisite.SWALLOWED.values()) +
               sum(rgw.SWALLOWED.values()) - self.swallowed0,
               "tick_errors": sum(multisite.SYNC_TICK_ERRORS.values()) -
               self.tick_errors0,
               "error_lists": sum(len(gw.sync.error_list())
                                  for gw in self.gws),
               "k1": bm.LAUNCHES["gf_matmul"] - self.l0}
        if any(got.values()):
            raise AssertionError(f"{self.tag}: {what}: {got} (swallowed "
                                 f"{dict(multisite.SWALLOWED)}, "
                                 f"{dict(rgw.SWALLOWED)}; tick errors "
                                 f"{dict(multisite.SYNC_TICK_ERRORS)})")
        return got

    # -- the leg ------------------------------------------------------------
    def run(self, clock=None) -> dict:
        from ceph_tpu_torch import rgw
        from ceph_tpu_torch.auth import KeyRing, generate_key
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.rgw import multisite

        self.tag = tag = "phase 19 (g4)"
        out, d = self.out, self.depth
        t_leg = time.monotonic()
        self.l0 = bm.LAUNCHES["gf_matmul"]
        self.swallowed0 = sum(multisite.SWALLOWED.values()) + \
            sum(rgw.SWALLOWED.values())
        self.tick_errors0 = sum(multisite.SYNC_TICK_ERRORS.values())
        c = self.c
        self.keys = {RGW_USER: generate_key(), MS_SYS: generate_key()}
        try:
            # -- 1. two zones, the period in both pools, the agents ------
            t0 = time.monotonic()
            self.gws = c.rgw_multisite(
                zones=MS_ZONES, index_shards=MS_SHARDS,
                sync_interval=MS_INTERVAL_S, keyring=KeyRing(self.keys),
                system_key=(MS_SYS, self.keys[MS_SYS]))
            out["zones_s"] = time.monotonic() - t0
            z1, z2 = self.gws
            for gw in self.gws:
                pool = self.r.objecter.osdmap.pools[
                    self.r.pool_lookup(gw.pool)]
                if (pool.type, pool.size, pool.pg_num) != (1, REP_SIZE, 32):
                    raise AssertionError(f"{tag}: {gw.pool} is type "
                                         f"{pool.type} size {pool.size} "
                                         f"pg_num {pool.pg_num}")
            s1, s2 = self._client(z1), self._client(z2)
            self.s3s = [s1, s2]
            # -- 2. traffic on both zones --------------------------------
            _s3_ok(s1("PUT", "/ms1"), 200, "PUT ms1", tag=tag)
            large = {f"l/{i:02d}": self.rng.bytes(RGW_OBJ)
                     for i in range(d["large"])}
            small = {f"s/{i:04d}": self.rng.bytes(RGW_SMALL_B)
                     for i in range(d["small"])}
            t_z1 = time.monotonic()
            out["large_s"] = self._put_all(s1, "ms1", large,
                                           MS_LARGE_THREADS, "z1")
            out["small_s"] = self._put_all(s1, "ms1", small,
                                           MS_SMALL_THREADS, "z1")
            _s3_ok(s2("PUT", "/ms2"), 200, "PUT ms2 on z2", tag=tag)
            if "ms2" not in z1._buckets():
                raise AssertionError(f"{tag}: ms2 made on z2 is not on the "
                                     "master in the same request")
            z2small = {f"t/{i:03d}": self.rng.bytes(RGW_SMALL_B)
                       for i in range(d["z2_small"])}
            out["z2_small_s"] = self._put_all(s2, "ms2", z2small,
                                              MS_SMALL_THREADS, "z2")
            out["lag_z2_z1_s"] = self._settled([z1])
            _s3_ok(s1("PUT", "/msv"), 200, "PUT msv", tag=tag)
            _s3_ok(s1("PUT", "/msv?versioning", RGW_VERS_ON), 200,
                   "versioning msv", tag=tag)
            vids = []
            for i in range(d["versions"]):
                data = self.rng.bytes(RGW_SMALL_B)
                res = _s3_ok(s1("PUT", "/msv/v", data), 200,
                             f"PUT msv/v #{i}", tag=tag)
                vids.append((res[1]["x-amz-version-id"], data))
            dm = _s3_ok(s1("DELETE", "/msv/v"), 204, "DELETE msv/v",
                        tag=tag)[1]["x-amz-version-id"]
            doomed = sorted(small)[:d["deletes"]]
            for key in doomed:
                _s3_ok(s1("DELETE", f"/ms1/{key}"), 204,
                       f"DELETE ms1/{key}", tag=tag)
                del self.model["ms1"][key]
            self.gone["ms1"] = set(doomed)
            self.model.setdefault("msv", {})
            self.versioned["msv"] = {"v"}
            out["lag_z1_z2_s"] = self._settled([z2])
            out["replicated_MBps"] = (d["large"] * RGW_OBJ + d["small"] *
                                      RGW_SMALL_B) / 1e6 / \
                (time.monotonic() - t_z1)
            self._settled(self.gws)
            t0 = time.monotonic()
            out["index"] = self._converged("after the writes")
            out["check_s"] = time.monotonic() - t0
            for gw in self.gws:
                stack = [(v["vid"], v.get("dm", False)) for v in
                         gw._index_entry("msv", "v")["versions"]]
                want = [(dm, True)] + [(v, False) for v, _ in
                                       reversed(vids)]
                if stack != want:
                    raise AssertionError(f"{tag}: msv/v's versions on "
                                         f"{gw.zone}: {stack}")
                for vid, data in vids:
                    body = _s3_ok(self.s3s[self.gws.index(gw)](
                        "GET", f"/msv/v?versionId={vid}"), 200,
                        f"GET msv/v@{vid}", tag=tag)[2]
                    if body != data:
                        raise AssertionError(f"{tag}: msv/v@{vid} on "
                                             f"{gw.zone} differs")
            out["applied"] = {gw.zone: gw.sync.entries_applied
                              for gw in self.gws}
            out["skipped"] = {gw.zone: gw.sync.entries_skipped
                              for gw in self.gws}
            out["full_syncs"] = {gw.zone: gw.sync.full_syncs
                                 for gw in self.gws}
            out["quarantined"] = sum(len(gw.sync.error_list())
                                     for gw in self.gws)
            self._faultless("after the writes")
            # -- 3. kill z2 under PUTs to z1, restart from its markers ---
            more = {f"k/{i:03d}": self.rng.bytes(RGW_SMALL_B)
                    for i in range(d["kill_small"])}
            s2.close()
            with ThreadPoolExecutor(max_workers=1) as ex:
                writer = ex.submit(self._put_all, s1, "ms1", more,
                                   MS_SMALL_THREADS, "z1")
                c.kill_rgw_zone(z2)
                writer.result()
            t0 = time.monotonic()
            z2 = c.restart_rgw_zone(z2)
            self.gws[1] = z2
            s2 = self._client(z2)
            self.s3s[1] = s2
            out["restart_s"] = self._settled(self.gws, since=t0)
            out["restart_full_syncs"] = z2.sync.full_syncs
            if z2.sync.full_syncs:
                raise AssertionError(f"{tag}: the restarted z2 ran "
                                     f"{z2.sync.full_syncs} full syncs")
            out["index_restart"] = self._converged("after the restart",
                                                   get=False)
            # -- 4. partition z2 from z1, then heal ----------------------
            before = z2.sync.markers_for("z1")
            ids = c.network.faults.partition(["rgw.z2"], ["rgw.z1"])
            key, data = "p/0", self.rng.bytes(RGW_SMALL_B)
            self._put_all(s1, "ms1", {key: data}, 1, "partitioned z1")
            _wait(c, lambda: (bo := z2.sync._backoff.get("z1")) is not None
                  and bo.failures >= 2, "z2's backoff", tag=tag)
            rows = {s["source"]: s for s in z2.sync.status()["sources"]}
            out["backoff_failures"] = z2.sync._backoff["z1"].failures
            if rows["z1"]["state"] != "backoff" or \
                    z2.sync.markers_for("z1") != before:
                raise AssertionError(f"{tag}: partitioned: z2's source row "
                                     f"{rows['z1']}, markers moved: "
                                     f"{z2.sync.markers_for('z1') != before}")
            t0 = time.monotonic()
            c.network.faults.heal(ids)
            out["heal_s"] = self._settled(self.gws, since=t0)
            if z2.sync._backoff["z1"].failures:
                raise AssertionError(f"{tag}: z2's backoff not reset")
            out["index_heal"] = self._converged("after the heal", get=False)
            self._faultless("after the heal")
            # -- 5. the mgr's /metrics --------------------------------------
            # the killed z2's agent is stopped: drop every reference to
            # its gateway so the agents' weak set forgets it
            import gc
            gc.collect()
            mgr = c.mgr or c.start_mgr()
            if clock is not None:
                clock.step()            # stat reports for the zone pools
                clock.step()
            self.mgr = mgr
            exp = mgr.start_prometheus(port=0)
            t0 = time.monotonic()
            scrape = _samples(_http_get(exp.port, "/metrics"))
            out["scrape_s"] = time.monotonic() - t0
            df = self.r.mon_command({"prefix": "df"})[2]
            epoch = c.mon.osdmap.epoch
            bad = []
            for zone, src in (("z1", "z2"), ("z2", "z1")):
                lbl = f'{{source="{src}",zone="{zone}"}}'
                for fam in ("ceph_rgw_sync_lag_entries",
                            "ceph_rgw_sync_behind_shards"):
                    if scrape.get(fam + lbl) != 0.0:
                        bad.append((fam + lbl, scrape.get(fam + lbl)))
            for gw in self.gws:
                got = scrape.get("ceph_rgw_sync_apply_latency_seconds_count"
                                 f'{{zone="{gw.zone}"}}')
                if got != float(gw.sync.entries_applied):
                    bad.append((gw.zone, got, gw.sync.entries_applied))
                lbl = f'ceph_pool_objects{{pool="{gw.pool}"}}'
                if scrape.get(lbl) != float(
                        df["pools"].get(gw.pool, {}).get("objects", -1)):
                    bad.append((lbl, scrape.get(lbl),
                                df["pools"].get(gw.pool)))
            if scrape.get("ceph_osdmap_epoch") != float(epoch):
                bad.append(("ceph_osdmap_epoch",
                            scrape.get("ceph_osdmap_epoch"), epoch))
            if bad:
                raise AssertionError(f"{tag}: /metrics: {bad}")
            out["pool_objects"] = {gw.pool: scrape[
                f'ceph_pool_objects{{pool="{gw.pool}"}}'] for gw in self.gws}
            out["applied_end"] = {gw.zone: gw.sync.entries_applied
                                  for gw in self.gws}
            # -- 6. the restful API ----------------------------------------
            srv = mgr.start_restful(port=0)
            rkey = srv.create_key("admin")
            auth = {"Authorization": f"Bearer {rkey}"}
            routes = {"/health": {"prefix": "health detail"},
                      "/df": {"prefix": "df"},
                      "/osd": {"prefix": "osd dump"},
                      "/pool": {"prefix": "osd pool ls"}}
            out["restful_ms"] = {}
            for path, cmd in routes.items():
                t0 = time.monotonic()
                got = json.loads(_http_get(srv.port, path, auth))
                out["restful_ms"][path] = (time.monotonic() - t0) * 1e3
                want = mgr.mon_command(cmd)[2]
                if path == "/osd":
                    want = want.get("osds", want)
                elif path == "/pool":
                    got = [p["pool_name"] for p in got]
                if got != want:
                    raise AssertionError(f"{tag}: restful GET {path} != "
                                         f"the mon's {cmd['prefix']}")
            try:
                _http_get(srv.port, "/health")
                raise AssertionError(f"{tag}: restful answered without "
                                     "the key")
            except Exception as ex:   # noqa: BLE001 — the 401 we want
                if getattr(ex, "code", None) != 401:
                    raise
            dash = json.loads(_http_get(srv.port, "/dashboard", auth))
            zones = sorted({row["zone"] for row in dash["sync"]})
            if zones != list(MS_ZONES):
                raise AssertionError(f"{tag}: the dashboard's sync rows "
                                     f"list {zones}")
            # -- 7. rados rgw sync-status, in process --------------------
            from ceph_tpu_torch.rgw.multisite import render_sync_status
            from ceph_tpu_torch.tools import rados_cli

            for gw in self.gws:
                buf = io.StringIO()
                rc = rados_cli.main(
                    ["rgw", "sync-status", "--endpoint",
                     f"http://127.0.0.1:{gw.port}", "--access", MS_SYS,
                     "--secret", self.keys[MS_SYS]], rados=self.r, out=buf)
                want = render_sync_status(gw.sync.status())
                if rc != 0 or buf.getvalue().splitlines() != want:
                    raise AssertionError(f"{tag}: rados rgw sync-status "
                                         f"{gw.zone}: rc {rc}, "
                                         f"{buf.getvalue()!r} != {want}")
            out["sync_status"] = want
            out["faults"] = self._faultless("at the end")
        finally:
            self.close()
        # -- 8. the zones' pools go -------------------------------------
        t0 = time.monotonic()
        for zone in MS_ZONES:
            pool = f"rgw-{zone}"
            rc, outs, _ = self.r.mon_command({
                "prefix": "osd pool delete", "pool": pool,
                "yes_i_really_really_mean_it": True})
            if rc != 0:
                raise AssertionError(f"{tag}: {pool} delete: {outs}")
        _wait(c, lambda: not {f"rgw-{z}" for z in MS_ZONES} &
              set(c.mon.osdmap.pool_names.values()) and
              _all_clean(c, self.r), "the PGs after the zone pools' delete",
              tag=tag)
        out["teardown_s"] = time.monotonic() - t0
        out["k1"] = bm.LAUNCHES["gf_matmul"] - self.l0
        if out["k1"]:
            raise AssertionError(f"{tag}: K1 launched {out['k1']} times")
        out["wall_s"] = time.monotonic() - t_leg
        return out

    def close(self) -> None:
        """Close every client, shut both gateways and the mgr's HTTP
        faces down (a no-op for what is already down)."""
        for cl in self.clients:
            cl.close()
        for gw in self.gws:
            gw.shutdown()
            if gw in self.c.rgws:
                self.c.rgws.remove(gw)
        self.gws = []
        mgr = getattr(self, "mgr", None)
        for face in ("prometheus", "restful"):
            if mgr is not None and getattr(mgr, face) is not None:
                getattr(mgr, face).shutdown()
                setattr(mgr, face, None)


def print_multisite(mo: dict, name_power: str) -> None:
    tag, d = "phase 19 (g4)", mo["depth"]
    print(f"{tag}: zones z1 (master), z2 on rgw-z1 / rgw-z2 (replicated, "
          f"size {REP_SIZE}, pg_num 32, {MS_SHARDS} index shards, SigV4, "
          f"sync every {MS_INTERVAL_S} s) up in {mo['zones_s']:.3f} s; z1: "
          f"{d['large']} x {RGW_OBJ} B PUT by {MS_LARGE_THREADS} threads in "
          f"{mo['large_s']:.3f} s, {d['small']} x {RGW_SMALL_B} B by "
          f"{MS_SMALL_THREADS} in {mo['small_s']:.3f} s; z2: bucket ms2 "
          f"(forwarded to the master) and {d['z2_small']} x {RGW_SMALL_B} B "
          f"in {mo['z2_small_s']:.3f} s; msv: {d['versions']} versions and "
          f"a delete marker; {d['deletes']} DELETEs on {name_power}")
    print(f"{tag}: replicated z1 -> z2 at {mo['replicated_MBps']:.1f} MB/s "
          f"(first PUT to caught up); lag from the last write to caught up "
          f"z1 -> z2 {mo['lag_z1_z2_s']:.3f} s, z2 -> z1 "
          f"{mo['lag_z2_z1_s']:.3f} s; entries applied {mo['applied']}, "
          f"skipped {mo['skipped']}, quarantined {mo['quarantined']}, full "
          f"syncs {mo['full_syncs']}; converged: {mo['index']} (index "
          f"shards equal on both zones and to the model, every data "
          f"object's sha256 == the model on both zones, every object read "
          f"back through z2's S3) checked in {mo['check_s']:.3f} s on "
          f"{name_power}")
    print(f"{tag}: z2 killed under {d['kill_small']} PUTs to z1 and "
          f"restarted on its port: caught up in {mo['restart_s']:.3f} s "
          f"from its durable markers ({mo['restart_full_syncs']} full "
          f"syncs), converged {mo['index_restart']}; partition rgw.z2 | "
          f"rgw.z1: backoff after {mo['backoff_failures']} failures, "
          f"markers unmoved; heal to caught up in {mo['heal_s']:.3f} s, "
          f"converged {mo['index_heal']} (index shards and data objects' "
          f"sha256) on {name_power}")
    print(f"{tag}: the mgr's /metrics over HTTP in "
          f"{mo['scrape_s'] * 1e3:.1f} ms: lag and behind shards 0 for both "
          f"zones, the apply-latency counts == entries applied "
          f"{mo['applied_end']}, ceph_pool_objects {mo['pool_objects']} == "
          f"df, ceph_osdmap_epoch == the mon's; restful " + ", ".join(
              f"{p} {ms:.1f} ms" for p, ms in mo["restful_ms"].items()) +
          f" == the mon's commands, 401 without the key, the dashboard "
          f"lists both zones; rados rgw sync-status == render_sync_status "
          f"for both zones ({mo['sync_status'][1].strip()!r}); "
          f"{mo['faults']}; pools removed in {mo['teardown_s']:.3f} s; leg "
          f"{mo['wall_s']:.1f} s on {name_power}")


def elastic_leg(c, r, io, objs: dict, ec_writeop: bytes, victim: int,
                name_power: str) -> dict:
    """Phase 19 (g) on phase 19's cluster after its recovery: (g1) split
    and reseed through the mgr, one balancer round on K3; (g2) the
    thrasher; (g3) the mgr's command proxy; (g4) rgw multisite with the
    mgr's prometheus exporter and restful API (`MultisiteLeg`)."""
    t_leg = time.monotonic()
    objs = {**objs, "ec_writeop": ec_writeop}
    want: dict = {}
    clock = SimClock(c, max(c._sim_now or SCRUB_T0, SCRUB_T0) + ELASTIC_STEP_S)
    with rebuild_paths() as paths:
        g1 = split_reseed(c, r, io, clock, objs, want, paths)
        full_g1 = dict(paths)
        g2 = thrash_ec(c, r, io, clock, objs, want, paths)
        faults = _elastic_faults(c, c.mgr, "phase 19 (g2)", paths)
    g2["full_rebuilds"] = {k: paths[k] - full_g1[k] for k in paths}
    g3 = mgr_proxy(c, r)
    wall = time.monotonic() - t_leg
    g4 = MultisiteLeg(c, r).run(clock)
    print(f"phase 19 (g1): pg_autoscaler plan " + "; ".join(
        f"{p['pool_name']} pg_num {p['pg_num']} -> target {p['target']}"
        f"{' (adjust)' if p['would_adjust'] else ''}" for p in g1["plan"]) +
        f"; osd.{victim} out, {len(c.osds)} OSDs in")
    print(f"phase 19 (g1): split pg_num {CLUSTER_PG_NUM} -> {g1['pool'][0]} in "
          f"{g1['split_s']:.3f} s ({g1['split_epochs']} epochs, K1 "
          f"{g1['split_launches']} launches, no byte left its OSD); reseed "
          f"pgp_num -> {g1['pool'][1]} to clean in {g1['reseed_s']:.3f} s "
          f"({g1['reseed_epochs']} epochs): {g1['objects_moved']} of "
          f"{len(objs)} objects moved ({g1['shards_moved']} shards), "
          f"{g1['rebuilt']} B rebuilt, K1 {g1['reseed_launches']} launches "
          f"({g1['reseed_probes']} compile probes, "
          f"{g1['reseed_launches'] - g1['reseed_probes']} repairs, decodes "
          f"and re-encodes; {g1['full_rebuilds']['full']} full rebuilds, "
          f"{g1['full_rebuilds']['no_plan']} of them with no repair plan) on "
          f"{name_power}")
    print(f"phase 19 (g1): balancer round {g1['balance_tick_s']:.3f} s on "
          f"the host clock, K3 {g1['balance_k3']} launches, "
          f"{g1['upmaps']} upmap changes in one osd upmap-batch; clean again "
          f"in {g1['balance_s']:.3f} s ({g1['balance_epochs']} epochs, "
          f"{g1['balance_rebuilt']} B rebuilt, "
          f"{g1['balance_push_bytes']} B pushed, K1 "
          f"{g1['balance_launches']} launches) on {name_power}")
    upd = g1["update_s"]
    per_osd = {}
    for osd, _epoch, s in upd:
        per_osd.setdefault(osd, []).append(s)
    allsec = [s for _o, _e, s in upd]
    n_pgs = g1["pool"][0] + g1["reppool"]
    print(f"phase 19 (g1): _update_pgs per map epoch ({n_pgs} PGs, the "
          f"scalar CRUSH only where its inputs changed; host clock, every "
          f"OSD thread under one GIL): {len(upd)} calls on "
          f"{len(per_osd)} OSDs, median {statistics.median(allsec):.4f} s, "
          f"max {max(allsec):.4f} s, {sum(allsec):.3f} s in all on the host "
          f"clock; per OSD " + ", ".join(
              f"osd.{o} {len(v)} x {statistics.median(v):.4f}"
              for o, v in sorted(per_osd.items())) + f" on {name_power}")
    print(f"phase 19 (g1): every object read back, {g1['shards_checked']} "
          f"shards == the plain version's encode; progress completed "
          f"{g1['progress']}; the mgr's health slice in the mon's health; "
          f"fault counts {g1['faults']}")
    print(f"phase 19 (g2): OSDThrasher seed {SEED} min_in/min_live "
          f"{THRASH_MIN}, {THRASH_ROUNDS} rounds, {g2['written']} x "
          f"{REPAIR_OBJECT} B written between them: {g2['log']}; heal to "
          f"clean, {g2['wall_s']:.3f} s in all; K1 {g2['launches']} launches "
          f"({g2['eio_launches']} reading {g2['eio_objects']} around its EIO "
          f"shard); {g2['full_rebuilds']['full']} full rebuilds "
          f"({g2['full_rebuilds']['no_plan']} with no repair plan, the rest "
          f"after a failed helper read); every "
          f"object read back and {g2['shards_checked']} shards == the plain "
          f"encode; fault counts {faults} on {name_power}")
    b = g3["basic"]
    print(f"phase 19 (g3): telemetry show through the mon -> "
          f"{g3['relayed']} in {g3['relayed_s']:.3f} s (report compiled in "
          f"{g3['tick_s']:.3f} s): {b['osds']['total']} OSDs, "
          f"{b['pools']['count']} pools, EC profiles "
          f"{b['pools']['ec_profiles']}, no host, path, pool or entity "
          f"name; telemetry send wrote {g3['sent']} report to a file:// "
          f"target; insights over {g3['samples']} samples: cluster log "
          f"{g3['insights']} in the window (the mon's counts "
          f"{g3['log_counts']}); mgr killed, insights -> "
          f"{g3['dead'][:2]} in {g3['dead_s']:.3f} s; leg (g) {wall:.1f} s "
          f"on {name_power}")
    print_multisite(g4, name_power)
    return {"g1": {k: v for k, v in g1.items() if k != "update_s"},
            "update_s": {"calls": len(upd), "sum": sum(allsec),
                         "median": statistics.median(allsec),
                         "max": max(allsec)},
            "g2": g2, "g3": g3, "g4": g4, "wall_s": wall}


def cluster_phase(name_power: str, dev) -> dict:
    """Phase 19: the port's cluster on the card (see the module
    docstring)."""
    from ceph_tpu_torch.dist import ICIFabric
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 19)
    objs = {f"obj{i}": rng.integers(0, 256, REPAIR_OBJECT,
                                    dtype=np.uint8).tobytes()
            for i in range(CLUSTER_OBJECTS)}
    c, r, io = _cluster()
    rgw = fsl = None
    try:
        from ceph_tpu_torch.osd.types import PG

        serve = ServeLeg(io)
        rep = RepLeg(c, r, objs)

        def healthy():
            scrub = scrub_leg(c, r, objs)
            rep.healthy()           # (f) after (e): (e) scrubs ecpool alone
            # the victim drive_cluster picks next: the OSD in the most
            # acting sets of ecpool
            snap.before_kill(_victim(acting_sets(
                c.mon.osdmap, r.pool_lookup("ecpool"), CLUSTER_PG_NUM,
                PG)[1]))
            rbd.before_kill()
            rgw.before_kill()
            fsl.before_kill()
            serve.healthy()
            return scrub

        def degraded():
            rep.degraded()
            rgw.degraded()
            fsl.degraded()
            serve.degraded()
        snap = SnapLeg(c, r, rep, objs)
        rbd = RbdLeg(c, r, rep, snap)
        rgw = RgwLeg(c, r)
        fsl = FsLeg(c, r, pg_num=FS_PG_NUM)
        res = drive_cluster(c, r, io, objs, "phase 19", dev,
                            healthy=healthy, degraded=degraded)
        legs = res["legs"]
        scrub, served = res["healthy"], serve.out
        snap.after_clean()
        rbd.after_clean()
        rgw.after_clean()
        fsl.after_clean(res["clean_s"])
        snap.close_clients()
        rep.verify(res["victim"])
        if not rep.out["recovery"]["push_in_clone_bytes"]:
            raise AssertionError("phase 19 (f): the recovery pushed no clone")
        rep.scrub()
        snap.trim()
        _faults(c)
        # -- every shard on its acting OSD == the plain version's encode ---
        ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M),
                                          "technique": "reed_sol_van"},
                                  device="cpu")
        sinfo = ecutil.StripeInfo(K, K * STRIPE_UNIT)
        moved = 0             # shards now on an OSD that did not hold them
        want = {}
        for oid, s, osd, got, was, _pg in _shards_on_acting(
                c, objs, res, "phase 19"):
            if oid not in want:
                want = {oid: ecutil.encode(sinfo, ec_cpu, objs[oid])}
            if got != want[oid][s]:
                raise AssertionError(f"phase 19: {oid} shard {s} on "
                                     f"osd.{osd} differs from the plain "
                                     "version's encode")
            moved += osd != was
        if not moved:
            raise AssertionError("phase 19: no shard moved to a new OSD")
        messages = c.network.routed
        elastic = elastic_leg(c, r, io, objs, rep.ec_writeop, res["victim"],
                              name_power)
    finally:
        if rgw is not None:
            rgw.close()
        if fsl is not None:
            fsl.close()
        c.shutdown()
    # -- the fabric leg -------------------------------------------------------
    fab = ICIFabric(devices=[dev] * 8)
    c, r, io = _cluster(fabric=fab)
    fobjs = dict(itertools.islice(objs.items(), CLUSTER_FABRIC_OBJECTS))
    try:
        l0 = bm.LAUNCHES["gf_matmul"]
        with k1_events(bm) as ev:
            t0 = time.monotonic()
            for oid, data in fobjs.items():
                io.write_full(oid, data)
            wall = time.monotonic() - t0
        k1 = events_ms(ev)
        legs["fabric_write"] = {
            "MBps": len(fobjs) * REPAIR_OBJECT / wall / 1e6, "wall_s": wall,
            "k1_ms": k1, "k1_share": k1 / 1e3 / wall,
            "launches": bm.LAUNCHES["gf_matmul"] - l0}
        for oid, data in fobjs.items():
            if io.read(oid) != data:
                raise AssertionError(f"phase 19: fabric read of {oid} "
                                     "differs")
        stats = dict(fab.stats)
        if stats["staged"] < 1 or stats["fetched"] < K + M - 1:
            raise AssertionError(f"phase 19: fabric stats {stats}")
        _faults(c)
        messages_f = c.network.routed
    finally:
        c.shutdown()
    wall = time.monotonic() - t_phase
    print_legs("phase 19", legs, name_power)
    recover_s, rebuilt, read = res["recover_s"], res["rebuilt"], res["read"]
    victim, count = res["victim"], res["count"]
    print(f"phase 19: time to recover (osd out -> every PG clean) "
          f"{recover_s:.3f} s, rebuilt {rebuilt} B at "
          f"{rebuilt / recover_s / 1e6:.1f} MB/s, read/rebuilt "
          f"{read / rebuilt} on {name_power}")
    compiles = res["compiles"]
    probe = compiles["probe_launches"]
    print(f"phase 19: recovery's K1 launches {legs['recovery']['launches']}: "
          f"{probe} by the compile probes of {compiles['programs']} repair "
          f"programs, {legs['recovery']['launches'] - probe} by repairs and "
          f"re-encodes, for {rebuilt // (REPAIR_OBJECT // K)} shards "
          f"rebuilt on {name_power}")
    print(f"phase 19: MiniCluster mon + {CLUSTER_OSDS} OSDs, tpu k={K} "
          f"m={M} pg_num {CLUSTER_PG_NUM}: {len(objs)} x {REPAIR_OBJECT} B "
          f"written and read == payloads; osd.{victim} (in {count[victim]} "
          f"acting sets) killed and down, degraded reads == payloads; out, "
          f"every PG clean, reads == payloads, every shard ({moved} of "
          f"them rebuilt on a new OSD) == the plain version's encode; "
          f"0 full rebuilds, 0 failed queued items, 0 dispatch errors, "
          f"0 reaps; {messages} messages routed; fabric leg {len(fobjs)} "
          f"objects == payloads, stats {stats}, {messages_f} messages; "
          f"phase {wall:.1f} s on {name_power}")
    w = served["write"]
    print(f"phase 19 (d): ArtifactStore (64 KiB pages, 1 MiB objects): a "
          f"{SERVE_SHARDS}-shard checkpoint of "
          f"{sum(map(len, serve.ckpt.values()))} B and {SERVE_KV_PAGES} KV "
          f"pages put as {w['objects']} objects at {w['MBps']:.1f} MB/s "
          f"({w['wall_s']:.3f} s, K1 {w['launches']} launches, "
          f"{w['k1_share'] * 100:.2f} % by CUDA events) on {name_power}")
    for half in ("healthy", "degraded"):
        h = served[half]
        print(f"phase 19 (d): {half}: stream {h['stream_MBps']:.1f} MB/s "
              f"({h['stream_s']:.3f} s, cache {h['stream_stats']}); "
              f"{SERVE_WAVES} kvcache waves of {SERVE_WAVE_PAGES} pages: "
              f"p50 {h['wave_p50_ms']:.2f} ms, p99 {h['wave_p99_ms']:.2f} "
              f"ms (cache {h['kv_stats']}); every byte == the put's; K1 "
              f"{h['launches']} launches, {h['k1_ms']:.3f} ms by CUDA "
              f"events ({h['k1_share'] * 100:.2f} % of {h['wall_s']:.3f} s) "
              f"on {name_power}")
    print(f"phase 19 (d): both artifacts deleted with osd.{victim} down "
          f"({served['deleted']} objects)")
    print(f"phase 19 (e): scheduled scrub, no pg_scrub call: pg "
          f"{scrub['pg']} (primary osd.{scrub['primary']}), shard "
          f"{scrub['shard']} bitrotted on osd.{scrub['rot_osd']}, found, "
          f"repaired and verified {scrub['result']} after {scrub['ticks']} "
          f"ticks ({scrub['sim_s']:.0f} sim s, {scrub['wall_s']:.3f} s on "
          f"the host clock, {scrub['scrubs']} scrubs in all, unrepairable "
          f"{scrub['unrepairable']}); shard == the plain encode; peaks "
          f"local {scrub['peak_local']} / remote {scrub['peak_remote']} <= "
          f"osd_max_scrubs {scrub['limit']}; K1 {scrub['launches']} "
          f"launches ({scrub['probe_launches']} compile probes), "
          f"{scrub['k1_ms']:.3f} ms by CUDA events on {name_power}")
    print(f"phase 19 (e): both scrub intervals by `config set osd` on the "
          f"mon, applied by all {scrub['config_osds']} OSDs (MConfig) in "
          f"{scrub['config_s']:.3f} s and removed by `config rm` after; "
          f"log last 50 warn holds the one scrub line "
          f"{scrub['log_line']!r}")
    ro = rep.out
    for leg_name in ("write", "read", "degraded_read", "down_write"):
        lg = ro[leg_name]
        print(f"phase 19 (f): reppool {leg_name} {lg['MBps']:.1f} MB/s on the "
              f"host clock ({lg['wall_s']:.3f} s, 4 MiB objects, size "
              f"{REP_SIZE}) on {name_power}")
    for pool_name, secs in sorted(res["clean_s"].items()):
        print(f"phase 19 (f): time to clean after osd out, {pool_name}: "
              f"{secs:.3f} s on {name_power}")
    rec = ro["recovery"]
    print(f"phase 19 (f): reppool recovery after osd out: "
          f"{rec['push_in']} pushes applied carrying "
          f"{rec['push_in_bytes']} B: {rec['recovery_push']} sent by "
          f"primaries ({rec['backfill_push_in']} of them backfill), "
          f"{rec['push_in'] - rec['recovery_push']} answering pulls; "
          f"{rec['recovery_push_errors']} dropped pulls; "
          f"{ro['replicas_checked']} replicas == payload, xattrs and omap "
          f"(sha256) on their acting OSDs, checked in {ro['verify_s']:.3f} "
          f"s; the pool made and peered in {ro['create_s']:.3f} s on "
          f"{name_power}")
    print(f"phase 19 (f): {REP_INDEX_OBJECTS} index objects of "
          f"{REP_INDEX_KEYS} omap keys in {ro['index_s']:.3f} s, a "
          f"{REP_STRIPED_B} B RadosStriper object in "
          f"{ro['striper_write_s']:.3f} s, both pools listed in "
          f"{ro['list_s']:.3f} s; the EC WriteOp (data + xattr) launched K1 "
          f"{ro['ec_writeop_launches']} times on {name_power}")
    pg_s, prim_s, rep_s = ro["scrub_pg"]
    print(f"phase 19 (f): replicated scrub of pg {pg_s} (primary osd."
          f"{prim_s}, one byte flipped on osd.{rep_s}): " + "; ".join(
              f"pg_scrub(repair={sc['repair']}) {sc['result']} in "
              f"{sc['wall_s']:.3f} s" for sc in ro["scrubs"]) +
          f" on {name_power}")
    so = snap.out
    print(f"phase 19 (f): pool snap s19 on reppool in "
          f"{so['snap_create_s']:.3f} s; {SNAP_OVERWRITES} x {REPAIR_OBJECT} B "
          f"overwritten under it in {so['clone_s']:.3f} s (COW), one removed, "
          f"one created after: {so['clones']} clone objects on the acting "
          f"OSDs; every s19 read == its first payload (sha256, "
          f"{so['s19_read_s']:.3f} s), heads == the new payloads, the removed "
          f"one ENOENT at head, the late one ENOENT at s19, list_snaps == the "
          f"clones; snap_rollback of one object (data and xattrs) in "
          f"{so['rollback_s']:.3f} s on {name_power}")
    print(f"phase 19 (f): ecpool refuses {sorted(so['refusals'])} with "
          f"EOPNOTSUPP; cls on reppool: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in so["cls_s"].items()) +
          f" (an exclusive lock between two clients, refcount get/put, "
          f"version gating, {CLS_AIO_ADDS} concurrent numops adds, "
          f"{CLS_LOG_ENTRIES} log entries added, listed by marker and "
          f"trimmed; every replica's omap equal) on {name_power}")
    nt, mv = so["notify"], so["moved"]
    print(f"phase 19 (f): {WATCH_CLIENTS} watcher clients, {nt['watches']} "
          f"watches on 2 ecpool and 2 reppool objects; {WATCH_NOTIFIES} "
          f"notifies, every reply collected: p50 {nt['p50_ms']:.3f} ms, p99 "
          f"{nt['p99_ms']:.3f} ms on the host clock on {name_power}")
    print(f"phase 19 (f): after the kill, out and clean: {mv['watches']} "
          f"watches on {mv['objects']} objects whose primary moved "
          f"re-registered in {so['relinger_s']:.3f} s and a notify round got "
          f"all {mv['replies']} replies; a dead watcher timed out "
          f"({mv['timed_out']}, {WATCH_TIMEOUT_S} s timeout, "
          f"{so['dead_notify_s']:.3f} s); every s19 read == its first payload "
          f"again ({so['clones_after']} clone objects on the acting OSDs); "
          f"clone bytes pushed {ro['recovery']['push_in_clone_bytes']} on "
          f"{name_power}")
    tr = so["trim"]
    print(f"phase 19 (f): snap_remove(s19): {tr['index_entries']} snap index "
          f"entries trimmed in {tr['ticks']} ticks ({tr['sim_s']:.0f} sim s, "
          f"{tr['wall_s']:.3f} s on the host clock, osd_snap_trim_sleep 0); "
          f"df snaptrim_pgs {tr['snaptrim_pgs_seen']} along the way, then "
          f"{tr['df']['snaptrim_pgs']}; reppool store_bytes "
          f"{tr['df']['store_bytes']} vs bytes {tr['df']['bytes']} on "
          f"{name_power}")
    print_rbd(rbd.out, name_power)
    print_rgw(rgw.out, name_power)
    print_fs(fsl.out, name_power)
    return {"legs": legs, "recover_s": recover_s, "rebuilt": rebuilt,
            "ratio": read / rebuilt, "messages": messages,
            "compiles": compiles, "serve": served, "scrub": scrub,
            "replicated": ro, "snapshots": so, "rbd": rbd.out,
            "rgw": rgw.out, "fs": fsl.out,
            "clean_s": res["clean_s"],
            "fabric_stats": stats, "elastic": elastic, "phase_s": wall}


def print_rbd(ro: dict, name_power: str) -> None:
    tag = "phase 19 (f) rbd"
    sw, rw, rd, cu = (ro["seq_write"], ro["random_write"], ro["read"],
                      ro["copyup"])
    print(f"{tag}: vm0 ({RBD_IMAGE_B} B, order {RBD_ORDER}, rbd_cache on) "
          f"{RBD_SEQ_OBJECTS} x {RBD_OBJ} B written in order at "
          f"{sw['MBps']:.1f} MB/s ({sw['wall_s']:.3f} s), "
          f"{RBD_RANDOM_WRITES} seeded 4 KiB writes at {rw['per_s']:.1f} "
          f"writes/s ({rw['wall_s']:.3f} s), {RBD_SEQ_OBJECTS * RBD_OBJ} B "
          f"read back == the model at {rd['MBps']:.1f} MB/s "
          f"({rd['wall_s']:.3f} s), du {ro['du_objects']} objects on the "
          f"host clock on {name_power}")
    print(f"{tag}: snap base, protect and clone vm0c in "
          f"{ro['snap_clone_s']:.3f} s; {cu['writes']} seeded 4 KiB writes "
          f"to vm0c copied up {cu['objects']} objects in {cu['wall_s']:.3f} "
          f"s; vm0c == its model ({ro['child_read_s']:.3f} s), vm0@base == "
          f"its model ({ro['base_read_s']:.3f} s); the exclusive lock handed "
          f"to the second client in {ro['handoff_s']:.3f} s (its first "
          f"write), {RBD_HANDOFF_WRITES} writes, diff since base "
          f"{ro['diff_objects']} objects on {name_power}")
    m0, mig = ro["mirror"][0], ro["migration"]
    print(f"{tag}: jvm ({RBD_SMALL_B} B, journaling, mirrored) "
          f"{RBD_JOURNAL_WRITES} writes of 4-64 KiB in "
          f"{ro['journal_write_s']:.3f} s; ImageMirror.sync to rbdbak "
          f"replayed {m0['entries']} entries in {m0['wall_s']:.3f} s, the "
          f"copy == the source; migration of a {RBD_SMALL_B} B image "
          f"reppool -> rbdbak with {mig['writes']} concurrent 4 KiB writes: "
          f"execute {mig['execute_s']:.3f} s, prepare to commit "
          f"{mig['wall_s']:.3f} s, == the model; K1 launches in the leg "
          f"{ro['launches']}; {ro['before_s']:.3f} s before the kill on "
          f"{name_power}")
    m1, reads = ro["mirror"][1], ro["reads_after_s"]
    print(f"{tag}: after the kill, out and clean: the holder answered on "
          f"vm0's header in {ro['holder_answer_s']:.3f} s and still holds "
          f"the lock; " + ", ".join(f"{k} {v:.3f} s" for k, v in reads.items())
          + f" == their models; the mirror replayed {m1['entries']} entries "
          f"in {m1['wall_s']:.3f} s; failback (demote, sync, promote on "
          f"rbdbak) {ro['failback_s']:.3f} s; flatten {ro['flatten_s']:.3f} "
          f"s; images and rbdbak removed in {ro['cleanup_s']:.3f} s; K1 "
          f"launches {ro['launches_after']}; counts {ro['counts']}; "
          f"{ro['after_s']:.3f} s after the recovery on {name_power}")


def print_legs(tag: str, legs: dict, name_power: str) -> None:
    for name, lg in legs.items():
        print(f"{tag}: {name} {lg['MBps']:.1f} MB/s on the host clock "
              f"({lg['wall_s']:.3f} s), K1 {lg['launches']} launches, "
              f"{lg['k1_ms']:.3f} ms by CUDA events "
              f"({lg['k1_share'] * 100:.2f} % of it) on {name_power}")


# ---------------------------------------------------------------------------
# The cluster on TCP and in processes: phase 20

# seconds of each `rados bench` run in 20 (c) and 21, cut from the 8 s
# of the first runs to keep the smoke's wall (PERF.md section 4)
PROC_BENCH_S = 2                 # cut from 8, then 4 (PERF.md 4)
PROC_THREADS = 16                # rados bench -t
PROC_DEGRADED = 16               # bench objects read degraded
PROC_BOOT_S = 180.0


def tcp_leg(name_power: str, dev) -> dict:
    """Phase 20 (a): phase 19's cell over TCP with cephx on."""
    rng = np.random.default_rng(SEED + 20)
    objs = {f"obj{i}": rng.integers(0, 256, REPAIR_OBJECT,
                                    dtype=np.uint8).tobytes()
            for i in range(TCP_OBJECTS)}
    t_leg = time.monotonic()
    c, r, io = _cluster(tcp=True, dev=dev)
    try:
        boot_s = time.monotonic() - t_leg
        frames0, bytes0 = c.network.frames_sent, c.network.bytes_sent
        res = drive_cluster(c, r, io, objs, "phase 20", dev, snapshot=True)
        frames = c.network.frames_sent - frames0
        nbytes = c.network.bytes_sent - bytes0
        # every shard on its acting OSD, rebuilt or moved, equals the
        # shard before the kill (phase 19 holds those to the plain
        # version's encode)
        moved = 0
        for oid, s, osd, got, was, _pg in _shards_on_acting(
                c, objs, res, "phase 20"):
            if got != res["shards"][oid, s]:
                raise AssertionError(f"phase 20: {oid} shard {s} on osd."
                                     f"{osd} differs from before the kill")
            moved += osd != was
        if not moved:
            raise AssertionError("phase 20: no shard moved to a new OSD")
        daemons = [c.mon] + list(c.osds.values())
        verified = sum(d.ms.auth_verifier.verified for d in daemons)
        rejected = sum(d.ms.auth_verifier.rejected for d in daemons)
        if rejected or not verified:
            raise AssertionError(f"phase 20: cephx verified {verified}, "
                                 f"rejected {rejected}")
    finally:
        c.shutdown()
    wall = time.monotonic() - t_leg
    legs = res["legs"]
    print_legs("phase 20 (a) tcp+cephx", legs, name_power)
    print(f"phase 20 (a): time to recover {res['recover_s']:.3f} s, rebuilt "
          f"{res['rebuilt']} B; every shard == its bytes before the kill "
          f"({moved} of them on a new OSD); "
          f"read/rebuilt {res['read'] / res['rebuilt']}; on the wire "
          f"{frames} frames, {nbytes} B; cephx signatures verified "
          f"{verified}, rejected {rejected}; boot {boot_s:.1f} s; osd."
          f"{res['victim']} in {res['count'][res['victim']]} acting sets; "
          f"0 dispatch errors, 0 failed queued items, 0 full rebuilds; leg "
          f"{wall:.1f} s on {name_power}")
    return {"legs": legs, "recover_s": res["recover_s"],
            "rebuilt": res["rebuilt"], "frames": frames, "bytes": nbytes,
            "cephx_verified": verified, "cephx_rejected": rejected,
            "wall_s": wall}


def dryrun_leg(name_power: str, dev) -> dict:
    """Phase 20 (b): dryrun_multichip(8) on ["cuda:0"] * 8; every shard
    the fabric write stored equals the plain version's encode."""
    from ceph_tpu_torch.dryrun import dryrun_multichip
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    l0 = bm.LAUNCHES["gf_matmul"]
    t0 = time.monotonic()
    res = dryrun_multichip(8, devices=[dev] * 8)
    wall = time.monotonic() - t0
    launches = bm.LAUNCHES["gf_matmul"] - l0
    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M)},
                              device="cpu")
    want = ecutil.encode(ecutil.StripeInfo(K, K * STRIPE_UNIT), ec_cpu,
                         res["payload"])
    for s, got in res["stored"].items():
        if got != want[s]:
            raise AssertionError(f"phase 20 (b): shard {s} differs from the "
                                 "plain version's encode")
    print(f"phase 20 (b): dryrun_multichip(8) on ['cuda:0'] * 8: mesh "
          f"encode and decode of [1, 9] == oracle; mon + 16 OSDs + client "
          f"each on its own TCP socket, a {len(res['payload'])} B fabric "
          f"write (stats {res['fabric']}), its 12 stored shards == the "
          f"plain version's encode, osd.{res['victim']} killed and down, "
          f"degraded read == payload; K1 {launches} launches; {wall:.1f} s "
          f"on {name_power}")
    return {"wall_s": wall, "launches": launches, "fabric": res["fabric"]}


# Ports for daemons that bind only after their imports (about 20 s):
# below Linux's ephemeral range (32768 and up by default), which the
# kernel draws outgoing connections' ports from.  A port picked inside
# that range (bind to 0, then close) can be handed to another daemon's
# outgoing connection in that time, and the daemon then fails to bind
# it with EADDRINUSE; phase 21 once did.
DAEMON_PORTS = range(20000, 32768)


def _daemon_ports(n: int) -> list[int]:
    """`n` distinct ports of DAEMON_PORTS that bind now, in random order
    (two runs on one machine seldom draw the same)."""
    ports = []
    for port in random.sample(DAEMON_PORTS, len(DAEMON_PORTS)):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
        if len(ports) == n:
            return ports
    raise AssertionError(f"only {len(ports)} of {n} ports free in "
                         f"{DAEMON_PORTS}")


class Daemons:
    """`daemon_main` processes of one cluster (a mon and OSDs), each on
    the card with a keyring and an admin socket; stopped on exit.  With
    `data`, each daemon keeps its store in `data/<name>` (`--data-dir`:
    the mon's LogDB, each OSD's BlueStore).  `tag` names the phase in
    errors."""

    def __init__(self, work: Path, n_osd: int, tag: str = "phase 20 (c)",
                 data: Path | None = None):
        from ceph_tpu_torch.auth import KeyRing

        self.work, self.n_osd, self.tag, self.data = work, n_osd, tag, data
        names = ["mon.0"] + [f"osd.{i}" for i in range(n_osd)]
        ports = _daemon_ports(len(names))
        self.addrs = {n: ["127.0.0.1", p] for n, p in zip(names, ports)}
        self.monmap = work / "monmap.json"
        self.monmap.write_text(json.dumps({
            "addrs": self.addrs, "mon_ranks": [0], "n_osd": n_osd,
            "osds_per_host": 1}))
        self.keyring_path = work / "keyring.json"
        # mgr.0: phase 21's devicehealth mgr, in the smoke's process
        # client.rgw: 20 (c)'s radosgw process
        self.keyring = KeyRing.generate(names + ["client.admin",
                                                 "client.smoke", "mgr.0",
                                                 "client.rgw"])
        self.keyring.save(str(self.keyring_path))
        self.env = dict(os.environ,
                        PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.procs: dict[str, subprocess.Popen] = {}
        self.spawned: dict[str, float] = {}

    def asok(self, name: str) -> str:
        return str(self.work / f"{name}.asok")

    def spawn(self, name: str, env: dict | None = None) -> None:
        """Start one daemon; `env` adds to the environment of this
        process alone."""
        role, ident = name.split(".")
        argv = [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main",
                role, "--rank" if role == "mon" else "--id", ident,
                "--monmap", str(self.monmap), "--keyring",
                str(self.keyring_path), "--asok", self.asok(name)]
        if self.data is not None:
            argv += ["--data-dir", str(self.data / name)]
        # a killed daemon leaves its socket file: serving means a new one
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self.asok(name))
        log = open(self.work / f"{name}.log", "a")
        self.spawned[name] = time.time()
        self.procs[name] = subprocess.Popen(
            argv, env={**self.env, **(env or {})},
            cwd=self.env["PYTHONPATH"], stdout=log,
            stderr=subprocess.STDOUT)
        log.close()

    def wait_serving(self, names, timeout: float = PROC_BOOT_S) -> None:
        end = time.monotonic() + timeout
        for name in names:
            while not os.path.exists(self.asok(name)):
                if self.procs[name].poll() is not None:
                    raise AssertionError(
                        f"{self.tag}: {name} exited: "
                        f"{(self.work / f'{name}.log').read_text()[-2000:]}")
                if time.monotonic() > end:
                    raise AssertionError(f"{self.tag}: {name} not serving "
                                         f"within {timeout:.0f} s")
                time.sleep(0.05)

    def command(self, name: str, cmd: str):
        from ceph_tpu_torch.common.admin_socket import admin_command
        rc, out = admin_command(self.asok(name), cmd)
        if rc != 0:
            raise AssertionError(f"{self.tag}: {name} {cmd}: {out}")
        return out

    def startup(self, name: str) -> dict:
        """The start-up split of one daemon, in seconds, from its
        admin socket's stamps."""
        st = self.command(name, "startup")
        # a daemon off the card (a CPU rehearsal) has no cuda stamps
        cuda = st.get("cuda", st["imported"])
        kernels = st.get("kernels", cuda)
        store = st.get("store", kernels)
        out = {"interpreter": st["main"] - self.spawned[name],
               "imports": st["imported"] - st["main"],
               "cuda": cuda - st["imported"], "kernels": kernels - cuda}
        if self.data is not None:
            out["store"] = store - kernels
        out["join"] = st["serving"] - store
        return out

    def kill(self, name: str) -> None:
        self.procs[name].kill()
        self.procs[name].wait(30)

    def terminate(self, name: str) -> None:
        """A clean stop: SIGTERM, the daemon unmounts its store."""
        self.procs[name].terminate()
        self.procs[name].wait(60)

    def live(self) -> list[str]:
        return [n for n, p in self.procs.items() if p.poll() is None]

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(15)


def _proc_faults(ds: Daemons, names) -> dict:
    """Each daemon's fault counters through its admin socket; fails on
    any tick error, failed queued item, full rebuild, dropped pull or
    dispatch error."""
    out = {}
    for name in names:
        perf = ds.command(name, "perf dump")
        row = {k: perf.get(k, 0) for k in ("tick_errors", "queued_op_failures",
                                          "recovery_full_rebuild",
                                          "recovery_push_errors")}
        row["dispatch_errors"] = ds.command(name, "msgr")["dispatch_errors"]
        if any(row.values()):
            raise AssertionError(f"{ds.tag}: {name} counters {row}")
        out[name] = row
    return out


def _proc_clean(ds: Daemons, names, osdmap) -> bool:
    """Every OSD in `names` at the map's epoch, every PG of its pools
    with a primary that is clean."""
    st = [ds.command(n, "status") for n in names if n.startswith("osd.")]
    pgs = sum(p.pg_num for p in osdmap.pools.values())
    return (all(s["osdmap_epoch"] >= osdmap.epoch and s["pgs_recovering"] == 0
                for s in st) and
            sum(s["num_primary"] for s in st) == pgs and
            sum(s["primary_clean"] for s in st) == pgs)


def _cli(ds: Daemons, *argv, env: dict | None = None,
         tool: str = "rados_cli") -> tuple[str, float]:
    """One `rados_cli` (or `tool`) process with the cluster's monmap and
    keyring; its stdout and wall.  A non-zero exit fails the phase.
    `env` adds to the process's environment."""
    cmd = [sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}",
           "--monmap", str(ds.monmap), "--keyring", str(ds.keyring_path),
           "--timeout", "120", *argv]
    t0 = time.monotonic()
    p = subprocess.run(cmd, env={**ds.env, **(env or {})},
                       cwd=ds.env["PYTHONPATH"],
                       capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    if p.returncode != 0:
        raise AssertionError(f"{ds.tag}: {tool} {' '.join(argv)} rc "
                             f"{p.returncode}:\n{p.stdout}\n{p.stderr[-3000:]}")
    return p.stdout, wall


def _bench(ds: Daemons, mode: str, seconds: float = PROC_BENCH_S,
           pool: str = "ecpool", env: dict | None = None) -> dict:
    out, wall = _cli(ds, "bench", pool, str(seconds), mode, "-t",
                     str(PROC_THREADS),
                     *(["--no-cleanup"] if mode == "write" else []),
                     env=env)
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    return {"MBps": float(fields["Bandwidth (MB/sec)"]),
            "ops": int(fields[f"Total {mode}s made"]),
            "size": int(fields[f"{mode} size"]),
            "lat_s": float(fields["Average Latency(s)"]),
            "run_s": float(fields["Total time run"]), "cli_wall_s": wall}


def trace_bench_write(ds: Daemons, osds: list) -> dict:
    """`rados trace <id> --asok-dir <dir>` on one traced EC write of the
    write bench: the id of the newest ec_encode_kernel span in the first
    OSD ring that holds one, the tree assembled by a CLI process from
    every admin socket (the mon's and the OSDs')."""
    tag = "phase 20 (c)"
    newest = None
    for name in osds:
        # a ring lists its spans as they finished: the last is the newest
        enc = [sp for sp in ds.command(name, "dump_traces")
               if sp["name"] == "ec_encode_kernel"]
        if enc:
            newest = (name, enc[-1])
            break
    if newest is None:
        raise AssertionError(f"{tag}: no ec_encode_kernel span in any ring")
    tid = newest[1]["trace_id"]
    out, wall = _cli(ds, "trace", tid, "--asok-dir", str(ds.work))
    lines = out.splitlines()
    tree = [ln for ln in lines[1:] if not ln.lstrip().startswith("@")]
    head = re.fullmatch(rf"trace {tid}: (\d+) spans from (\d+) daemons, "
                        r"(\d+) root\(s\)", lines[0] if lines else "")
    roots = [ln for ln in tree if not ln.startswith(" ")]
    subs = [ln for ln in tree if ln.startswith("  ec_sub_write [osd.")]
    enc = [ln for ln in tree
           if ln.startswith(f"  ec_encode_kernel [{newest[0]}]")]
    if head is None or int(head.group(2)) != len(osds) + 1 or \
            head.group(3) != "1" or len(roots) != 1 or \
            not roots[0].startswith(f"osd_op:write_full [{newest[0]}]") or \
            len(enc) != 1 or len(subs) != K + M - 1 or \
            len({ln.split("[")[1] for ln in subs}) != K + M - 1:
        raise AssertionError(f"{tag}: rados trace {tid}:\n{out}")
    return {"trace_id": tid, "primary": int(newest[0].split(".")[1]),
            "spans": int(head.group(1)), "asked": int(head.group(2)),
            "sub_writes": len(subs), "wall_s": wall, "tree": tree}


# phase 20 (c)'s `rbd` verbs on reppool and their text, which
# tests/test_torch_rbd.py holds to the reference CLI's
RBD_CLI_STEPS = [
    (("create", "--size", "1G", "img"), "created image img\n"),
    (("snap", "create", "img@s"), "created snapshot img@s\n"),
    (("du", "img"), "img provisioned 1 GiB used 0 B\n"),
    (("info", "img"), "rbd image 'img':\n\tsize 1 GiB in 256 objects\n"
                      "\torder 22 (4 MiB objects)\n")]


def _await_pool(r, pool: str, present: bool, tag: str) -> None:
    """Wait until the client's map has (or no longer has) `pool`."""
    end = time.monotonic() + CLUSTER_TIMEOUT_S
    while (pool in r.objecter.osdmap.pool_names.values()) != present:
        if time.monotonic() > end:
            raise AssertionError(f"{tag}: {pool} never "
                                 f"{'in' if present else 'out of'} the map")
        with contextlib.suppress(TimeoutError):
            r.objecter.wait_for_map(r.objecter.osdmap.epoch + 1, 1.0)


def rep_cli(ds: Daemons, r, wait_clean, name_power: str) -> dict:
    """Phase 20 (c)'s replicated verbs, each a `rados_cli` process:
    `mkpool reppool 32` (a replicated pool), `bench reppool 2 write -t 16
    --no-cleanup` and `bench reppool 2 seq -t 16` (seq finds its objects
    by listing), `ls`, `setxattr` / `getxattr` / `listxattr`,
    `setomapval` / `listomapvals` on a bench object, then `rmpool`;
    every output held to the reference's text."""
    tag = ds.tag
    walls = {}
    out, walls["mkpool"] = _cli(ds, "mkpool", "reppool", str(REP_PG_NUM))
    if out != "successfully created pool reppool\n":
        raise AssertionError(f"{tag}: mkpool printed {out!r}")
    _await_pool(r, "reppool", True, tag)
    pool = r.objecter.osdmap.pools[r.pool_lookup("reppool")]
    if (pool.type, pool.size, pool.min_size) != (1, REP_SIZE, REP_MIN_SIZE):
        raise AssertionError(f"{tag}: mkpool made type {pool.type} size "
                             f"{pool.size}/{pool.min_size}")
    wait_clean("reppool's PGs peered")
    bench = {"write": _bench(ds, "write", pool="reppool")}
    bench["seq"] = _bench(ds, "seq", pool="reppool")
    out, walls["ls"] = _cli(ds, "ls", "reppool")
    listed = out.split()
    if len(listed) != bench["write"]["ops"] or not all(
            o.startswith("benchmark_data_") for o in listed):
        raise AssertionError(f"{tag}: ls listed {len(listed)} objects for "
                             f"{bench['write']['ops']} bench writes")
    obj = listed[0]
    steps = [(("setxattr", "reppool", obj, "smoke_key", "smoke_value"), ""),
             (("getxattr", "reppool", obj, "smoke_key"), "smoke_value\n"),
             (("listxattr", "reppool", obj), "smoke_key\n"),
             (("setomapval", "reppool", obj, "smoke_omap", "omap_value"), ""),
             (("listomapvals", "reppool", obj),
              "smoke_omap\n value (10 bytes) :\nomap_value\n")]
    for argv, want in steps:
        out, walls[argv[0]] = _cli(ds, *argv)
        if out != want:
            raise AssertionError(f"{tag}: rados {' '.join(argv)} printed "
                                 f"{out!r}, not {want!r}")
    # the rbd CLI on the same pool, each verb a process
    rbd_walls = {}
    for argv, want in RBD_CLI_STEPS:
        out, rbd_walls[" ".join(argv[:2])] = _cli(
            ds, "-p", "reppool", *argv, tool="rbd_cli")
        if out != want:
            raise AssertionError(f"{tag}: rbd {' '.join(argv)} printed "
                                 f"{out!r}, not {want!r}")
    out, walls["rmpool"] = _cli(ds, "rmpool", "reppool")
    if out != "successfully deleted pool reppool\n":
        raise AssertionError(f"{tag}: rados rmpool printed {out!r}")
    _await_pool(r, "reppool", False, tag)
    wait_clean("the PGs after rmpool")
    for mode, b in bench.items():
        print(f"phase 20 (c): rados bench reppool (replicated, size "
              f"{REP_SIZE}) {mode} -t {PROC_THREADS} -b {b['size']}: "
              f"{b['MBps']} MB/s, {b['ops']} ops, average latency "
              f"{b['lat_s']} s in {b['run_s']} s (CLI process "
              f"{b['cli_wall_s']:.1f} s) on {name_power}")
    print(f"phase 20 (c): rados_cli processes mkpool (replicated), ls "
          f"({len(listed)} objects), setxattr, getxattr, listxattr, "
          f"setomapval, listomapvals, rmpool: text == the reference's; "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) +
          f" s on {name_power}")
    print(f"phase 20 (c): rbd_cli processes on reppool: " + ", ".join(
        f"{k} {v:.2f}" for k, v in rbd_walls.items()) + f" s "
          f"({sum(rbd_walls.values()):.2f} s in all), text == the "
          f"reference's, on {name_power}")
    return {"bench": bench, "walls": walls, "listed": len(listed),
            "rbd_walls": rbd_walls}


RGW_PROC_OBJECTS = 8             # 4 MiB objects through the radosgw process


def rgw_process(ds: Daemons, r, wait_clean, name_power: str) -> dict:
    """Phase 20 (c)'s radosgw: `python -m ceph_tpu_torch.rgw.gateway` over
    the daemon processes, authenticated as client.rgw with the cluster's
    keyring (an anonymous S3 gateway, as the reference's `main` makes
    it); it makes its pool `rgw`; 8 x 4 MiB PUT, GET == the payloads and
    a listing over HTTP; SIGTERM, rc 0; then `rmpool rgw`."""
    import select
    import signal

    tag = ds.tag
    rng = np.random.default_rng(SEED + 201)
    objs = {f"o{i}": rng.bytes(RGW_OBJ) for i in range(RGW_PROC_OBJECTS)}
    log = open(ds.work / "radosgw.log", "w")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.rgw.gateway", "--monmap",
         str(ds.monmap), "--keyring", str(ds.keyring_path), "--port", "0",
         "--pool", RGW_POOL, "--name", "client.rgw"],
        env=ds.env, cwd=ds.env["PYTHONPATH"], stdout=subprocess.PIPE,
        stderr=log, text=True)
    log.close()
    s3 = None
    try:
        line, end = "", time.monotonic() + PROC_BOOT_S
        while not line:
            if proc.poll() is not None or time.monotonic() > end:
                raise AssertionError(
                    f"{tag}: radosgw not serving (rc {proc.poll()}): "
                    f"{(ds.work / 'radosgw.log').read_text()[-2000:]}")
            if select.select([proc.stdout], [], [], 0.1)[0]:
                line = proc.stdout.readline()
        m = re.match(rf"rgw: serving S3 on :(\d+) pool={RGW_POOL}$",
                     line.strip())
        if not m:
            raise AssertionError(f"{tag}: radosgw printed {line!r}")
        startup_s = time.monotonic() - t0
        s3 = S3Client(int(m.group(1)), "", "")
        _s3_ok(s3("PUT", "/pb"), 200, "PUT pb", tag)
        t0 = time.monotonic()
        for key, data in objs.items():
            hdrs = _s3_ok(s3("PUT", f"/pb/{key}", data), 200,
                          f"PUT pb/{key}", tag)[1]
            if hdrs["ETag"] != f'"{hashlib.md5(data).hexdigest()}"':
                raise AssertionError(f"{tag}: radosgw ETag {hdrs['ETag']}")
        put_s = time.monotonic() - t0
        t0 = time.monotonic()
        for key, data in objs.items():
            if _s3_ok(s3("GET", f"/pb/{key}"), 200, f"GET pb/{key}",
                      tag)[2] != data:
                raise AssertionError(f"{tag}: radosgw GET pb/{key} differs")
        get_s = time.monotonic() - t0
        body = _s3_ok(s3("GET", "/pb?list-type=2"), 200, "list pb", tag)[2]
        if re.findall(rb"<Key>([^<]+)</Key>", body) != \
                [k.encode() for k in sorted(objs)]:
            raise AssertionError(f"{tag}: radosgw listed {body[:300]!r}")
        s3.close()
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        stop_s = time.monotonic() - t0
        if rc != 0:
            raise AssertionError(f"{tag}: radosgw exited {rc} on SIGTERM")
    finally:
        if s3 is not None:
            s3.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stdout.close()
    out, _ = _cli(ds, "rmpool", RGW_POOL)
    if out != f"successfully deleted pool {RGW_POOL}\n":
        raise AssertionError(f"{tag}: rados rmpool printed {out!r}")
    _await_pool(r, RGW_POOL, False, tag)
    wait_clean("the PGs after rmpool rgw")
    nbytes = RGW_PROC_OBJECTS * RGW_OBJ
    res = {"startup_s": startup_s, "put_MBps": nbytes / put_s / 1e6,
           "get_MBps": nbytes / get_s / 1e6, "stop_s": stop_s}
    print(f"{tag}: radosgw process (client.rgw, cephx) serving in "
          f"{startup_s:.2f} s from its spawn; {RGW_PROC_OBJECTS} x {RGW_OBJ} "
          f"B PUT at {res['put_MBps']:.1f} MB/s, GET == the payloads at "
          f"{res['get_MBps']:.1f} MB/s, listed; SIGTERM -> rc 0 in "
          f"{stop_s:.2f} s; pool {RGW_POOL} removed, on {name_power}")
    return res


def process_leg(name_power: str, work: Path) -> dict:
    """Phase 20 (c): a mon and 16 OSD daemon processes on the card,
    `rados bench` write then seq through the CLI, the replicated verbs
    (`rep_cli`), then the OSD in the most acting sets killed, marked
    down, and bench objects read degraded."""
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.msg.tcp import TcpNet
    from ceph_tpu_torch.osd.types import PG

    work.mkdir(parents=True, exist_ok=True)
    t_leg = time.monotonic()
    ds = Daemons(work, CLUSTER_OSDS)
    r = None
    try:
        # all at once: each OSD boots when the mon accepts connections
        osds = [f"osd.{i}" for i in range(CLUSTER_OSDS)]
        for name in ["mon.0"] + osds:
            ds.spawn(name)
        ds.wait_serving(["mon.0"] + osds)
        boot_s = time.monotonic() - t_leg
        startup = {name: ds.startup(name) for name in ["mon.0"] + osds}
        net = TcpNet({k: tuple(v) for k, v in ds.addrs.items()})
        r = Rados(net, name="client.smoke", op_timeout=CLUSTER_TIMEOUT_S,
                  auth_secret=ds.keyring.get("client.smoke")).connect(60.0)
        end = time.monotonic() + PROC_BOOT_S
        while sum(r.objecter.osdmap.is_up(o)
                  for o in range(CLUSTER_OSDS)) < CLUSTER_OSDS:
            if time.monotonic() > end:
                raise AssertionError("phase 20 (c): OSDs never all up")
            time.sleep(0.05)
        rc, outs, _ = r.mon_command(PROFILE_CMD)
        if rc != 0:
            raise AssertionError(f"phase 20 (c): profile set: {outs}")
        r.pool_create("ecpool", pg_num=CLUSTER_PG_NUM, pool_type="erasure",
                      erasure_code_profile="tpu_k8m4")

        def wait_clean(names, what):
            end = time.monotonic() + CLUSTER_TIMEOUT_S
            while not _proc_clean(ds, names, r.objecter.osdmap):
                if time.monotonic() > end:
                    raise AssertionError(f"phase 20 (c): {what}")
                time.sleep(0.1)

        wait_clean(osds, "the new pool's PGs peered")

        def launches(names):
            return sum(ds.command(n, "kernel launches")["gf_matmul"]
                       for n in names)

        l0 = launches(osds)
        # the write bench's client traces every op (blkin_trace_all):
        # each daemon keeps the spans of its part in its ring
        bench = {"write": _bench(ds, "write",
                                 env={"CEPH_TPU_BLKIN_TRACE_ALL": "1"})}
        l1 = launches(osds)
        trace = trace_bench_write(ds, osds)
        bench["seq"] = _bench(ds, "seq")
        l2 = launches(osds)
        rep = rep_cli(ds, r, lambda what: wait_clean(osds, what), name_power)
        rgw = rgw_process(ds, r, lambda what: wait_clean(osds, what),
                          name_power)
        # the bench's objects, found by listing; one payload in all
        io = r.open_ioctx("ecpool")
        bench_objs = sorted(o for o in io.list_objects()
                            if o.startswith("benchmark_data_"))
        if len(bench_objs) != bench["write"]["ops"]:
            raise AssertionError(f"phase 20 (c): {len(bench_objs)} bench "
                                 f"objects listed for {bench['write']['ops']}"
                                 " writes")
        payload = io.read(bench_objs[0])
        if len(payload) != bench["write"]["size"]:
            raise AssertionError("phase 20 (c): a bench object of "
                                 f"{len(payload)} B")
        # -- the OSD in the most acting sets dies -----------------------------
        pid = r.pool_lookup("ecpool")
        _, count = acting_sets(r.objecter.osdmap, pid, CLUSTER_PG_NUM, PG)
        victim = max(sorted(count), key=lambda o: count[o])
        faults = _proc_faults(ds, ["mon.0"] + osds)
        ds.kill(f"osd.{victim}")
        rc, outs, _ = r.mon_command({"prefix": "osd down", "ids": [victim]})
        if rc != 0:
            raise AssertionError(f"phase 20 (c): osd down: {outs}")
        live = [n for n in osds if n != f"osd.{victim}"]
        end = time.monotonic() + CLUSTER_TIMEOUT_S
        while not r.objecter.osdmap.is_down(victim):
            if time.monotonic() > end:
                raise AssertionError("phase 20 (c): victim never down")
            time.sleep(0.05)
        wait_clean(live, "peering after osd down")
        l3 = launches(live)
        n_read = min(PROC_DEGRADED, len(bench_objs))
        t0 = time.monotonic()
        for oid in bench_objs[:n_read]:
            if io.read(oid) != payload:
                raise AssertionError(f"phase 20 (c): degraded read of bench "
                                     f"object {oid} differs")
        degraded_s = time.monotonic() - t0
        l4 = launches(live)
        faults.update(_proc_faults(ds, ["mon.0"] + live))
    finally:
        if r is not None:
            r.shutdown()
        ds.stop()
    wall = time.monotonic() - t_leg
    degraded = {"MBps": n_read * len(payload) / degraded_s / 1e6,
                "wall_s": degraded_s}
    for mode, b in bench.items():
        print(f"phase 20 (c): rados bench {mode} -t {PROC_THREADS} -b "
              f"{b['size']}: {b['MBps']} MB/s, {b['ops']} ops, average "
              f"latency {b['lat_s']} s in {b['run_s']} s (CLI process "
              f"{b['cli_wall_s']:.1f} s) on {name_power}")
    print(f"phase 20 (c): `rados trace {trace['trace_id']} --asok-dir` over "
          f"{trace['asked']} admin sockets in {trace['wall_s']:.1f} s (CLI "
          f"process): one write_full of the traced write bench, "
          f"{trace['spans']} spans in one tree: the primary osd."
          f"{trace['primary']}'s osd_op with its ec_encode_kernel (K1) and "
          f"{trace['sub_writes']} ec_sub_write spans on the other shards' "
          f"OSDs:")
    for line in trace["tree"]:
        print(f"phase 20 (c):   {line}")
    print(f"phase 20 (c): osd.{victim} (in {count[victim]} acting sets) "
          f"killed and down: {n_read} bench objects read degraded == "
          f"payload at {degraded['MBps']:.1f} MB/s ({degraded_s:.3f} s) on "
          f"{name_power}")
    for name, st in startup.items():
        print(f"phase 20 (c): {name} start-up " + ", ".join(
            f"{part} {v:.2f}" for part, v in st.items()) + " s; " +
            ", ".join(f"{k} {v}" for k, v in faults[name].items()))
    for part in ("interpreter", "imports", "cuda", "kernels", "join"):
        vals = sorted(s[part] for s in startup.values())
        print(f"phase 20 (c): start-up {part}: min {vals[0]:.2f} median "
              f"{statistics.median(vals):.2f} max {vals[-1]:.2f} s over "
              f"{len(vals)} daemons")
    k1 = {"write": l1 - l0, "seq": l2 - l1, "degraded_read": l4 - l3}
    sums = {k: sum(row[k] for row in faults.values())
            for k in next(iter(faults.values()))}
    print(f"phase 20 (c): K1 launches in the OSD processes (their admin "
          f"sockets): {k1}; summed over {len(faults)} daemons' admin "
          f"sockets {sums}; boot {boot_s:.1f} s, leg {wall:.1f} s")
    if not k1["write"] or not k1["degraded_read"]:
        raise AssertionError(f"phase 20 (c): K1 launches {k1}")
    return {"bench": bench, "degraded": degraded, "startup": startup,
            "launches": k1, "replicated": rep, "rgw": rgw,
            "trace": {k: v for k, v in trace.items() if k != "tree"},
            "faults": faults, "wall_s": wall, "boot_s": boot_s}


def tcp_phase(name_power: str, dev, work: Path) -> dict:
    """Phase 20: the cluster on TCP (a), the dry run (b), processes (c)."""
    t_phase = time.monotonic()
    tcp = tcp_leg(name_power, dev)
    dry = dryrun_leg(name_power, dev)
    proc = process_leg(name_power, work)
    wall = time.monotonic() - t_phase
    print(f"phase 20: legs {tcp['wall_s']:.1f} + {dry['wall_s']:.1f} + "
          f"{proc['wall_s']:.1f} s; phase {wall:.1f} s on {name_power}")
    return {"tcp": tcp, "dryrun": dry, "processes": proc, "phase_s": wall}


# ---------------------------------------------------------------------------
# The vstart shell: phase 20 (d)

VSTART_OSDS = 12                 # one OSD per host: k + m hosts
VSTART_PG_NUM = 8                # cut from phase 19's 32 (the smoke's wall)
VSTART_OBJECTS = 8               # seeded 4 MiB objects put and got back
VSTART_SEED = SEED + 24


class TourScript:
    """The vstart shell's standard input: each item is a command line,
    or a callable given the shell that returns a line (one that reads
    what the shell printed so far) or None (a check between commands).
    It is not a terminal, so `main` reads it after its -c commands."""

    def __init__(self, items: list, shells: list):
        self.items, self.shells = items, shells

    def isatty(self) -> bool:
        return False

    def __iter__(self):
        for item in self.items:
            line = item(self.shells[0]) if callable(item) else item
            if line is not None:
                yield line + "\n"


def _recording_shell(vstart, shells: list, log: list):
    """vstart's shell class, recording each instance and each command's
    text, status, host seconds and K1 and K3 launches (the wrappers'
    counts before and after it)."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    class Recorded(vstart.VstartShell):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            shells.append(self)

        def run_line(self, line: str) -> bool:
            start = len(self.out.getvalue())
            k0 = (bm.LAUNCHES["gf_matmul"], cb.LAUNCHES["crush_do_rule"])
            t0 = time.monotonic()
            alive = super().run_line(line)
            text = self.out.getvalue()[start:]
            if line.strip():
                log.append({"cmd": line.strip(), "text": text,
                            "ok": not text.startswith("Error:"),
                            "s": time.monotonic() - t0,
                            "k1": bm.LAUNCHES["gf_matmul"] - k0[0],
                            "k3": cb.LAUNCHES["crush_do_rule"] - k0[1]})
            return alive
    return Recorded


def vstart_leg(name_power: str, work: Path, args: tuple = ()) -> dict:
    """Phase 20 (d) (see the module docstring): the vstart tour through
    `ceph_tpu_torch.tools.vstart.main`, in this process, its standard
    output captured to `work/vstart.txt`.  `args` goes before the tour's
    own arguments (a rehearsal passes `--device cpu`)."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd.types import PG
    from ceph_tpu_torch.tools import vstart

    tag = "phase 20 (d)"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(VSTART_SEED)
    objs, paths = {}, {}
    for i in range(VSTART_OBJECTS):
        oid = f"obj{i}"
        objs[oid] = rng.integers(0, 256, REPAIR_OBJECT,
                                 dtype=np.uint8).tobytes()
        paths[oid] = work / f"{oid}.in"
        paths[oid].write_bytes(objs[oid])
    art = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    (work / "art.in").write_bytes(art)
    shells: list = []
    log: list = []
    seen: dict = {}

    def last(prefix: str) -> str:
        return next(e["text"] for e in reversed(log)
                    if e["cmd"].startswith(prefix))

    def pgid_of(sh, oid: str) -> str:
        m = sh.cluster.mon.osdmap
        pid = sh.rados.pool_lookup("ecp")
        pg = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
        return f"{pid}.{pg.ps:x}"

    def read_back(sh):
        for oid, data in objs.items():
            got = (work / f"{oid}.out").read_bytes()
            if hashlib.sha256(got).digest() != \
                    hashlib.sha256(data).digest():
                raise AssertionError(f"{tag}: get {oid} != its put (sha256)")
        pid = sh.rados.pool_lookup("ecp")
        seen["shards"] = _ec_shards_plain(sh.cluster, pid, objs, {}, tag)

    def trace_id(sh):
        ids = last("trace ls").split()
        if not ids:
            raise AssertionError(f"{tag}: trace ls listed no trace")
        return f"trace {ids[-1]}"

    def victim(sh):
        m = sh.cluster.mon.osdmap
        pid = sh.rados.pool_lookup("ecp")
        seen["victim"] = m.pg_to_up_acting_osds(
            m.object_locator_to_pg("obj0", pid))[2][0]
        seen["decode0"] = split["decode"]
        return f"kill-osd {seen['victim']}"

    def degraded(sh):
        got = (work / "obj0.degraded").read_bytes()
        if hashlib.sha256(got).digest() != \
                hashlib.sha256(objs["obj0"]).digest():
            raise AssertionError(f"{tag}: the degraded get of obj0 != its "
                                 "put (sha256)")
        seen["degraded_decodes"] = split["decode"] - seen["decode0"]
        if not seen["degraded_decodes"]:
            raise AssertionError(f"{tag}: the degraded get launched no "
                                 "K1 decode")
        return f"revive-osd {seen['victim']}"

    def revived(sh):
        c = sh.cluster
        _wait(c, lambda: c.mon.osdmap.is_up(seen["victim"]),
              f"osd.{seen['victim']} up again", tag=tag)
        # another OSD than the revived one (every OSD is in every acting
        # set at k + m = 12 of 12)
        seen["crashed"] = (seen["victim"] + 1) % VSTART_OSDS
        return f"crash-osd {seen['crashed']}"

    items = ([f"put ecp {o} {paths[o]}" for o in objs] +
             [f"get ecp {o} {work / (o + '.out')}" for o in objs] +
             [read_back, "trace on", f"put ecp traced {paths['obj0']}",
              "trace ls", trace_id, "trace off",
              lambda sh: f"pg map {pgid_of(sh, 'obj0')}",
              lambda sh: f"pg scrub {pgid_of(sh, 'obj0')}",
              "balance", "balancer status",
              f"serve put ecp art {work / 'art.in'}", "serve stat ecp art",
              "serve pages ecp art shard0 0,1,2,3",
              victim, lambda sh: f"osd down {seen['victim']}",
              f"get ecp obj0 {work / 'obj0.degraded'}", degraded, revived,
              "crash ls", "health", "status", "crash archive-all", "health",
              "telemetry show", "insights", "perf dump", "status", "quit"])
    argv = [*args, "--osds", str(VSTART_OSDS),
            "-c", f"osd erasure-code-profile set tpu_k8m4 plugin=tpu "
                  f"k={K} m={M} technique=reed_sol_van "
                  f"crush-failure-domain=host",
            "-c", f"osd pool create ecp {VSTART_PG_NUM} erasure tpu_k8m4"]
    saved_shell, saved_stdin = vstart.VstartShell, sys.stdin
    captured = io.StringIO()
    bm.reset_launches()
    cb.reset_launches()
    t0 = time.monotonic()
    try:
        vstart.VstartShell = _recording_shell(vstart, shells, log)
        sys.stdin = TourScript(items, shells)
        with k1_by_caller(bm) as split, \
                contextlib.redirect_stdout(captured):
            rc = vstart.main(argv)
    finally:
        vstart.VstartShell, sys.stdin = saved_shell, saved_stdin
    wall = time.monotonic() - t0
    launches = {**bm.LAUNCHES, **cb.LAUNCHES}
    (work / "vstart.txt").write_text(captured.getvalue())
    sh = shells[0]
    cmds = [e["cmd"] for e in log]
    bad = [e for e in log if not e["ok"]]
    if rc != 0 or bad or cmds[-1] != "quit":
        raise AssertionError(f"{tag}: main -> {rc}; failed commands "
                             f"{[(e['cmd'], e['text'][:200]) for e in bad]}; "
                             f"last {cmds[-1:]}")
    checks = {
        "profile": log[0]["text"].strip() in ("", "profile 'tpu_k8m4' set"),
        "pool": "pool 'ecp' created" in log[1]["text"],
        "span": "ec_encode_kernel" in next(
            e["text"] for e in log if e["cmd"].startswith("trace ") and
            e["cmd"].split()[1] not in ("on", "off", "ls")),
        "scrub": '"inconsistent": []' in last("pg scrub"),
        "serve": "published art epoch 1" in last("serve put") and
        last("serve pages").count("page ") == 4,
        "down": f"marked down osd.{seen['victim']}" in last("osd down"),
        "crash": f'"entity_name": "osd.{seen["crashed"]}"' in
        last("crash ls"),
        # the health checks' summaries show in `status`'s health line
        "recent_crash": "HEALTH_WARN" in
        [e for e in log if e["cmd"] == "health"][0]["text"] and
        "daemon crashes recently" in
        [e for e in log if e["cmd"] == "status"][0]["text"],
        "health_ok": "HEALTH_OK" in
        [e for e in log if e["cmd"] == "health"][1]["text"],
        "telemetry": '"cluster_id"' in last("telemetry show"),
        "insights": '"window_seconds"' in last("insights"),
        "perf": '"op"' in last("perf dump"),
        "status": f"{VSTART_OSDS} osds:" in last("status"),
    }
    if not all(checks.values()):
        raise AssertionError(f"{tag}: checks {checks}")
    k1 = {k: split[k] for k in ("encode", "decode", "repair", "other")}
    if not (k1["encode"] and seen["degraded_decodes"]):
        raise AssertionError(f"{tag}: K1 launches {k1}")
    if launches["gf_matmul"] != sum(k1.values()):
        raise AssertionError(f"{tag}: K1 count {launches['gf_matmul']} != "
                             f"the split {k1}")
    balance_k3 = next(e["k3"] for e in log if e["cmd"] == "balance")
    if balance_k3 < 1:
        raise AssertionError(f"{tag}: balance launched no crush_do_rule")
    c = sh.cluster
    reaped = [(o, exc) for o, exc, _tb in c.reaped]
    faults = {"dispatch_errors": c.network.dispatch_errors,
              "reaped_other": len([r for r in reaped
                                   if r[0] != seen["crashed"]]),
              "queued_op_failures": _perf_sum(c, "queued_op_failures"),
              "recovery_push_errors": _perf_sum(c, "recovery_push_errors"),
              "recovery_full_rebuild": _perf_sum(c, "recovery_full_rebuild"),
              "tick_errors": _perf_sum(c, "tick_errors")}
    if any(faults.values()) or reaped != [(seen["crashed"], "RuntimeError")]:
        raise AssertionError(f"{tag}: fault counts {faults}, reaped "
                             f"{reaped}")
    print(f"{tag}: vstart main --osds {VSTART_OSDS} in this process: "
          f"{len(log)} commands, every one ok; tpu k={K} m={M} host "
          f"profile, pool ecp pg_num {VSTART_PG_NUM}; {VSTART_OBJECTS} x "
          f"{REPAIR_OBJECT} B put and got back == (sha256), "
          f"{seen['shards']} shards on their acting OSDs == the plain "
          f"version's encode; ec_encode_kernel in the assembled trace; "
          f"pg scrub inconsistent []; osd.{seen['victim']} killed and "
          f"down, the degraded get == (sha256) with "
          f"{seen['degraded_decodes']} K1 decodes; osd.{seen['crashed']} "
          f"crashed: RECENT_CRASH, archived, HEALTH_OK; faults {faults}; "
          f"output in {work / 'vstart.txt'}")
    print(f"{tag}: K1 launches {k1} (encode, decode, repair, other), K3 "
          f"{launches['crush_do_rule']} ({balance_k3} in `balance`, the "
          f"rest in the mgr's score for `balancer status` and `status`); "
          f"the leg {wall:.1f} s on the host clock on {name_power}")
    for e in log:
        print(f"{tag}: {'ok' if e['ok'] else 'FAILED'} {e['s']:8.3f} s "
              f"K1 {e['k1']} K3 {e['k3']} `{e['cmd'][:80]}`")
    return {"wall_s": wall, "k1": k1, "k3": launches["crush_do_rule"],
            "k3_balance": balance_k3, "commands": len(log),
            "shards": seen["shards"], "faults": faults}


# ---------------------------------------------------------------------------
# The durable cluster: phase 21

DURABLE_OBJECTS = 16             # seeded 4 MiB objects written while down
DURABLE_SEED = SEED + 21
DURABLE_CHECKED = 2              # OSD dirs checked besides the restarted one


def _osd_sums(ds: Daemons, names) -> dict:
    """Recovery bytes, full rebuilds and K1 launches summed over the
    OSDs' admin sockets."""
    out = {"read": 0, "rebuilt": 0, "full": 0, "k1": 0}
    for n in names:
        perf = ds.command(n, "perf dump")
        out["read"] += perf["recovery_bytes_read"]
        out["rebuilt"] += perf["recovery_bytes_rebuilt"]
        out["full"] += perf["recovery_full_rebuild"]
        out["k1"] += ds.command(n, "kernel launches")["gf_matmul"]
    return out


def _wait_for(pred, what: str, timeout: float = CLUSTER_TIMEOUT_S) -> None:
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"phase 21: {what}")
        time.sleep(0.05)


def _stores_report(data: Path, names) -> dict:
    """Each stopped daemon's durable files: WAL and snapshot bytes, the
    block file, and (for an OSD) BlueStore's statfs after a mount."""
    from ceph_tpu_torch.store import BlueStore
    out = {}
    for name in names:
        kv = data / name / ("kv" if name.startswith("osd.") else "")
        row = {"wal_B": (kv / "kv.wal").stat().st_size,
               "snap_B": (kv / "kv.snap").stat().st_size
               if (kv / "kv.snap").exists() else 0}
        if name.startswith("osd."):
            row["block_B"] = (data / name / "block").stat().st_size
            st = BlueStore(str(data / name))
            st.mount()
            row["statfs"] = st.statfs()
            st.umount()
        out[name] = row
    return out


def device_health_leg(ds: Daemons, r, rot: int, osds: list) -> dict:
    """Phase 21's media-error feed: `osd perf dump` through the mon
    shows the bitrotted OSD's checksum mismatches and no other's; then
    a MgrDaemon with devicehealth, in this process on the cluster's TCP
    network with its own cephx key, raises DEVICE_HEALTH for exactly
    that device and logs the warn line; its prometheus exporter, scraped
    over HTTP, carries that device's `ceph_device_health` and
    `ceph_device_media_errors` equal to devicehealth's record."""
    from ceph_tpu_torch.auth import attach_cephx
    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.msg.tcp import TcpNet

    tag = "phase 21"
    t0 = time.monotonic()
    feed: dict = {}

    def reported():
        rc, _, perf = r.mon_command({"prefix": "osd perf dump"})
        if rc != 0 or len(perf) != len(osds):
            return False
        feed.clear()
        feed.update({n: perf[n].get("bluestore_csum_errors")
                     for n in sorted(perf)})
        return feed[f"osd.{rot}"] >= 1
    _wait_for(reported, "the bitrotted OSD's csum errors in osd perf dump")
    feed_s = time.monotonic() - t0
    if any(v != 0 for n, v in feed.items() if n != f"osd.{rot}"):
        raise AssertionError(f"{tag}: bluestore_csum_errors {feed}")
    t0 = time.monotonic()
    mgr = MgrDaemon(TcpNet({k: tuple(v) for k, v in ds.addrs.items()}),
                    threaded=True)
    attach_cephx(mgr.ms, mgr.name, ds.keyring.subset(mgr.name))
    try:
        mgr.init()
        dh = mgr.start_devicehealth()
        ticks = 0
        while ticks < 3:
            ticks += 1
            mgr.devicehealth_tick()
            if any(d["health"] != "GOOD" for d in dh.ls()):
                break
        unhealthy = [d["device"] for d in dh.ls() if d["health"] != "GOOD"]
        check = r.mon_command({"prefix": "health"})[2]["checks"].get(
            "DEVICE_HEALTH")
        line = f"device osd.{rot}-dev on osd.{rot} reports " \
            f"{feed[f'osd.{rot}']}"
        logged = [e["text"] for e in r.mon_command(
            {"prefix": "log last", "num": 50, "level": "warn"})[2]
            if e["name"] == "mgr.devicehealth"]
        mgr_s = time.monotonic() - t0
        t0 = time.monotonic()
        text = _http_get(mgr.start_prometheus(port=0).port, "/metrics")
        scrape_s = time.monotonic() - t0
        rec = dh.get_health(f"osd.{rot}-dev")
    finally:
        mgr.shutdown()
    lbl = f'{{daemon="osd.{rot}",device="osd.{rot}-dev"}}'
    gauges = {k: v for k, v in _samples(text).items()
              if k.startswith("ceph_device_")}
    want = {f"ceph_device_health{lbl}":
            float({"GOOD": 0, "WARNING": 1, "FAILING": 2}[rec["health"]]),
            f"ceph_device_media_errors{lbl}":
            float(rec["csum_errors"] + rec["read_errors"])}
    if any(gauges.get(k) != v for k, v in want.items()) or \
            sum(1 for k in gauges if k.startswith("ceph_device_health{")) \
            != len(osds):
        raise AssertionError(f"{tag}: the scrape's device gauges "
                             f"{gauges}, devicehealth's record {rec}")
    if unhealthy != [f"osd.{rot}-dev"] or check is None or \
            check.get("summary") != "1 devices reporting media errors" or \
            len(logged) != 1 or not logged[0].startswith(line):
        raise AssertionError(f"{tag}: devicehealth {unhealthy}, health "
                             f"{check}, log {logged}")
    return {"csum": {n: v for n, v in feed.items() if v} or feed,
            "feed_s": feed_s, "unhealthy": unhealthy,
            "check": check["summary"], "ticks": ticks, "mgr_s": mgr_s,
            "line": logged[0], "scrape_s": scrape_s,
            "gauges": {k.split("{")[0]: v for k, v in want.items()}}


def config_leg(ds: Daemons, r, osds: list) -> dict:
    """`config set osd osd_max_backfills 2` through the mon reaches
    every OSD process over TCP (each admin socket's `config get`), and
    `config rm` takes it back to the default."""
    from ceph_tpu_torch.common.options import OPTIONS

    name = "osd_max_backfills"
    default = OPTIONS[name].default

    def everywhere(value):
        return lambda: all(ds.command(n, {"prefix": "config get",
                                          "var": name}) == value
                           for n in osds)
    t0 = time.monotonic()
    rc, outs, _ = r.mon_command({"prefix": "config set", "who": "osd",
                                 "name": name, "value": "2"})
    if rc != 0:
        raise AssertionError(f"phase 21: config set: {outs}")
    _wait_for(everywhere(2), "osd_max_backfills 2 in every OSD process",
              timeout=60.0)
    set_s = time.monotonic() - t0
    t0 = time.monotonic()
    rc, outs, _ = r.mon_command({"prefix": "config rm", "who": "osd",
                                 "name": name})
    if rc != 0:
        raise AssertionError(f"phase 21: config rm: {outs}")
    _wait_for(everywhere(default), "osd_max_backfills back to its default",
              timeout=60.0)
    return {"osds": len(osds), "applied": 2, "set_s": set_s,
            "reverted": default, "rm_s": time.monotonic() - t0}


def errcheck_report(errdir: Path) -> dict:
    """The restarted OSD's errcheck dump: fired over total handlers of
    the port, the fired handlers by module, and the handler that takes
    a shard read's StoreError (BlueStore's checksum mismatch) in
    ECPGShard.handle_sub_read."""
    import inspect

    import ceph_tpu_torch
    from ceph_tpu_torch.common import errcheck
    from ceph_tpu_torch.osd.ec_backend import ECPGShard

    dumps = sorted(errdir.glob("errcheck-*.json"))
    if len(dumps) != 1:
        raise AssertionError(f"phase 21: errcheck dumps {dumps}")
    fired = errcheck.merge_dir(str(errdir))
    pkg = Path(ceph_tpu_torch.__file__).parent
    rep = errcheck.coverage_report(str(pkg), "ceph_tpu_torch", fired)
    src, first = inspect.getsourcelines(ECPGShard.handle_sub_read)
    sub_read = [ln for mod, ln, catches in errcheck.handler_census(
        str(pkg), "ceph_tpu_torch")
        if mod == "ceph_tpu_torch.osd.ec_backend"
        and first <= ln < first + len(src) and catches == "StoreError"]
    key = ("ceph_tpu_torch.osd.ec_backend", sub_read[0], "StoreError")
    if not fired.get(key):
        raise AssertionError(f"phase 21: errcheck: the sub-read StoreError "
                             f"handler {key} never fired: {sorted(fired)}")
    by_module = sorted(((m.removeprefix("ceph_tpu_torch."), st["fired"])
                        for m, st in rep["modules"].items() if st["fired"]),
                       key=lambda x: (-x[1], x[0]))
    return {"fired": rep["handlers_fired"], "total": rep["handlers_total"],
            "csum_handler": f"ec_backend.py:{key[1]}",
            "csum_fired": fired[key], "by_module": by_module}


def snap_tool_leg(path: Path, snapped: dict, snap: int) -> dict:
    """`objectstore_tool --op list-snaps` and `--op dump-snap-index` on a
    stopped OSD's dir, for each of its reppool PGs: exactly the one clone
    of pool snap `snap` and its index entry.  The tool's CLI runs in this
    process (a process per call would cost seconds of imports each)."""
    from ceph_tpu_torch.tools import objectstore_tool

    def tool(op: str, pg) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = objectstore_tool.main(["--data-path", str(path), "--op", op,
                                        "--pgid", f"{pg.pool}.{pg.ps:x}"])
        if rc != 0:
            raise AssertionError(f"phase 21: objectstore_tool --op {op} "
                                 f"--pgid {pg} gave rc {rc}")
        return buf.getvalue()
    t0 = time.monotonic()
    for pg, name in snapped.items():
        snaps = [json.loads(line) for line in
                 tool("list-snaps", pg).splitlines()]
        want = [{"oid": name, "snap_seq": snap, "whiteout": False,
                 "clones": {str(snap): {"covers": [snap], "present": True}}}]
        index = json.loads(tool("dump-snap-index", pg))
        want_index = {"pgid": str(pg), "purged_snaps": [], "index": [
            {"snap": snap, "clone": snap, "oid": name, "covers": [snap]}]}
        if snaps != want or index != want_index:
            raise AssertionError(f"phase 21: pg {pg} on {path.name}: "
                                 f"list-snaps {snaps}, dump-snap-index "
                                 f"{index}")
    if not snapped:
        raise AssertionError(f"phase 21: {path.name} holds no reppool PG")
    return {"pgs": len(snapped), "wall_s": time.monotonic() - t0}


def durable_phase(name_power: str, work: Path) -> dict:
    """Phase 21: a mon (on a LogDB) and 16 OSD processes (on BlueStore),
    each with --data-dir on this machine's disk, through SIGKILLs and
    restarts; see the module docstring."""
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.msg.tcp import TcpNet
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.ec_backend import pg_cid
    from ceph_tpu_torch.osd.types import PG
    from ceph_tpu_torch.store import BlueStore, ObjectId

    work.mkdir(parents=True, exist_ok=True)
    data = work / "data"
    t_phase = time.monotonic()
    df = subprocess.run(["df", "-T", str(work)], capture_output=True,
                        text=True).stdout.strip().splitlines()
    for line in df:
        print(f"phase 21: df -T: {line}")
    ds = Daemons(work, CLUSTER_OSDS, tag="phase 21", data=data)
    osds = [f"osd.{i}" for i in range(CLUSTER_OSDS)]
    names = ["mon.0"] + osds
    r = None
    res: dict = {"df": df}
    try:
        for name in names:
            ds.spawn(name)
        ds.wait_serving(names)
        res["boot_s"] = time.monotonic() - t_phase
        startup = {name: ds.startup(name) for name in names}
        net = TcpNet({k: tuple(v) for k, v in ds.addrs.items()})
        r = Rados(net, name="client.smoke", op_timeout=CLUSTER_TIMEOUT_S,
                  auth_secret=ds.keyring.get("client.smoke")).connect(60.0)
        _wait_for(lambda: sum(r.objecter.osdmap.is_up(o)
                          for o in range(CLUSTER_OSDS)) == CLUSTER_OSDS,
              "OSDs never all up")
        rc, outs, _ = r.mon_command(PROFILE_CMD)
        if rc != 0:
            raise AssertionError(f"phase 21: profile set: {outs}")
        r.pool_create("ecpool", pg_num=CLUSTER_PG_NUM, pool_type="erasure",
                      erasure_code_profile="tpu_k8m4")
        pid = r.pool_lookup("ecpool")
        io = r.open_ioctx("ecpool")
        r.pool_create("reppool", pg_num=REP_PG_NUM)
        rpid = r.pool_lookup("reppool")
        rio = r.open_ioctx("reppool")

        def clean(names_):
            return lambda: _proc_clean(ds, names_, r.objecter.osdmap)

        _wait_for(clean(osds), "the new pools' PGs never peered")
        # one small object in every reppool PG: every replica's log then
        # holds history, so a restarted OSD catches up from its log
        m = r.objecter.osdmap
        pre, i = {}, 0
        while len(pre) < REP_PG_NUM:
            name = f"pre_{i}"
            pre.setdefault(m.pools[rpid].raw_pg_to_pg(
                m.object_locator_to_pg(name, rpid)).ps, name)
            i += 1
        for name in pre.values():
            rio.write_full(name, name.encode())
        # -- 1. rados bench write -------------------------------------------
        k1 = {}
        l0 = _osd_sums(ds, osds)["k1"]
        res["write"] = _bench(ds, "write")
        k1["bench_write"] = _osd_sums(ds, osds)["k1"] - l0
        faults = _proc_faults(ds, names)      # before any daemon dies
        # -- 2. SIGKILL the OSD in the most acting sets, down, write ----------
        _, count = acting_sets(r.objecter.osdmap, pid, CLUSTER_PG_NUM, PG)
        victim = max(sorted(o for o in count if o < CLUSTER_OSDS),
                     key=lambda o: count[o])
        vname = f"osd.{victim}"
        live = [n for n in osds if n != vname]
        ds.kill(vname)
        rc, outs, _ = r.mon_command({"prefix": "osd down", "ids": [victim]})
        if rc != 0:
            raise AssertionError(f"phase 21: osd down: {outs}")
        _wait_for(lambda: r.objecter.osdmap.is_down(victim), "victim never down")
        _wait_for(clean(live), "peering after osd down")
        rng = np.random.default_rng(DURABLE_SEED)
        seeded = {f"durable_{i}": rng.bytes(REPAIR_OBJECT)
                  for i in range(DURABLE_OBJECTS)}
        t0 = time.monotonic()
        for oid, payload in seeded.items():
            io.write_full(oid, payload)
        res["down_write"] = {"wall_s": time.monotonic() - t0,
                             "MBps": len(seeded) * REPAIR_OBJECT /
                             (time.monotonic() - t0) / 1e6}
        t0 = time.monotonic()
        for oid, payload in seeded.items():
            rio.write_full(oid, payload)
        res["rep_down_write"] = {"wall_s": time.monotonic() - t0,
                                 "MBps": len(seeded) * REPAIR_OBJECT /
                                 (time.monotonic() - t0) / 1e6}
        # -- 3. restart it on its data dir; log-based recovery to clean ------
        before = _osd_sums(ds, live)
        t0 = time.monotonic()
        ds.spawn(vname)
        ds.wait_serving([vname])
        _wait_for(lambda: r.objecter.osdmap.is_up(victim), "victim never up")
        _wait_for(clean(osds), "recovery after the restart")
        res["osd_restart_to_clean_s"] = time.monotonic() - t0
        after = _osd_sums(ds, osds)
        rec = {k: after[k] - before[k] for k in after}
        m = r.objecter.osdmap
        chunk = REPAIR_OBJECT // K
        missed = sum(chunk for oid in seeded
                     if victim in m.pg_to_up_acting_osds(
                         m.pools[pid].raw_pg_to_pg(
                             m.object_locator_to_pg(oid, pid)))[2])
        if not rec["rebuilt"] or rec["read"] != K * rec["rebuilt"] or \
                rec["full"] or rec["rebuilt"] != missed or not rec["k1"]:
            raise AssertionError(f"phase 21: recovery {rec}, the writes "
                                 f"{vname} missed {missed} B")
        k1["recovery"] = rec["k1"]
        res["recovery"] = rec
        # reppool: the restarted OSD catches up from its durable log
        # (GetMissing, pulls and pushes), exactly the replicas it missed
        # it pulls what it missed where it is primary (GetLog, then
        # PGPull) and is pushed the rest (PGMissingReply, then pushes)
        rep_missed, as_primary = [], 0
        for oid in seeded:
            _, _, acting_, prim_ = m.pg_to_up_acting_osds(
                m.pools[rpid].raw_pg_to_pg(m.object_locator_to_pg(oid,
                                                                  rpid)))
            if victim in acting_:
                rep_missed.append(oid)
                as_primary += prim_ == victim
        # a primary goes clean once its pushes are sent: wait for them
        _wait_for(lambda: ds.command(vname, "perf dump")["push_in"] >=
                  len(rep_missed), "the pushes to the restarted OSD")
        vperf = ds.command(vname, "perf dump")
        rep_rec = {k: vperf[k] for k in (
            "push_in", "push_in_bytes", "backfill_push_in",
            "recovery_push_errors")}
        rep_rec["pushed"] = sum(
            ds.command(n, "perf dump")["recovery_push"] for n in live)
        rep_rec["pulled"] = rep_rec["push_in"] - rep_rec["pushed"]
        if not rep_missed or rep_rec["push_in"] != len(rep_missed) or \
                rep_rec["push_in_bytes"] != len(rep_missed) * \
                REPAIR_OBJECT or rep_rec["backfill_push_in"] or \
                rep_rec["recovery_push_errors"] or \
                rep_rec["pulled"] != as_primary:
            raise AssertionError(f"phase 21: reppool catch-up {rep_rec}, the "
                                 f"writes {vname} missed {len(rep_missed)} x "
                                 f"{REPAIR_OBJECT} B, {as_primary} where it "
                                 "is primary")
        res["rep_recovery"] = rep_rec
        res["rep_missed"] = rep_missed
        startup[f"{vname} (restarted)"] = ds.startup(vname)
        # -- 4. SIGKILL the mon; restart it on its LogDB ----------------------
        epoch = r.objecter.osdmap.epoch
        mon_faults = _proc_faults(ds, ["mon.0"])["mon.0"]
        ds.kill("mon.0")
        t0 = time.monotonic()
        ds.spawn("mon.0")
        ds.wait_serving(["mon.0"])
        mon_epoch = ds.command("mon.0", "status")["osdmap"]["epoch"]
        if mon_epoch != epoch:
            raise AssertionError(f"phase 21: the mon came back at epoch "
                                 f"{mon_epoch}, not {epoch}")
        r2 = Rados(TcpNet({k: tuple(v) for k, v in ds.addrs.items()}),
                   name="client.admin", op_timeout=CLUSTER_TIMEOUT_S,
                   auth_secret=ds.keyring.get("client.admin")).connect(60.0)
        try:
            m2 = r2.objecter.osdmap
            if m2.epoch != epoch or r2.pool_lookup("ecpool") != pid or \
                    r2.pool_lookup("reppool") != rpid or \
                    dict(m2.erasure_code_profiles.get("tpu_k8m4", {})) != \
                    dict(r.objecter.osdmap.erasure_code_profiles[
                        "tpu_k8m4"]):
                raise AssertionError("phase 21: the pool or the profile did "
                                     "not survive the mon's restart")
        finally:
            r2.shutdown()
        io.write_full("after_mon_restart", b"m" * 4096)
        if io.read("after_mon_restart") != b"m" * 4096:
            raise AssertionError("phase 21: IO after the mon's restart")
        res["mon_restart_to_serving_s"] = time.monotonic() - t0
        startup["mon.0 (restarted)"] = ds.startup("mon.0")
        # -- 5. rados bench seq; the seeded objects byte for byte -------------
        res["seq"] = _bench(ds, "seq")
        for oid, payload in seeded.items():
            if io.read(oid) != payload or rio.read(oid) != payload:
                raise AssertionError(f"phase 21: {oid} read back differs")
        # -- 6. bitrot under one OSD; a degraded decode on K1; fsck ----------
        m = r.objecter.osdmap
        for rot_oid in seeded:
            pg = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(rot_oid,
                                                                  pid))
            _, _, acting, primary = m.pg_to_up_acting_osds(pg)
            shard = next((s for s in range(K)
                          if acting[s] not in (primary, victim)), None)
            if shard is not None:
                break
        else:
            raise AssertionError("phase 21: no seeded object has a data "
                                 "shard off its primary and the victim")
        rot, rname = acting[shard], f"osd.{acting[shard]}"
        # a pool snap on reppool, then the object of each of the OSD's
        # reppool PGs overwritten: one clone per PG on its dir
        t0 = time.monotonic()
        rio.snap_create("s21")
        s21 = rio.snap_lookup("s21")
        snapped = {PG(rpid, ps): name for ps, name in sorted(pre.items())
                   if rot in m.pg_to_up_acting_osds(PG(rpid, ps))[2]}
        for name in snapped.values():
            rio.write_full(name, name.encode() + b" after s21")
        res["snap21_s"] = time.monotonic() - t0
        ds.terminate(rname)
        rc, outs, _ = r.mon_command({"prefix": "osd down", "ids": [rot]})
        if rc != 0:
            raise AssertionError(f"phase 21: osd down: {outs}")
        down_epoch = r.objecter.osdmap.epoch
        _wait_for(lambda: r.objecter.osdmap.is_down(rot), "rot OSD never down")
        # every OSD hears the new map from the restarted mon
        _wait_for(lambda: all(ds.command(n, "status")["osdmap_epoch"] >=
                          down_epoch for n in osds if n != rname),
              "an OSD never heard from the restarted mon")
        store = BlueStore(str(data / rname))
        store.mount()
        rotten = ObjectId(rot_oid, -2, shard)
        store.corrupt_blob_bytes(pg_cid(pg), rotten)
        store.umount()
        fsck = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.objectstore_tool",
             "--data-path", str(data / rname), "--op", "fsck"],
            env=ds.env, cwd=ds.env["PYTHONPATH"], capture_output=True,
            text=True, timeout=300)
        lines = fsck.stdout.splitlines()
        if fsck.returncode != 1 or len(lines) != 2 or \
                lines[1] != "fsck: 1 error(s)" or not lines[0].startswith(
                    f"{pg_cid(pg)}/{rotten}: csum mismatch in blob "):
            raise AssertionError(f"phase 21: fsck of {rname}: rc "
                                 f"{fsck.returncode}\n{fsck.stdout}"
                                 f"{fsck.stderr[-2000:]}")
        res["fsck"] = lines[0]
        res["snap_tool"] = snap_tool_leg(data / rname, snapped, s21)
        # errcheck armed in this restarted OSD's process alone: its
        # fired handlers are dumped to errdir when it stops
        errdir = work / "errcheck"
        shutil.rmtree(errdir, ignore_errors=True)
        errdir.mkdir(parents=True)
        t0 = time.monotonic()
        ds.spawn(rname, env={"CEPH_TPU_ERRCHECK": "1",
                             "CEPH_TPU_ERRCHECK_DIR": str(errdir)})
        ds.wait_serving([rname])
        res["errcheck_serving_s"] = time.monotonic() - t0
        _wait_for(lambda: r.objecter.osdmap.is_up(rot), "rot OSD never up")
        _wait_for(clean(osds), "peering after the rot OSD's restart")
        l0 = _osd_sums(ds, osds)["k1"]
        t0 = time.monotonic()
        if io.read(rot_oid) != seeded[rot_oid]:
            raise AssertionError(f"phase 21: {rot_oid} read over bitrot "
                                 "differs")
        res["degraded"] = {"wall_s": time.monotonic() - t0,
                           "MBps": REPAIR_OBJECT /
                           (time.monotonic() - t0) / 1e6}
        k1["degraded_decode"] = _osd_sums(ds, osds)["k1"] - l0
        if not k1["degraded_decode"]:
            raise AssertionError("phase 21: the read over bitrot launched "
                                 "no K1 decode")
        # -- 7. deep scrub, repair and re-scrub over TCP ----------------------
        pname = f"osd.{primary}"
        clean_res = {"inconsistent": [], "repaired": 0, "unrepairable": []}
        expect = [{"inconsistent": [rot_oid], "repaired": 0,
                   "unrepairable": []},
                  {"inconsistent": [rot_oid], "repaired": 1,
                   "unrepairable": [], "verified": True}, clean_res]
        res["scrubs"] = []
        p0 = ds.command(pname, "kernel launches")["gf_matmul"]
        for repair, want_res in zip((False, True, False), expect):
            t0 = time.monotonic()
            got = r.pg_scrub(pid, pg.ps, repair=repair)
            res["scrubs"].append({"repair": repair, "result": got,
                                  "wall_s": time.monotonic() - t0})
            if got != want_res:
                raise AssertionError(f"phase 21: pg_scrub(repair={repair}) "
                                     f"of pg {pg} gave {got}, not {want_res}")
        k1["scrub_repair_primary"] = \
            ds.command(pname, "kernel launches")["gf_matmul"] - p0
        if not k1["scrub_repair_primary"]:
            raise AssertionError(f"phase 21: the scrub repair launched no K1 "
                                 f"on the primary {pname}")
        # -- 7b. the media-error feed, devicehealth, config over TCP ----------
        res["device_health"] = device_health_leg(ds, r, rot, osds)
        res["config"] = config_leg(ds, r, osds)
        # each daemon's counters: a killed process's (read just before
        # its kill) summed with its successor's
        faults["mon.0"] = mon_faults
        for name, row in _proc_faults(ds, names).items():
            if name in ("mon.0", vname):
                row = {k: v + faults[name][k] for k, v in row.items()}
            faults[name] = row
        # -- 8. stop all; shards on disk == the plain encode; the mon's store -
        final = r.objecter.osdmap
        epoch = final.epoch
    finally:
        if r is not None:
            r.shutdown()
        ds.stop()
    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M)}, device="cpu")
    sinfo = ecutil.StripeInfo(K, K * STRIPE_UNIT)
    holders: dict[int, list] = {}
    for oid in seeded:
        pg_ = final.pools[pid].raw_pg_to_pg(final.object_locator_to_pg(oid,
                                                                      pid))
        for s, o in enumerate(final.pg_to_up_acting_osds(pg_)[2]):
            holders.setdefault(o, []).append((oid, pg_, s))
    others = sorted((o for o in holders if o not in (victim, rot)),
                    key=lambda o: -len(holders[o]))[:DURABLE_CHECKED]
    checked = 0
    want = {oid: ecutil.encode(sinfo, ec_cpu, payload)
            for oid, payload in seeded.items()}
    # the repaired shard, by sha256, on the bitrotted OSD's disk (read
    # through BlueStore's own checksum check), then every seeded shard
    # on it, the restarted OSD's and two others'
    store = BlueStore(str(data / rname))
    store.mount()
    healed = hashlib.sha256(store.read(pg_cid(pg), rotten)).hexdigest()
    store.umount()
    if healed != hashlib.sha256(want[rot_oid][shard]).hexdigest():
        raise AssertionError(f"phase 21: the repaired {rot_oid} shard {shard} "
                             f"on {rname}'s disk differs from the plain encode")
    for o in [victim, rot] + others:
        store = BlueStore(str(data / f"osd.{o}"))
        store.mount()
        for oid, pg_, s in holders[o]:
            got = store.read(pg_cid(pg_), ObjectId(oid, -2, s))
            if got != want[oid][s]:
                raise AssertionError(f"phase 21: {oid} shard {s} on osd.{o}'s "
                                     "disk differs from the plain encode")
            checked += 1
        if o == victim:
            # the replicas it pulled, on its disk
            for oid in res["rep_missed"]:
                pg_ = final.pools[rpid].raw_pg_to_pg(
                    final.object_locator_to_pg(oid, rpid))
                if store.read(pg_cid(pg_), ObjectId(oid)) != seeded[oid]:
                    raise AssertionError(f"phase 21: reppool {oid} on "
                                         f"{vname}'s disk differs")
                checked += 1
        store.umount()
    vers = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.monstore_tool",
         str(data / "mon.0"), "show-versions"], env=ds.env,
        cwd=ds.env["PYTHONPATH"], capture_output=True, text=True,
        timeout=300)
    shown = json.loads(vers.stdout)
    paxos = shown["paxos"]
    # one paxos commit per map epoch, the crash table's bootstrap
    # (phase 21 posts no crash) and one per commit of the config, the
    # cluster log and the fsmap (its bootstrap: phase 21 runs no MDS),
    # each of which keeps one key per version, last_ and first_committed
    commits = {svc: shown.get(svc, {}).get("keys", 2) - 2
               for svc in ("config", "logm", "fsmap")}
    if vers.returncode or paxos["last_version"] != \
            epoch + 1 + sum(commits.values()):
        raise AssertionError(f"phase 21: monstore_tool show-versions "
                             f"{vers.stdout} against epoch {epoch}")
    errcheck = errcheck_report(errdir)
    stores = _stores_report(data, names)
    wall = time.monotonic() - t_phase
    for mode in ("write", "seq"):
        b = res[mode]
        print(f"phase 21: rados bench {mode} -t {PROC_THREADS} -b "
              f"{b['size']}: {b['MBps']} MB/s, {b['ops']} ops, average "
              f"latency {b['lat_s']} s in {b['run_s']} s (CLI process "
              f"{b['cli_wall_s']:.1f} s) on {name_power}")
    print(f"phase 21: {vname} (in {count[victim]} acting sets) SIGKILLed and "
          f"down; {DURABLE_OBJECTS} seeded {REPAIR_OBJECT} B writes at "
          f"{res['down_write']['MBps']:.1f} MB/s; restarted on its "
          f"BlueStore: clean in {res['osd_restart_to_clean_s']:.3f} s, "
          f"rebuilt {rec['rebuilt']} B (the shards it missed), read/rebuilt "
          f"{rec['read'] / rec['rebuilt']}, full rebuilds {rec['full']}, K1 "
          f"{rec['k1']} launches in the OSDs' recovery")
    rr = res["rep_recovery"]
    print(f"phase 21: reppool (replicated, size {REP_SIZE}, pg_num "
          f"{REP_PG_NUM}) on BlueStore: {DURABLE_OBJECTS} seeded writes with "
          f"{vname} down at {res['rep_down_write']['MBps']:.1f} MB/s; after "
          f"the restart it caught up from its durable log: "
          f"{rr['push_in']} pushes applied ({rr['pulled']} answering its "
          f"PGPulls where it is primary, {rr['pushed']} pushed by the "
          f"primaries after its PGMissingReply) carrying "
          f"{rr['push_in_bytes']} B == the "
          f"{len(res['rep_missed'])} replicas it missed, "
          f"{rr['backfill_push_in']} backfill pushes on {name_power}")
    print(f"phase 21: mon.0 SIGKILLed and restarted on its LogDB at epoch "
          f"{mon_epoch}: serving (pool, "
          f"profile, a write and a read) in "
          f"{res['mon_restart_to_serving_s']:.3f} s")
    print(f"phase 21: {rname} stopped, {rot_oid} shard {shard} bitrotted, "
          f"fsck: {res['fsck']}; restarted: read == payload through a K1 "
          f"decode ({k1['degraded_decode']} launches) at "
          f"{res['degraded']['MBps']:.1f} MB/s")
    st = res["snap_tool"]
    print(f"phase 21: pool snap s21 on reppool and the object of each of "
          f"{rname}'s {st['pgs']} reppool PGs overwritten in "
          f"{res['snap21_s']:.3f} s before its clean stop; on its dir "
          f"objectstore_tool --op list-snaps and --op dump-snap-index list "
          f"exactly those clones and index entries ({st['wall_s']:.3f} s)")
    print(f"phase 21: over TCP, pg {pg} (primary osd.{primary}): " +
          "; ".join(f"pg_scrub(repair={sc['repair']}) {sc['result']} in "
                    f"{sc['wall_s']:.3f} s" for sc in res["scrubs"]) +
          f"; K1 {k1['scrub_repair_primary']} launches on the primary; the "
          f"repaired shard on {rname}'s disk == the plain encode (sha256 "
          f"{healed[:16]}) on {name_power}")
    print(f"phase 21: {checked} shards of the seeded objects on the disks of "
          f"osd.{victim}, osd.{rot}, " + ", ".join(f"osd.{o}" for o in others) +
          f" == the plain version's encode (tolerance 0); monstore_tool "
          f"show-versions paxos {paxos} == the client's last epoch {epoch} "
          f"+ the crash table's first commit + the commits of config, "
          f"the cluster log and the fsmap {commits}")
    dh = res["device_health"]
    print(f"phase 21: osd perf dump through the mon: "
          f"bluestore_csum_errors {dh['csum']} (osd.{rot} alone, a real "
          f"checksum mismatch), in {dh['feed_s']:.3f} s; a MgrDaemon with "
          f"devicehealth in this process (TCP, cephx as mgr.0): "
          f"DEVICE_HEALTH {dh['check']} for {dh['unhealthy']} after "
          f"{dh['ticks']} tick(s) ({dh['mgr_s']:.3f} s), log last: "
          f"{dh['line']!r}; its /metrics scraped over HTTP in "
          f"{dh['scrape_s']:.3f} s: {dh['gauges']} for osd.{rot}-dev == "
          f"devicehealth's record")
    cf = res["config"]
    print(f"phase 21: config set osd osd_max_backfills 2 over TCP: all "
          f"{cf['osds']} OSD processes' `config get` show {cf['applied']} "
          f"in {cf['set_s']:.3f} s; config rm: back to {cf['reverted']} in "
          f"{cf['rm_s']:.3f} s")
    print(f"phase 21: errcheck in osd.{rot}'s restarted process "
          f"(serving in {res['errcheck_serving_s']:.2f} s): "
          f"{errcheck['fired']} of {errcheck['total']} handlers fired; the "
          f"BlueStore checksum-mismatch read path's "
          f"{errcheck['csum_handler']} fired {errcheck['csum_fired']} times; "
          f"by module " + ", ".join(f"{m} {n}" for m, n in
                                    errcheck["by_module"]))
    for name, split in startup.items():
        print(f"phase 21: {name} start-up " + ", ".join(
            f"{part} {v:.2f}" for part, v in split.items()) + " s")
    for name, row in stores.items():
        print(f"phase 21: {name} on disk: " + ", ".join(
            f"{k} {v}" for k, v in row.items()))
    sums = {k: sum(row[k] for row in faults.values())
            for k in next(iter(faults.values()))}
    print(f"phase 21: K1 launches in the OSD processes {k1}; fault counts "
          f"summed over {len(faults)} daemons {sums}; boot "
          f"{res['boot_s']:.1f} s, phase {wall:.1f} s on {name_power}")
    res.update({"victim": victim, "launches": k1, "startup": startup,
                "stores": stores, "faults": sums, "checked_shards": checked,
                "epoch": epoch, "phase_s": wall, "errcheck": errcheck,
                "paxos_commits": commits})
    return res


# ---------------------------------------------------------------------------
# Chaos on a three-mon quorum: phase 22

CHAOS_FAULT_SEED = 7             # MiniCluster(fault_seed=7), tests/test_chaos.py
CHAOS_RUNNER_SEED = 1            # ChaosRunner(seed=1), tests/test_chaos.py
CHAOS_OBJECTS = 16               # seeded 4 MiB objects before the schedule
CHAOS_SCHEDULE = [               # tests/test_chaos.py:84-92, then :120-137
    {"at": 20.0, "action": "partition", "a": ["mon.2"],
     "b": ["mon.0", "mon.1"], "label": "mon-minority"},
    {"at": 60.0, "action": "heal", "target": "mon-minority"},
    {"at": 80.0, "action": "kill_osd", "osd": 3},
    {"at": 120.0, "action": "revive_osd", "osd": 3},
    {"at": 140.0, "action": "drop", "src": "osd.*", "dst": "osd.*",
     "p": 0.02, "types": ["Ping"], "label": "ping-loss"},
    {"at": 200.0, "action": "heal", "target": "ping-loss"},
    {"at": 220.0, "action": "isolate_primary", "oid": "chaos_00001",
     "label": "primary-cut"},
    {"at": 280.0, "action": "heal", "target": "primary-cut"},
]


def _caller_pool():
    """The pool of the ECBackend whose call reached ECUtil: the first
    frame up the stack holding one (as `self` in ec_backend.py, as `b`
    in ec_peering.py); None when there is none."""
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            return None
        for name in ("self", "b"):
            pgid = getattr(f.f_locals.get(name), "pgid", None)
            if pgid is not None and hasattr(pgid, "pool"):
                return pgid.pool
        f = f.f_back
    return None


@contextlib.contextmanager
def k1_by_caller(bm):
    """Within the block, count K1's launches by the ECUtil entry point
    that made them: `encode` (client writes and the re-encode of a full
    rebuild), `decode` (degraded reads and full rebuilds) and `repair`
    (compiled repairs and their compile probes); `other` is the rest.
    `counts["pools"][pool id]` splits the same counts by the pool whose
    ECBackend made the call.  The label rides each thread's own stack,
    so the OSDs' threads may launch at once.  The count itself stays the
    wrapper's."""
    from ceph_tpu_torch.osd import ecutil

    kinds = ("encode", "decode", "repair", "other")
    counts: dict = {k: 0 for k in kinds}
    counts["pools"] = {}
    local = threading.local()
    lock = make_lock("smoke.k1_by_caller")
    launch = bm.gf_matmul_cuda
    saved = {name: getattr(ecutil, name) for name in
             ("encode", "decode_concat", "compiled_repair_streams")}
    labels = {"encode": "encode", "decode_concat": "decode",
              "compiled_repair_streams": "repair"}

    def counted(*args, **kwargs):
        where = getattr(local, "where", None)
        kind, pool = where[-1] if where else ("other", None)
        with lock:
            counts[kind] += 1
            per = counts["pools"].setdefault(pool, {k: 0 for k in kinds})
            per[kind] += 1
        return launch(*args, **kwargs)

    def labelled(name):
        fn = saved[name]

        def call(*args, **kwargs):
            stack = local.__dict__.setdefault("where", [])
            stack.append((labels[name], _caller_pool()))
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return call

    bm.gf_matmul_cuda = counted
    for name in saved:
        setattr(ecutil, name, labelled(name))
    try:
        yield counts
    finally:
        bm.gf_matmul_cuda = launch
        for name, fn in saved.items():
            setattr(ecutil, name, fn)


def chaos_phase(name_power: str) -> dict:
    """Phase 22 (see the module docstring)."""
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.testing import ChaosRunner, MiniCluster

    tag = "phase 22"
    t0 = time.monotonic()
    c = MiniCluster(n_osd=CLUSTER_OSDS, osds_per_host=1, n_mon=3,
                    threaded=False, fault_seed=CHAOS_FAULT_SEED)
    try:
        c.pump()
        c.wait_all_up()
        ldr = c.leader()
        if ldr is None or ldr.quorum() != [0, 1, 2]:
            raise AssertionError(f"{tag}: no three-mon quorum at start")
        # elections: the epochs in which some mon won
        wins: set = set()
        for mn in c.mons.values():
            def on_win(epoch, quorum, _win=mn.elector.on_win):
                wins.add(epoch)
                _win(epoch, quorum)
            mn.elector.on_win = on_win
        # after every tick of the run (sim clock): whether every mon
        # follows one leader in a quorum of all three
        agreed: list = []
        tick = c.tick

        def traced_tick(now=None):
            tick(now)
            views = {(mn.leader_rank, mn.elector.electing,
                      tuple(mn.elector.quorum)) for mn in c.mons.values()}
            agreed.append((now, len(c.mons) == 3 and len(views) == 1 and
                           next(iter(views))[1:] == (False, (0, 1, 2))))
        c.tick = traced_tick
        r = c.rados(timeout=CLUSTER_TIMEOUT_S)
        rc, outs, _ = r.mon_command(PROFILE_CMD)
        if rc != 0:
            raise AssertionError(f"{tag}: profile set: {outs}")
        r.pool_create("ecpool", pg_num=CLUSTER_PG_NUM, pool_type="erasure",
                      erasure_code_profile="tpu_k8m4")
        c.pump()
        io = r.open_ioctx("ecpool")
        rng = np.random.default_rng(SEED + 22)
        objs = {f"pre{i:02d}": rng.bytes(REPAIR_OBJECT)
                for i in range(CHAOS_OBJECTS)}
        with rebuild_paths() as paths, k1_by_caller(bm) as split:
            t_pre = time.monotonic()
            for oid, data in objs.items():
                io.write_full(oid, data)
            pre_s = time.monotonic() - t_pre
            pre_split = dict(split)
            runner = ChaosRunner(c, CHAOS_SCHEDULE, rados=r, pool="ecpool",
                                 seed=CHAOS_RUNNER_SEED)
            t_run = time.monotonic()
            report = runner.run()         # InvariantViolation fails the run
            run_s = time.monotonic() - t_run
            for oid, data in objs.items():
                if io.read(oid) != data:
                    raise AssertionError(f"{tag}: {oid} reads back wrong")
        launches = dict(bm.LAUNCHES)
        if report["acked"] != report["ops_total"] or not report["acked"]:
            raise AssertionError(f"{tag}: acked {report['acked']} of "
                                 f"{report['ops_total']} ops")
        counts = report["fault_counts"]
        if not counts.get("partition") or not counts.get("drop"):
            raise AssertionError(f"{tag}: fault counts {counts}")
        if launches["gf_matmul"] == 0:
            raise AssertionError(f"{tag}: the leg never launched gf_matmul")
        ldr = c.leader()
        rc, _, crashes = ldr.handle_command({"prefix": "crash ls"})
        rc_q, _, q = ldr.handle_command({"prefix": "quorum_status"})
        if rc or crashes:
            raise AssertionError(f"{tag}: crash table {crashes}")
        if rc_q or q["quorum"] != [0, 1, 2]:
            raise AssertionError(f"{tag}: final quorum {q}")
        # the mons' own cluster-log lines, committed through paxos:
        # each of the three mons answers `log last` with the same
        mon_logs = {rank: [(e["name"], e["level"], e["text"], e["stamp"])
                           for e in mn.handle_command(
                               {"prefix": "log last", "num": 500})[2]
                           if e["name"].startswith("mon.")]
                    for rank, mn in sorted(c.mons.items())}
        mon_lines = [(lvl, text) for _n, lvl, text, _t in
                     mon_logs[ldr.rank]]
        if len({tuple(v) for v in mon_logs.values()}) != 1 or \
                ("warn", "osd.3 marked down after failure reports from its "
                 "peers") not in mon_lines:
            raise AssertionError(f"{tag}: the mons' log lines {mon_logs}")
        _faults(c, tag)
        faults = {"dispatch_errors": c.network.dispatch_errors,
                  "reaped": len(c.reaped),
                  "tick_errors": _perf_sum(c, "tick_errors"),
                  "queued_op_failures": _perf_sum(c, "queued_op_failures"),
                  "recovery_push_errors": _perf_sum(c,
                                                    "recovery_push_errors"),
                  "repair_errors": paths["repair_errors"]}
        if any(faults.values()):
            raise AssertionError(f"{tag}: fault counts {faults}")
        heal_at = runner.start + 60.0         # the mon-minority heal
        full = [now for now, ok in agreed
                if now is not None and now > heal_at and ok]
        heal_to_quorum = full[0] - heal_at if full else None
        if heal_to_quorum is None:
            raise AssertionError(f"{tag}: no full quorum after the heal")
        wall = time.monotonic() - t0
    finally:
        c.shutdown()
    for ph in report["phases"]:
        print(f"{tag}: phase {ph['phase']}: {ph['ops']} ops, p50 "
              f"{ph['p50_ms']} ms, p99 {ph['p99_ms']} ms (host clock)")
    print(f"{tag}: fault digest {report['fault_digest']}, counts "
          f"{json.dumps(counts, sort_keys=True)}; acked {report['acked']} of "
          f"{report['ops_total']}")
    print(f"{tag}: elections won in {len(wins)} epochs (final election "
          f"epoch {q['election_epoch']}); every mon back in one quorum of "
          f"three {heal_to_quorum:.1f} sim s after the mon heal; quorum "
          f"{q['quorum']}, leader mon.{q['leader']}, crash table empty")
    print(f"{tag}: log last from each of the {len(mon_logs)} mons: the same "
          f"{len(mon_lines)} mon-originated lines: " +
          "; ".join(f"[{lvl}] {text}" for lvl, text in mon_lines))
    print(f"{tag}: K1 {launches['gf_matmul']} launches (preload encodes "
          f"{pre_split['encode']}; in the run encode "
          f"{split['encode'] - pre_split['encode']}, decode "
          f"{split['decode'] - pre_split['decode']}, repair "
          f"{split['repair'] - pre_split['repair']}, other "
          f"{split['other'] - pre_split['other']}); full rebuilds "
          f"{paths['full']}; fault counts {faults}")
    print(f"{tag}: preload {CHAOS_OBJECTS} x 4 MiB {pre_s:.1f} s, run "
          f"{run_s:.1f} s, leg {wall:.1f} s host clock on {name_power}")
    return {"report": {k: report[k] for k in (
                "acked", "ops_total", "fault_digest", "fault_counts",
                "phases", "events")},
            "launches": launches["gf_matmul"], "split": dict(split),
            "preload_split": pre_split, "full_rebuilds": paths["full"],
            "elections": len(wins), "election_epoch": q["election_epoch"],
            "mon_log_lines": mon_lines,
            "heal_to_quorum_sim_s": heal_to_quorum, "faults": faults,
            "preload_s": pre_s, "run_s": run_s, "phase_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec import gf, registry
    from ceph_tpu_torch.ec.kernels import _build
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.matrix_code import (make_decode_matrix,
                                               make_decode_matrix_full)
    from ceph_tpu_torch.osd import ecutil

    t_start = time.monotonic()
    name_power = card()
    print(name_power)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    t0 = time.monotonic()
    logs = _build.build("gf_matmul", "crush_rule")   # both nvcc at once
    print(f"phase 2: built gf_matmul and crush_rule in "
          f"{time.monotonic() - t0:.1f} s")
    log = logs["gf_matmul"]
    if "stack frame" not in log:
        raise AssertionError("no ptxas report for gf_matmul")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.replace("ptxas info    :", "").strip())
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame and int(frame.group(1)):
            raise AssertionError(f"a kernel has a stack frame: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err_k1 = check_k1(bm, gen, dev)
    ec = registry.factory("tpu", {"k": str(K), "m": str(M),
                                  "technique": "reed_sol_van"})
    err_k2 = check_k2(bm, ec, make_decode_matrix_full, gen, dev)

    bm.reset_launches()
    state = main_path(ec, ecutil, gf, gen, dev)
    launches = dict(bm.LAUNCHES)
    print(f"phase 5: main path k={K} m={M} chunk={CHUNK} stripes={STRIPES} "
          f"ok; launches {launches}")
    for kname, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {kname}")

    # -- the main path's outputs against the plain versions, full width --
    data, parity = state["data"], state["parity"]
    survivors, arrival = state["survivors"], state["arrival"]
    di = state["decode_index"]
    n = K + M
    enc_op = ec._encode_mm
    dec_op = bm.GFMatmul(make_decode_matrix(ec.encode_matrix, K, di,
                                            ERASURES), dev)
    valid = np.array([i not in ERASURES for i in range(n)])
    full_op = bm.GFDecodeFull(make_decode_matrix_full(
        ec.encode_matrix, K, n, di, ERASURES), valid, dev)
    err_k1 = max(err_k1,
                 max_err(parity, bm.gf_matmul_plain(enc_op.mat_t, data)),
                 max_err(state["staged"],
                         bm.gf_matmul_plain(dec_op.mat_t, survivors)))
    err_k2 = max(err_k2, max_err(state["rebuilt"], bm.gf_decode_select_plain(
        full_op.mat_t, full_op.runs, arrival)))
    print(f"phase 5: main-path outputs == plain versions at full width "
          f"(max_abs_err K1 {err_k1}, K2 {err_k2})")
    if err_k1 or err_k2:
        raise AssertionError("a kernel disagrees with its plain version")

    # -- phase 6: timing ------------------------------------------------
    obj_bytes = STRIPES * K * CHUNK
    t_enc = time_ms(lambda: ec.encode_batch(data))
    t_dec = time_ms(lambda: ec.decode_batch(di, ERASURES, survivors))
    t_full = time_ms(lambda: ec.decode_batch_full(ERASURES, arrival))
    for label, t in (("encode", t_enc), ("decode_staged", t_dec),
                     ("decode_full", t_full)):
        print(f"phase 6: {label} {obj_bytes / t / 1e3:.1f} MB/s "
              f"({t:.4f} ms per {STRIPES} x 1 MiB) on {name_power}")

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    k1_ms = time_ms(lambda: bm.gf_matmul_cuda(enc_op.tables, data, M))
    k1_plain = time_ms(lambda: bm.gf_matmul_plain(enc_op.mat_t, data),
                       reps=2, repeats=5)
    k1_dec_ms = time_ms(lambda: bm.gf_matmul_cuda(dec_op.tables, survivors,
                                                  len(ERASURES)))
    k2_ms = time_ms(lambda: bm.gf_decode_select_cuda(
        full_op.tables, full_op.sel_t, arrival))
    k2_plain = time_ms(lambda: bm.gf_decode_select_plain(
        full_op.mat_t, full_op.runs, arrival), reps=2, repeats=5)
    r_enc, r_dec = M, len(ERASURES)
    k1_bound, k1_by = bound(STRIPES * (K + r_enc) * CHUNK,
                            STRIPES * r_enc * K * CHUNK)
    k1_dec_bound, _ = bound(STRIPES * (K + r_dec) * CHUNK,
                            STRIPES * r_dec * K * CHUNK)
    k2_bound, k2_by = bound(STRIPES * (K + r_dec) * CHUNK,
                            STRIPES * r_dec * K * CHUNK)
    print(f"phase 6: K1 encode {k1_ms:.4f} ms (bound {k1_bound:.4f}), "
          f"K1 staged decode {k1_dec_ms:.4f} ms (bound {k1_dec_bound:.4f}), "
          f"K2 {k2_ms:.4f} ms (bound {k2_bound:.4f}) on {name_power}")

    kernels = [
        {"name": "gf_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/ec/kernels/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ec/kernels/bitmatmul.py:185",
         "launches": launches["gf_matmul"], "max_abs_err": err_k1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "staged_decode_ms": k1_dec_ms,
         "staged_decode_bound_ms": k1_dec_bound},
        {"name": "gf_decode_select", "route": "cuda",
         "source": "ceph_tpu_torch/ec/kernels/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ec/kernels/bitmatmul.py:302",
         "launches": launches["gf_decode_select"], "max_abs_err": err_k2,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    k3, placement = crush_phases(logs["crush_rule"], name_power, dev)
    kernels.append(k3)
    k1_repair, repair_state = repair_phases(name_power, gen, dev)
    kernels[0].update(k1_repair)

    work = _build.BUILD_DIR / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tool = crushtool_phase(name_power, dev, work)
    balance = balancer_phase(name_power, dev, work)
    guard = guard_phase(ec, ecutil, data.cpu().numpy().tobytes(), placement,
                        repair_state, tool["mapfile"], dev, name_power)
    k3["max_abs_err"] = max(k3["max_abs_err"], tool["max_abs_err"])
    k3.update({"launches_tester": tool["launches"],
               "launches_balancer": balance["launches"],
               "launches_guarded": guard["launches"]["crush_do_rule"],
               "tester": tool["rows"], "balancer": {
                   k: balance[k] for k in ("wall_s", "split_s",
                                           "split_wall_s", "k3_ms",
                                           "k3_share", "changes", "stddev",
                                           "cross_s")}})
    kernels[0]["launches_guarded"] = guard["launches"]["gf_matmul"]
    kernels[0]["host_us_per_call"] = guard["host_us_per_call"]
    mesh = mesh_phase(ec, state, name_power, dev)
    fabric = fabric_phase(ec, ecutil, name_power, dev)
    bench = bench_phase(name_power)
    bm.reset_launches()
    ec_pg = ec_pg_phase(ec, name_power, dev)
    launches = dict(bm.LAUNCHES)
    print(f"phase 18: launches {launches}")
    if launches["gf_matmul"] == 0:
        raise AssertionError("the EC PG data plane never launched gf_matmul")
    kernels[0].update({k: v for k, v in mesh.items() if k != "phase_s"})
    kernels[0]["launches_fabric"] = fabric["launches"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    mesh["max_abs_err_mesh"])
    # isa runs on the host and launches no K1: its rows stay on the
    # phase's lines
    kernels[0]["ec_bench"] = {k: v for k, v in bench["rows"].items()
                              if k.startswith("tpu/")}
    kernels[0]["launches_ecbackend"] = launches["gf_matmul"]
    kernels[0]["ecbackend"] = {k: ec_pg[k] for k in ("rows", "split_s",
                                                      "ratios")}
    bm.reset_launches()
    cb.reset_launches()
    cluster = cluster_phase(name_power, dev)
    launches = {**bm.LAUNCHES, **cb.LAUNCHES}
    print(f"phase 19: launches {launches}")
    if launches["gf_matmul"] == 0:
        raise AssertionError("the cluster never launched gf_matmul")
    if launches["crush_do_rule"] == 0:
        raise AssertionError("the cluster's mgr never launched crush_do_rule")
    kernels[0]["launches_cluster"] = launches["gf_matmul"]
    k3["launches_cluster"] = launches["crush_do_rule"]
    kernels[0]["elastic"] = {
        "g1": cluster["elastic"]["g1"],
        "update_s": cluster["elastic"]["update_s"],
        "g2": {k: cluster["elastic"]["g2"][k]
               for k in ("wall_s", "launches", "eio_launches")},
        "wall_s": cluster["elastic"]["wall_s"]}
    kernels[0]["cluster"] = {k: cluster[k] for k in (
        "legs", "recover_s", "rebuilt", "ratio", "messages")}
    kernels[0]["launches_serve"] = {
        half: cluster["serve"][half]["launches"]
        for half in ("write", "healthy", "degraded")}
    kernels[0]["launches_scheduled_scrub"] = cluster["scrub"]["launches"]
    bm.reset_launches()
    tcp = tcp_phase(name_power, dev, work / "phase20")
    launches = dict(bm.LAUNCHES)
    print(f"phase 20: launches in this process (legs a and b) {launches}")
    if launches["gf_matmul"] == 0:
        raise AssertionError("the cluster over TCP never launched gf_matmul")
    kernels[0]["launches_tcp"] = launches["gf_matmul"]
    kernels[0]["launches_processes"] = tcp["processes"]["launches"]
    kernels[0]["tcp"] = {
        "legs": tcp["tcp"]["legs"], "recover_s": tcp["tcp"]["recover_s"],
        "bench": tcp["processes"]["bench"],
        "degraded_read": tcp["processes"]["degraded"]}
    # vstart_leg zeroes K1's and K3's counts before the leg and reads them
    # after it
    vs = vstart_leg(name_power, work / "phase20d")
    kernels[0]["launches_vstart"] = vs["k1"]
    k3["launches_vstart"] = vs["k3"]
    durable = durable_phase(name_power, work / "phase21")
    kernels[0]["launches_durable"] = durable["launches"]
    kernels[0]["durable"] = {
        "bench": {k: durable[k] for k in ("write", "seq")},
        "degraded_read": durable["degraded"],
        "osd_restart_to_clean_s": durable["osd_restart_to_clean_s"],
        "mon_restart_to_serving_s": durable["mon_restart_to_serving_s"],
        "recovery": durable["recovery"]}
    bm.reset_launches()
    chaos = chaos_phase(name_power)
    launches = dict(bm.LAUNCHES)
    print(f"phase 22: launches {launches}")
    kernels[0]["launches_chaos"] = launches["gf_matmul"]
    kernels[0]["chaos"] = {k: chaos[k] for k in (
        "split", "full_rebuilds", "elections", "heal_to_quorum_sim_s",
        "phase_s")}
    print(f"chip_smoke: phases 12-14 {tool['wall_s']:.1f} + "
          f"{balance['phase_s']:.1f} + {guard['wall_s']:.1f} s; phases 15-21 "
          f"{mesh['phase_s']:.1f} + {fabric['phase_s']:.1f} + "
          f"{bench['phase_s']:.1f} + {ec_pg['phase_s']:.1f} + "
          f"{cluster['phase_s']:.1f} + {tcp['phase_s']:.1f} + "
          f"{vs['wall_s']:.1f} (20 d) + "
          f"{durable['phase_s']:.1f} s; phase 22 {chaos['phase_s']:.1f} s; "
          f"{time.monotonic() - t_start:.1f} s in all on {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
