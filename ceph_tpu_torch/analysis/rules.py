"""cephck rules of the port.

Each rule is small: an ``id``, a ``doc`` a finder can read, and
``check(ctx)`` yielding findings over one parsed file.

First the device contract on the CUDA path.  A *kernel wrapper* is a
function that counts a launch (``LAUNCHES[...] += 1``, where the port's
CUDA wrappers launch their kernels) or a function named ``*_cuda``; the
rules reach them through the project call graph.  These are the port's
copies of three rules of `ceph_tpu.analysis.rules`: `JaxTimingRule`
(:407) as ``cuda-timing``, `HostSyncHotPathRule` (:700) as
``host-sync-hot-path`` and `ImplicitTransferRule` (:1037) as
``implicit-transfer``; each has a red and a green snippet in
tests/test_torch_analysis.py.

Then the reference's twelve rules that are not device contracts
(locks, the wire schema, transactions, threads, the concurrency and
error-contract families), with the reference's ids, held to the
reference's fixture corpus (tests/fixtures/cephck/).  Their paths are
the port's: locks come from `ceph_tpu_torch.common.lockdep`, the wire
rules read the port's ``msg/messages.py`` against the reference's
lockfile (the port's wire types have the reference's schema), and the
error-contract rules cover the package but not tests, scripts or
chip_smoke.py.
"""
from __future__ import annotations

import ast
import json
import re
from typing import Iterator

from .engine import FileContext, Finding
from .project import ModuleInfo, ProjectContext, dotted

#: method calls that copy a tensor to the host or wait for the card
_READBACK = {"item", "cpu", "numpy", "tolist"}
#: of those, the ones only a tensor has (numpy arrays have .item() and
#: .tolist() too): a callee holding one of these surely syncs
_DEFINITE = {"cpu", "numpy", "synchronize"}


def _sync_name(node: ast.Call, mod: ModuleInfo | None,
               definite: bool = False) -> str | None:
    """The spelled-out sync when `node` copies to the host or waits
    for the card: ``x.item()``, ``x.cpu()``, ``x.numpy()``,
    ``x.tolist()``, ``torch.cuda.synchronize()`` or an event's
    ``synchronize()``."""
    name = dotted(node.func)
    if not name:
        return None
    canon = mod.expand(name) if mod else name
    if canon == "torch.cuda.synchronize":
        return canon
    if not isinstance(node.func, ast.Attribute) or node.args:
        return None
    recv = node.func.value
    if isinstance(recv, ast.Call) and mod is not None and \
            mod.expand(dotted(recv.func)).startswith("numpy."):
        return None           # a numpy result: already on the host
    attr = node.func.attr
    if attr in (_DEFINITE if definite else _READBACK | {"synchronize"}):
        return f"{name}()"
    return None


def _kernel_call(ctx: FileContext, node: ast.Call,
                 depth: int) -> str | None:
    """The callee's name when `node` calls a kernel wrapper, or a
    project function that reaches one within `depth` hops."""
    name = dotted(node.func)
    if not name:
        return None
    if name.split(".")[-1].endswith("_cuda"):
        return name
    mod, project = ctx.module(), ctx.project
    if mod is None or project is None:
        return None
    target = project.resolve(mod, name, ctx.qualname(node))
    if target is not None and project.reaches_launch(*target, depth):
        return name
    return None


def _callee_syncs(project: ProjectContext, owner: ModuleInfo, qual: str,
                  depth: int = 2) -> bool:
    """True when `qual`, or a function it reaches within `depth` hops,
    holds a definite sync (a tensor readback or a synchronize)."""
    targets = [(owner.name, qual)]
    targets += list(project.reachable(owner, qual, max_depth=depth))
    for modname, q in targets:
        m = project.modules.get(modname)
        fn = m.functions.get(q) if m else None
        if fn is None:
            continue
        if any(isinstance(n, ast.Call) and
               _sync_name(n, m, definite=True) is not None
               for n in ast.walk(fn)):
            return True
    return False


class CudaTimingRule:
    id = "cuda-timing"
    doc = """
time.perf_counter() region that launches a CUDA kernel and stops the
clock before the card has finished.

A kernel launch returns as soon as the work is queued on the stream, so
a host-clock region that ends without waiting measures the launch, not
the kernel.  The rule fires in torch-importing files when a
perf_counter region calls a kernel wrapper (a function that counts a
launch, a function named *_cuda, or a project function that reaches one
within three calls) and its last statement is neither
torch.cuda.synchronize(), an event's synchronize(), nor a host readback
(.item(), .cpu(), .numpy(), .tolist(), or a call to a project function
that does one).

Fix: torch.cuda.synchronize() (or end_event.synchronize()) as the LAST
statement inside the timed region, or time the kernel with CUDA events.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.imports_torch():
            return
        for block in ast.walk(ctx.tree):
            for body in (getattr(block, "body", None),
                         getattr(block, "orelse", None),
                         getattr(block, "finalbody", None)):
                if isinstance(body, list):
                    yield from self._check_block(ctx, body)

    @staticmethod
    def _perf_call(node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            dotted(node.func).endswith("perf_counter")

    def _check_block(self, ctx: FileContext,
                     body: list[ast.stmt]) -> Iterator[Finding]:
        i = 0
        while i < len(body):
            stmt = body[i]
            if not (isinstance(stmt, ast.Assign) and
                    len(stmt.targets) == 1 and
                    isinstance(stmt.targets[0], ast.Name) and
                    self._perf_call(stmt.value)):
                i += 1
                continue
            j = i + 1
            while j < len(body) and not any(
                    self._perf_call(n) for n in ast.walk(body[j])):
                j += 1
            region, start = body[i + 1:j], stmt.lineno
            i = j
            if not region:
                continue
            launch = next(
                ((n, name) for s in region for n in ast.walk(s)
                 if isinstance(n, ast.Call)
                 for name in [_kernel_call(ctx, n, 3)] if name), None)
            if launch is None or self._ends_synced(ctx, region[-1]):
                continue
            node, name = launch
            yield ctx.finding(
                self.id, node,
                f"timed region (clock started at line {start}) launches "
                f"through {name}() and stops the clock with no "
                f"synchronize or readback as its last statement: this "
                f"times the launch, not the kernel")

    @staticmethod
    def _ends_synced(ctx: FileContext, last: ast.stmt) -> bool:
        mod, project = ctx.module(), ctx.project
        for n in ast.walk(last):
            if not isinstance(n, ast.Call):
                continue
            if _sync_name(n, mod) is not None:
                return True
            if mod is not None and project is not None:
                target = project.resolve(mod, dotted(n.func),
                                         ctx.qualname(n))
                if target is not None and _callee_syncs(project, *target):
                    return True
        return False


#: files on the per-stripe or per-batch path: everything under ec/ and
#: crush/, plus the two OSD files the EC backend dispatches from
_HOT_BASENAMES = {"ec_backend.py", "ecutil.py"}


def _hot_path(rel: str) -> bool:
    parts = rel.split("/")
    return "ec" in parts or "crush" in parts or \
        (parts[-1] in _HOT_BASENAMES and "osd" in parts)


def _loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
    """Every node run on each iteration of a loop: body, orelse and a
    while loop's test, nested loops included, nested def and class
    bodies not (those run when called)."""
    stack: list[ast.stmt] = list(loop.body) + list(
        getattr(loop, "orelse", []) or [])
    if isinstance(loop, ast.While):
        yield from ast.walk(loop.test)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                stack.append(child)
            else:
                yield from ast.walk(child)


class HostSyncHotPathRule:
    id = "host-sync-hot-path"
    doc = """
Host sync (.item(), .cpu(), .numpy(), .tolist(),
torch.cuda.synchronize()) inside a per-stripe or per-batch loop on the
EC/CRUSH path (ec/, crush/, osd/ecutil.py, osd/ec_backend.py).

The batched EC path exists so the host<->device boundary is crossed
once per batch.  A sync inside the loop makes each iteration wait for
the card: launch, wait, launch, wait.  The check follows the project
call graph: a loop that calls a helper which surely syncs (a .cpu(),
.numpy() or synchronize() within two calls) is flagged at the call.

Fix: batch the loop into one launch and read back once.  Where the
sync is meant (a host-only path that never sees a card tensor, a loop
over a handful of objects), waive the site inline with
`# cephck: ignore[host-sync-hot-path] <reason>`.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _hot_path(ctx.rel) or not ctx.imports_torch():
            return
        mod, project = ctx.module(), ctx.project
        flagged: set[ast.AST] = set()
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in _loop_body_nodes(loop):
                if not isinstance(node, ast.Call) or node in flagged:
                    continue
                sync = _sync_name(node, mod)
                if sync is not None:
                    flagged.add(node)
                    yield ctx.finding(
                        self.id, node,
                        f"{sync} inside a loop (started line "
                        f"{loop.lineno}): a host sync per iteration "
                        f"serializes the card; batch the loop and sync "
                        f"once")
                    continue
                if project is None or mod is None:
                    continue
                target = project.resolve(mod, dotted(node.func),
                                         ctx.qualname(node))
                if target is not None and _callee_syncs(project, *target):
                    flagged.add(node)
                    yield ctx.finding(
                        self.id, node,
                        f"call to {target[1]}() ({target[0].name}) "
                        f"inside a loop (started line {loop.lineno}): "
                        f"the callee syncs with the host, so every "
                        f"iteration waits for the card")


#: numpy constructors whose result lives in host memory
_NP_CTORS = {
    "numpy." + n for n in (
        "zeros", "ones", "empty", "full", "arange", "frombuffer",
        "array", "asarray", "ascontiguousarray", "stack",
        "concatenate", "eye", "vstack", "hstack", "copy", "tile")}


def _nonassign_bindings(node: ast.AST) -> Iterator[str]:
    """Names bound by constructs other than a plain assignment."""
    targets: list[ast.AST] = []
    if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
        targets.append(node.target)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        targets.append(node.target)
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        targets += [i.optional_vars for i in node.items
                    if i.optional_vars is not None]
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                yield sub.id


class ImplicitTransferRule:
    id = "implicit-transfer"
    doc = """
Host (numpy) array handed straight to a kernel wrapper on the EC/CRUSH
path, without device.as_u8 or device.stage.

A kernel wrapper takes tensors on the card.  A numpy array handed to
one either fails at the launch or, through a helper that converts it,
becomes a blocking pageable copy per call, which the device guard
(common/devguard.py) forbids inside a launch region.

Fix: stage once, explicitly, at the batch boundary: device.as_u8(x,
dev) or device.stage(x, dev) (pinned, non-blocking), and keep the
tensor across calls.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _hot_path(ctx.rel) or not ctx.imports_torch():
            return
        mod = ctx.module()
        if mod is None:
            return
        for qual, fn in mod.functions.items():
            np_locals = self._numpy_locals(mod, fn)
            if not np_locals:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _kernel_call(ctx, node, 1)
                if name is None:
                    continue
                for a in list(node.args) + [kw.value
                                            for kw in node.keywords]:
                    if isinstance(a, ast.Name) and a.id in np_locals:
                        yield ctx.finding(
                            self.id, node,
                            f"host array {a.id!r} ({np_locals[a.id]}) "
                            f"handed to kernel wrapper {name}(): stage "
                            f"it once with device.as_u8 or device.stage")
                        break

    @staticmethod
    def _numpy_locals(mod: ModuleInfo, fn: ast.AST) -> dict[str, str]:
        """Names bound only to numpy constructors inside `fn`."""
        found: dict[str, str] = {}
        rebound: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            isinstance(node.value, ast.Call) and \
                            mod.expand(dotted(node.value.func)) in _NP_CTORS:
                        found[t.id] = mod.expand(dotted(node.value.func))
                        continue
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name):
                            rebound.add(sub.id)
            else:
                rebound.update(_nonassign_bindings(node))
        for name in rebound:
            found.pop(name, None)
        return found


# ===================================================================
# The reference's rules that are not device contracts, in the
# reference's ALL_RULES order (its rules.py:22-1935).


# ------------------------------------------------------------ raw-lock

class RawLockRule:
    id = "raw-lock"
    doc = """
Raw threading.Lock/RLock/Condition construction outside
common/lockdep.py.

Locks must come from ceph_tpu_torch.common.lockdep.make_lock(name):
under
the `lockdep` option (ON for every tier-1 run via tests/conftest.py)
make_lock returns an order-checked DebugLock, so the lock-order cycle
detector (ref: src/common/lockdep.cc) sees every acquisition.  A raw
threading primitive is invisible to it — a deadlock through that lock
is only found by the unlucky interleaving that actually hangs.

Fix: `from ceph_tpu_torch.common.lockdep import make_lock` and
construct
`make_lock("<subsystem>.<role>")` (name it uniquely enough that a
reported cycle identifies the site).  Note make_lock is reentrant
(RLock semantics) — do not rely on self-blocking.
"""
    FACTORIES = {"Lock", "RLock", "Condition"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.rel.endswith("common/lockdep.py"):
            return
        from_imports = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "threading":
                for a in node.names:
                    if a.name in self.FACTORIES:
                        from_imports.add(a.asname or a.name)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            hit = name.startswith("threading.") and \
                name.split(".", 1)[1] in self.FACTORIES or \
                name in from_imports
            if hit:
                yield ctx.finding(
                    self.id, node,
                    f"raw {name}() — use "
                    f"common.lockdep.make_lock(name) so the lock-order "
                    f"sanitizer sees this lock")


# ---------------------------------------------------------- wire-drift

def _versions_literal(tree: ast.Module) -> dict[str, tuple[int, int]]:
    """Module-level ``_VERSIONS = {"Name": (v, compat), ...}``."""
    out: dict[str, tuple[int, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "_VERSIONS"
                    for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and \
                        isinstance(v, ast.Tuple) and len(v.elts) == 2 and \
                        all(isinstance(e, ast.Constant) for e in v.elts):
                    out[str(k.value)] = (v.elts[0].value, v.elts[1].value)
    return out


def _message_classes(tree: ast.Module) -> list[ast.ClassDef]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                dotted(b).split(".")[-1] == "Message"
                for b in node.bases):
            out.append(node)
    return out


def _is_dataclass(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        if dotted(d).split(".")[-1] == "dataclass":
            return True
    return False


def _norm_type(s: str | None) -> str:
    return re.sub(r"\s+", "", s or "")


class WireSchemaRule:
    id = "wire-drift"
    doc = """
Wire struct drifted from the committed schema lockfile
(tests/fixtures/wire_schema.json).

The encode contract is ENCODE_START's (ref: src/include/encoding.h):
field lists are APPEND-ONLY.  Reordering, removing, renaming, or
retyping a field changes the positional encoding silently — an old
decoder reads the wrong field into the wrong slot, which is exactly
the mon fork this repository once shipped (an encode diverged from
its registered version).
Appending a field is legal ONLY with a `version` bump in _VERSIONS
(or the wire_struct/register_struct call).  `compat > version` is a
contradiction — no decoder could ever accept the struct — and is
rejected here before it can reject every peer at runtime.

Fix: restore the committed field prefix; append new fields at the
end and bump the version.  For an INTENTIONAL evolution, bump the
version and regenerate the lockfile:
`python scripts/gen_wire_schema.py` (then commit the diff).
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        classes = [c for c in _message_classes(ctx.tree)
                   if _is_dataclass(c)]
        if not classes:
            return
        schema_path = ctx.options["wire_schema"]
        try:
            lock = json.loads(schema_path.read_text())
        except FileNotFoundError:
            yield ctx.finding(
                self.id, ctx.tree,
                f"wire schema lockfile missing ({schema_path}) — "
                f"run: python scripts/gen_wire_schema.py", symbol="")
            return
        except json.JSONDecodeError as ex:
            yield ctx.finding(
                self.id, ctx.tree,
                f"wire schema lockfile unreadable: {ex}", symbol="")
            return
        versions = _versions_literal(ctx.tree)
        structs = lock.get("structs", {})
        for cls in classes:
            v, compat = versions.get(cls.name, (1, 1))
            if compat > v:
                yield ctx.finding(
                    self.id, cls,
                    f"{cls.name}: compat {compat} > version {v} — no "
                    f"decoder could ever accept this struct",
                    symbol=cls.name)
                continue
            fields = [(n.target.id, _norm_type(ast.unparse(n.annotation)))
                      for n in cls.body
                      if isinstance(n, ast.AnnAssign) and
                      isinstance(n.target, ast.Name)]
            pinned = structs.get(cls.name)
            if pinned is not None:
                # a redeclared base field (e.g. MClientCaps.seq) keeps
                # the BASE's wire position, not its class-body one —
                # compare declared-only fields on both sides
                inherited = {f["name"] for f in pinned["fields"] or ()
                             if f.get("inherited")}
                fields = [f for f in fields if f[0] not in inherited]
            if pinned is None:
                yield ctx.finding(
                    self.id, cls,
                    f"{cls.name}: not in the wire schema lockfile — "
                    f"regenerate it (python scripts/gen_wire_schema.py) "
                    f"to pin the new struct", symbol=cls.name)
                continue
            # inherited (Message-base) fields encode first but are not
            # declared in the class body the AST sees — the runtime
            # check (tests/test_wire_schema.py) pins those
            want = [(f["name"], _norm_type(f.get("type")))
                    for f in pinned["fields"] or ()
                    if not f.get("inherited")]
            bad = None
            for i, (wn, wt) in enumerate(want):
                if i >= len(fields):
                    bad = (f"field {wn!r} removed (committed at "
                           f"position {i}) — wire field lists are "
                           f"append-only")
                    break
                gn, gt = fields[i]
                if gn != wn:
                    bad = (f"field {i} is {gn!r} but the lockfile pins "
                           f"{wn!r} — reorder/rename breaks positional "
                           f"decode")
                    break
                if wt and gt and gt != wt:
                    bad = (f"field {gn!r} retyped {wt!r} -> {gt!r} — "
                           f"old decoders read the old type")
                    break
            if bad:
                yield ctx.finding(self.id, cls, f"{cls.name}: {bad}",
                                  symbol=cls.name)
                continue
            if len(fields) > len(want) and v <= int(pinned["version"]):
                extra = [n for n, _t in fields[len(want):]]
                yield ctx.finding(
                    self.id, cls,
                    f"{cls.name}: field(s) {extra} appended without a "
                    f"version bump (still v{v}) — old decoders can't "
                    f"tell the tail is there; bump _VERSIONS and "
                    f"regenerate the lockfile", symbol=cls.name)


# ------------------------------------------------ unregistered-message


class UnregisteredMessageRule:
    id = "unregistered-message"
    doc = """
Message subclass that _register_all() will never wire-register.

msg/messages.py registers every module-level *dataclass* Message
subclass automatically.  A Message subclass that is not a dataclass
compiles, type-checks, and then raises WireError("not
wire-registered") the first time it crosses a TCP messenger — or
worse, never does in tests (the in-process transport skips
serialization) and only fails in a real deployment.

Fix: decorate the class with @dataclass (fields become the wire
field list), or register it explicitly via register_struct with
to_fields/from_fields.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for cls in _message_classes(ctx.tree):
            if not _is_dataclass(cls):
                yield ctx.finding(
                    self.id, cls,
                    f"{cls.name}(Message) is not a dataclass — "
                    f"_register_all() skips it, so it is NOT "
                    f"wire-registered and dies with WireError on the "
                    f"first real (TCP) send", symbol=cls.name)


# ------------------------------------------------------- txn-atomicity

#: Transaction mutators that touch object omaps — the pgmeta bug class
OMAP_MUTATORS = {"omap_setkeys", "omap_rmkeys", "omap_clear"}

#: receiver names that clearly ARE a transaction
_TXNISH = re.compile(r"^(txn?\d*|tx\d*|transaction|.*_txn)$")


class TxnAtomicityRule:
    id = "txn-atomicity"
    doc = """
omap mutation in osd/ outside a Transaction context.

The persist_log bug: an omap mutation issued outside the owning
store Transaction wiped non-log pgmeta keys (the snap index and
purged_snaps cursor) on every peering merge — state that must move
atomically with the data didn't.  In osd/ code, omap_setkeys /
omap_rmkeys / omap_clear must be invoked on a Transaction (named
txn/t/tx/*_txn, or constructed from Transaction() in the same
function) that the caller applies as ONE unit with the rest of the
update.

Fix: thread the owning Transaction into the helper and append the
omap ops to IT; never apply a private side-transaction for state
that must be atomic with the caller's.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if "osd" not in ctx.rel.split("/"):
            return
        # names bound from Transaction() per enclosing function
        txn_bound: dict[ast.AST, set[str]] = {}
        parents = ctx.parents()

        def scope_of(node: ast.AST) -> ast.AST:
            cur = parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Module)):
                cur = parents.get(cur)
            return cur or ctx.tree

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    dotted(node.value.func).split(".")[-1] == "Transaction":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        txn_bound.setdefault(scope_of(node),
                                             set()).add(t.id)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr in OMAP_MUTATORS):
                continue
            recv = node.func.value
            # chained builder calls: txn.touch(...).omap_setkeys(...)
            while isinstance(recv, ast.Call) and \
                    isinstance(recv.func, ast.Attribute):
                recv = recv.func.value
            name = dotted(recv).split(".")[-1]
            if _TXNISH.match(name):
                continue
            if isinstance(recv, ast.Call) and \
                    dotted(recv.func).split(".")[-1] == "Transaction":
                continue
            if name in txn_bound.get(scope_of(node), ()):
                continue
            yield ctx.finding(
                self.id, node,
                f".{node.func.attr}() on {dotted(recv) or '<expr>'!r} — "
                f"omap state in osd/ must mutate through the owning "
                f"Transaction (persist_log bug class: non-atomic pgmeta "
                f"updates)")


# ------------------------------------------------------- silent-thread

_LOGGISH = re.compile(
    r"(dout|derr|print|log|warn|error|exception|fail|append|traceback|"
    r"put_nowait|set_exception)", re.I)


class SilentThreadRule:
    id = "silent-thread"
    doc = """
threading.Thread target that can swallow its own death.

A daemon thread whose body catches Exception (or everything) and
neither logs nor re-raises dies silently: the heartbeat keeps
beating, the queue keeps growing, and the first observable symptom
is a wedged cluster minutes later.  (Python threads don't propagate
exceptions to their parent — the except handler is the ONLY place
the failure can surface.)

Fix: in the handler, log through dout/derr (common.log) or collect
the error somewhere a supervisor checks — or narrow the except to
the exceptions the loop genuinely expects.
"""
    BROAD = {None, "Exception", "BaseException"}

    def _resolve(self, ctx: FileContext,
                 target: ast.AST) -> ast.FunctionDef | None:
        if isinstance(target, ast.Name):
            want, in_class = target.id, False
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            want, in_class = target.attr, True
        else:
            return None
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == want:
                parent = ctx.parents().get(node)
                if in_class == isinstance(parent, ast.ClassDef):
                    return node
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        seen: set[ast.AST] = set()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    dotted(node.func).split(".")[-1] == "Thread"):
                continue
            target = next((kw.value for kw in node.keywords
                           if kw.arg == "target"), None)
            if target is None:
                continue
            fn = self._resolve(ctx, target)
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            for h in ast.walk(fn):
                if not isinstance(h, ast.ExceptHandler):
                    continue
                tname = None if h.type is None \
                    else dotted(h.type).split(".")[-1]
                if tname not in self.BROAD:
                    continue
                ok = any(isinstance(n, ast.Raise)
                         for n in ast.walk(h)) or any(
                    isinstance(n, ast.Call) and
                    _LOGGISH.search(dotted(n.func))
                    for n in ast.walk(h))
                if not ok:
                    yield ctx.finding(
                        self.id, h,
                        f"thread target {fn.name}() swallows "
                        f"{'everything' if tname is None else tname} "
                        f"without logging or re-raising — the thread "
                        f"dies silently", symbol=fn.name)



class BareExceptRule:
    id = "bare-except"
    doc = """
Bare `except:` clause.

Bare except catches SystemExit, KeyboardInterrupt, and MemoryError —
a daemon loop with one becomes unkillable and hides OOM.  The
reference's C++ has no equivalent hazard; in this Python tree it is
banned outright.

Fix: catch Exception (plus logging — see silent-thread) or the
specific exceptions the call can raise; re-raise what you can't
handle.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield ctx.finding(
                    self.id, node,
                    "bare `except:` also catches SystemExit/"
                    "KeyboardInterrupt — name the exceptions (at "
                    "minimum `except Exception`)")


# ===================================================================
# The concurrency family (racecheck's static half): guarded-by
# inference and blocking-in-dispatch, both leaning on ctx.project.


def _self_attr(node: ast.AST) -> str | None:
    """'x' when `node` is ``self.x`` (one level only)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


_LOCK_FACTORIES = {"make_lock", "Lock", "RLock", "Condition"}


def _lock_fields(cls: ast.ClassDef) -> set[str]:
    """Attribute names assigned from make_lock()/threading locks
    anywhere in the class body: the candidate guards."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                dotted(node.value.func).split(".")[-1] in _LOCK_FACTORIES:
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.add(attr)
    return out


def _acquires(fn: ast.AST, lock: str) -> bool:
    """Does `fn` take ``self.<lock>`` anywhere — ``with self.L:`` or
    an explicit ``self.L.acquire()``?  Method-level granularity on
    purpose: cephck flags the METHOD that touches guarded state
    without ever taking the guard (the persist_log shape), not
    statement-level windows."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if _self_attr(expr) == lock:
                    return True
                if isinstance(expr, ast.Call) and \
                        _self_attr(expr.func) == lock:
                    return True
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("acquire", "acquire_lock"):
            if _self_attr(node.func.value) == lock:
                return True
    return False


#: methods whose accesses never count: constructors and teardown run
#: before publish / after quiesce (the init-before-publish phase the
#: runtime sanitizer's EXCLUSIVE state models)
_GB_EXEMPT_METHODS = {"__init__", "__post_init__", "__del__", "init",
                      "start", "shutdown", "close", "stop", "__exit__"}

#: minimum accessing methods / guarded fraction before the inference
#: trusts itself: below this the "majority" is noise, not a contract
_GB_MIN_GUARDED_METHODS = 2
_GB_MIN_ACCESSES = 5
_GB_MIN_FRACTION = 0.75


class GuardedByRule:
    id = "guarded-by"
    doc = """
Attribute access outside the lock that guards it everywhere else in
the class.

For each class owning a make_lock() field, the rule infers which lock
guards each ``self._x``: if >= 75% of the accesses (outside
__init__/shutdown) happen in methods that take ``self._lock``, that
lock IS the attribute's guard — and the minority accesses in methods
that never take it are exactly the persist_log bug shape (one
unlocked writer clobbering pgmeta under a peering merge), caught at
parse time instead of by the unlucky interleaving.  A method reached
ONLY from acquiring methods (a private helper called under the lock)
counts as guarded through the project call graph.

Fix: take the inferred lock around the flagged access (or hoist the
access into a locked caller).  If the access is genuinely safe — an
init-phase path, a hand-off the runtime sanitizer documents with
transfer_ownership(), a read of a monotonic flag — waive it inline
with `# cephck: ignore[guarded-by]` and a reason comment, or add a
baseline entry with the reason.  The runtime twin of this rule is
common/racecheck.py: annotate both the same way.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        mod = ctx.module()
        project = ctx.project
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_fields(cls)
            if not locks:
                continue
            methods = [n for n in cls.body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            if not methods:
                continue
            # attr -> [(method, access node, is_store)]
            accesses: dict[str, list] = {}
            acquired: dict[str, set[str]] = {
                L: {m.name for m in methods if _acquires(m, L)}
                for L in locks}
            for m in methods:
                if m.name in _GB_EXEMPT_METHODS:
                    continue
                for node in ast.walk(m):
                    attr = _self_attr(node)
                    if attr is None or attr in locks or \
                            not attr.startswith("_") or \
                            attr.startswith("__"):
                        continue
                    accesses.setdefault(attr, []).append(
                        (m, node, isinstance(node.ctx, ast.Store)))
            for attr, accs in accesses.items():
                yield from self._check_attr(ctx, mod, project, cls,
                                            attr, accs, acquired)

    def _covered(self, project, mod, cls: ast.ClassDef,
                 guarded: set[str], method: str) -> bool:
        """True when `method` is reached ONLY from guarded methods of
        the same class (a locked caller's private helper).  A public
        or caller-less method is its own entry point: not covered."""
        if project is None or mod is None or \
                not method.startswith("_"):
            return False
        project.finalize()
        me = (mod.name, f"{cls.name}.{method}")
        callers = project.callers.get(me)
        if not callers:
            return False
        seen = {method}
        work = list(callers)
        while work:
            src_mod, src_qual = work.pop()
            if src_mod != mod.name or \
                    not src_qual.startswith(f"{cls.name}."):
                return False            # reached from outside the class
            name = src_qual.split(".", 1)[1]
            if name in guarded or name in seen:
                continue
            if not name.startswith("_"):
                return False
            seen.add(name)
            nxt = project.callers.get((src_mod, src_qual))
            if not nxt:
                return False
            work.extend(nxt)
        return True

    def _check_attr(self, ctx, mod, project, cls, attr, accs,
                    acquired) -> Iterator[Finding]:
        if len(accs) < _GB_MIN_ACCESSES:
            return
        best = None
        for lock, fns in acquired.items():
            under = sum(1 for m, _n, _w in accs if m.name in fns)
            if best is None or under > best[1]:
                best = (lock, under, fns)
        lock, under, fns = best
        if under < len(accs) * _GB_MIN_FRACTION or under == len(accs):
            return
        if len({m.name for m, _n, _w in accs
                if m.name in fns}) < _GB_MIN_GUARDED_METHODS:
            return
        flagged: set[int] = set()
        for m, node, is_store in accs:
            if m.name in fns or node.lineno in flagged:
                continue
            if self._covered(project, mod, cls, fns, m.name):
                continue
            flagged.add(node.lineno)
            kind = "write to" if is_store else "read of"
            yield ctx.finding(
                self.id, node,
                f"{kind} self.{attr} in {cls.name}.{m.name}() without "
                f"self.{lock} — {under}/{len(accs)} accesses take "
                f"that lock, so it is the inferred guard "
                f"(persist_log bug class: one unlocked accessor "
                f"corrupts state every locked site protects)",
                symbol=f"{cls.name}.{m.name}")


# -------------------------------------------------- blocking-in-dispatch

#: function names that ARE a message-dispatch context: the messenger
#: dispatch/reader threads call these per message, so anything that
#: blocks inside stalls every peer behind the queue.  The top-of-loop
#: waits (_dispatch_loop's queue.get, _read_loop's recv) are the
#: wait-for-work by design and are NOT entries.
_DISPATCH_ENTRIES = {"ms_dispatch", "_deliver", "_deliver_verified"}

#: canonical call names that block the calling thread outright
_BLOCKING_CANON = {"time.sleep", "socket.create_connection",
                   "select.select"}

#: attribute-call patterns that block: last segment -> receiver test
_THREADISH = re.compile(r"(thread|worker|proc)", re.I)
_QUEUEISH = re.compile(r"(queue|_q)$|^q$", re.I)
_SOCKISH = re.compile(r"(sock|conn|listener)$|^s$", re.I)


def _blocking_call(node: ast.Call, mod: ModuleInfo | None) -> str | None:
    """Human-readable description when `node` blocks its thread."""
    name = dotted(node.func)
    if not name:
        return None
    canon = mod.expand(name) if mod else name
    if canon in _BLOCKING_CANON:
        return canon
    last = name.split(".")[-1]
    recv = name.rsplit(".", 2)[-2] if "." in name else ""
    if last == "sleep" and (canon.startswith("time.") or recv == "time"):
        return f"{name}()"
    if last == "join" and _THREADISH.search(recv):
        return f"{name}() (thread join)"
    if last in ("wait", "wait_for"):
        # Event/Condition wait — any receiver: there is no non-blocking
        # spelling of .wait()
        return f"{name}() (condition/event wait)"
    if last == "get" and _QUEUEISH.search(recv) and not node.args \
            and not any(kw.arg == "block" for kw in node.keywords):
        # a positional arg IS `block` (q.get(False)), and an explicit
        # block= keyword means the caller chose — only the bare
        # blocking default is flagged
        return f"{name}() (blocking queue get)"
    if last in ("recv", "recv_into", "accept") and \
            _SOCKISH.search(recv or "x"):
        return f"{name}() (socket wait)"
    if last == "block_until_ready":
        return f"{name}() (device sync)"
    if last in ("recv_frame", "_recv_exact"):
        return f"{name}() (socket wait)"
    return None


class BlockingInDispatchRule:
    id = "blocking-in-dispatch"
    doc = """
Blocking call reachable from a messenger dispatch entry point
(ms_dispatch / the deliver path in ceph_tpu_torch/msg/).

The dispatch thread is shared: every message from every peer funnels
through it.  A handler that sleeps, joins a thread, waits on a
condition, or blocks in a socket/queue/device wait stalls the WHOLE
daemon's inbound traffic for the duration — and when the thing it
waits for needs another message on the same thread to make progress,
it deadlocks outright (the ICIFabric concurrent mesh-launch hang:
dispatch blocked in block_until_ready while the reply it needed sat
behind it in the queue).  The check is cross-module: the project call
graph is walked from each dispatch entry (depth-bounded), so a
handler that calls a helper that sleeps two modules away is flagged
at the handler.

Fix: move the blocking work off the dispatch thread (queue it to a
worker, complete it from the tick), or make the wait event-driven.
For a BOUNDED wait that is the design (e.g. a capped handshake wait
with a timeout argument), waive the site inline with
`# cephck: ignore[blocking-in-dispatch]` and a reason comment, or
add a baseline entry with the reason.
"""
    MAX_DEPTH = 4

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        mod = ctx.module()
        if mod is None:
            return
        project = ctx.project
        for qual, fn in mod.functions.items():
            short = qual.split(".")[-1]
            if short not in _DISPATCH_ENTRIES:
                continue
            # local blocking calls: flagged at the call itself
            reported: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    b = _blocking_call(node, mod)
                    if b is not None and b not in reported:
                        reported.add(b)
                        yield ctx.finding(
                            self.id, node,
                            f"{b} inside dispatch entry {qual}() — "
                            f"the dispatch thread serves every peer; "
                            f"a blocked handler stalls the daemon's "
                            f"whole inbound queue", symbol=qual)
            if project is None:
                continue
            # cross-module: anything reachable from the entry that
            # contains a blocking call, flagged at the entry
            for tmod_name, tqual in project.reachable(
                    mod, qual, max_depth=self.MAX_DEPTH):
                tmod = project.modules.get(tmod_name)
                tfn = tmod.functions.get(tqual) if tmod else None
                if tfn is None:
                    continue
                for node in ast.walk(tfn):
                    if not isinstance(node, ast.Call):
                        continue
                    b = _blocking_call(node, tmod)
                    key = f"{tmod_name}.{tqual}:{b}"
                    if b is not None and key not in reported:
                        reported.add(key)
                        yield ctx.finding(
                            self.id, fn,
                            f"dispatch entry {qual}() reaches "
                            f"{tqual}() ({tmod_name}) which blocks "
                            f"in {b} — the dispatch thread serves "
                            f"every peer; a blocked handler stalls "
                            f"the daemon's whole inbound queue",
                            symbol=qual)


# ===================================================================
# The error-contract family (errcheck's static half): how failures
# propagate — or vanish — between `except`, the return value, and the
# reply a client is waiting on.  Runtime twin: common/errcheck.py
# (the fired-handler coverage sanitizer; ERRCOV_rNN.json says which of
# these handlers fault injection has actually reached).

#: the broad spellings; bare `except:` is bare-except's, not ours
_BROAD_EXC = {"Exception", "BaseException"}


#: top-level paths outside the error contract: tests, scripts and the
#: chip smoke sleep-poll and clean up best-effort by design
_ERROR_SCOPE_OUT = ("tests", "scripts", "bench.py", "chip_smoke.py")


def _error_scope(rel: str) -> bool:
    """Daemon and library code only (the port's package): tests,
    scripts and chip_smoke.py are skipped.  The fixture corpus stays in
    scope so the rules can demonstrate themselves."""
    parts = rel.split("/")
    if "fixtures" in parts:
        return True
    return parts[0] not in _ERROR_SCOPE_OUT


def _broad_handler(node: ast.AST) -> str | None:
    """'Exception'/'BaseException' when `node` is a handler catching
    (at least) everything an op can raise."""
    if isinstance(node, ast.ExceptHandler) and node.type is not None:
        t = dotted(node.type).split(".")[-1]
        if t in _BROAD_EXC:
            return t
    return None


class SwallowedErrorRule:
    id = "swallowed-error"
    doc = """
Broad except handler whose body is only pass/continue/break — the
failure vanishes without a trace.

`except Exception: pass` is how DataLog.list turned an injected EIO
into "caught up" and how an undecodable sync marker wedged a sync
tick forever: the caller branches on a result that no longer says
anything, and the first observable symptom is minutes away from the
fault.  This tree has crash capture (common/crash.py), a structured
logger (common/log.py dout/derr), and a quarantine pattern for
poison input — a handler that uses NONE of them is hiding a failure,
not handling it.

Fix: narrow the except to the exceptions this call genuinely expects,
or keep the broad catch but leave a trace (dout/derr), record the
error somewhere a caller/supervisor checks, or re-raise what you
can't own.  For a true don't-care (best-effort cleanup on teardown),
waive inline with `# cephck: ignore[swallowed-error]` and a reason
comment, or add a baseline entry with the reason.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _error_scope(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            t = _broad_handler(node)
            if t is None:
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue, ast.Break))
                   for s in node.body):
                yield ctx.finding(
                    self.id, node,
                    f"except {t} swallows every failure without "
                    f"logging, recording, or re-raising — narrow the "
                    f"except or leave a trace (DataLog "
                    f"EIO-became-'caught up' class)")


def _success_shaped(expr: ast.expr | None) -> str | None:
    """Spelled-out value when `expr` is a success-shaped constant —
    the shapes a healthy read path also returns, so the caller cannot
    tell failure from empty.  Booleans are excluded: False IS an
    error encoding for predicate paths."""
    if expr is None:
        return "None"
    if isinstance(expr, ast.Constant):
        v = expr.value
        if v is None:
            return "None"
        if isinstance(v, bool):
            return None
        if v == 0 or v == "" or v == b"":
            return repr(v)
        return None
    if isinstance(expr, ast.List) and not expr.elts:
        return "[]"
    if isinstance(expr, ast.Tuple) and not expr.elts:
        return "()"
    if isinstance(expr, ast.Dict) and not expr.keys:
        return "{}"
    if isinstance(expr, ast.Call) and not expr.args and \
            not expr.keywords and \
            dotted(expr.func) in ("list", "dict", "set", "tuple"):
        return f"{dotted(expr.func)}()"
    return None


def _enoent_raise(handler: ast.ExceptHandler) -> ast.Raise | None:
    """A raise inside `handler` that maps the caught exception to an
    ENOENT-shaped error (errno 2 / "ENOENT" literal)."""
    for node in ast.walk(handler):
        if not (isinstance(node, ast.Raise) and
                isinstance(node.exc, ast.Call)):
            continue
        args = node.exc.args
        if not args:
            continue
        first = args[0]
        enoentish = (isinstance(first, ast.Constant) and
                     first.value == 2 and
                     not isinstance(first.value, bool)) or any(
            isinstance(a, ast.Constant) and a.value == "ENOENT"
            for a in args)
        if enoentish:
            return node
    return None


class ErrnoConflationRule:
    id = "errno-conflation"
    doc = """
Broad except handler that maps EVERY failure of a read/apply path to
one success-shaped or ENOENT-shaped result.

Three shapes of the same bug: (a) `except Exception: return []` — an
injected EIO now reads as "no data" (the DataLog.list class, fixed by
re-raising non-ENOENT); (b) `except Exception: x = 0` — a
transient stat failure silently resets a cursor/size to its initial
value; (c) `except Exception: raise XError(2, ...)` — decode errors,
EIO, and genuine not-found all become "does not exist", so the caller
deletes/recreates state that still exists.  In every shape the errno
dataflow from the fault to the caller is severed at the handler.

Fix: catch the one exception that legitimately means empty/not-found
(KeyError, the ENOENT RadosError) and let everything else propagate —
or map exceptions to DISTINCT errnos so the caller can branch.  A
handler that LOGS before collapsing (dout/derr) is observable and is
exempt from shapes (a)/(b) — the bug class is silence.  Where the
collapse is the documented contract, waive inline with
`# cephck: ignore[errno-conflation]` and a reason comment, or add a
baseline entry with the reason.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _error_scope(ctx.rel):
            return
        parents = ctx.parents()

        def enclosing_fn(node: ast.AST):
            cur = parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cur = parents.get(cur)
            return cur

        for node in ast.walk(ctx.tree):
            t = _broad_handler(node)
            if t is None:
                continue
            # (c) everything -> ENOENT
            rz = _enoent_raise(node)
            if rz is not None:
                yield ctx.finding(
                    self.id, rz,
                    f"except {t} re-raised as an ENOENT-shaped error — "
                    f"EIO/decode failures become 'does not exist'; "
                    f"narrow the except or map distinct errnos")
                continue
            # (a)/(b) fire only on SILENT collapse — a handler that
            # logs first is observable
            if len(node.body) != 1:
                continue
            only = node.body[0]
            # (a) everything -> success-shaped return
            if isinstance(only, ast.Return):
                shape = _success_shaped(only.value)
                fn = enclosing_fn(node)
                if shape is None or fn is None:
                    continue
                real_return = any(
                    isinstance(r, ast.Return) and r is not only and
                    r.value is not None and
                    _success_shaped(r.value) is None
                    for r in ast.walk(fn))
                if real_return:
                    yield ctx.finding(
                        self.id, only,
                        f"except {t}: return {shape} — every failure "
                        f"of {fn.name}() now reads as a successful "
                        f"empty result (DataLog EIO class); re-raise "
                        f"what isn't the expected miss")
            # (b) everything -> success-shaped assignment
            elif isinstance(only, ast.Assign) and \
                    len(only.targets) == 1 and \
                    isinstance(only.targets[0], ast.Name):
                shape = _success_shaped(only.value)
                if shape is not None:
                    yield ctx.finding(
                        self.id, only,
                        f"except {t}: {only.targets[0].id} = {shape} — "
                        f"any failure (including EIO) silently resets "
                        f"the value to its success-shaped default; "
                        f"narrow the except or propagate")


# ------------------------------------------------- reply-on-all-paths

#: command handlers that must RETURN a (r, outs, outb) result (or
#: raise) on every path — the caller unpacks the tuple
_RETURN_CONV = {"handle_command", "_handle_module_command"}

#: HTTP-op methods (RGW/Swift `_*_op` convention): every path must
#: send a reply, delegate, or raise
_OP_METHOD = re.compile(r"^_[a-z0-9_]+_op$")

#: call names that ARE the reply
_REPLYISH = {"_respond", "respond", "send_reply", "send_error",
             "reply_cb"}

_RESOLVED, _OPEN = "resolved", "open"


def _reply_call(node: ast.Call) -> bool:
    last = (dotted(node.func) or "").split(".")[-1]
    return last in _REPLYISH or bool(_OP_METHOD.match(last))


class _PathScan:
    """Conservative all-paths walk over a handler body.  Tracks, per
    path, whether a reply has been sent; collects findings at returns
    that end a path unanswered.  `block` returns (_RESOLVED if no
    path can fall out the bottom, else _OPEN, replied-after)."""

    def __init__(self, conv: str):
        self.conv = conv                    # "return" | "respond"
        self.findings: list[tuple[ast.AST, str]] = []

    def block(self, stmts, replied: bool):
        for st in stmts:
            status, replied = self.stmt(st, replied)
            if status is _RESOLVED:
                return _RESOLVED, replied
        return _OPEN, replied

    def _branches(self, replied, *blocks, fallthrough: bool):
        """If/Match combinator: every branch resolved (and no silent
        fallthrough) resolves the statement; else the open paths'
        replied states AND together."""
        outs = []
        for b in blocks:
            s, r = self.block(b, replied)
            if s is _OPEN:
                outs.append(r)
        if fallthrough:
            outs.append(replied)
        if not outs:
            return _RESOLVED, replied
        return _OPEN, all(outs)

    def stmt(self, st: ast.stmt, replied: bool):
        if isinstance(st, ast.Return):
            if self.conv == "return":
                if st.value is None:
                    self.findings.append((
                        st, "bare `return` — the caller unpacks a "
                            "(r, outs, outb) result and gets None "
                            "(30s-client-hang class)"))
            else:
                ok = replied or isinstance(st.value, ast.Call)
                if not ok:
                    self.findings.append((
                        st, "returns without sending a reply on this "
                            "path — the client waits out its full "
                            "timeout"))
            return _RESOLVED, replied
        if isinstance(st, ast.Raise):
            return _RESOLVED, replied
        if isinstance(st, ast.If):
            return self._branches(
                replied, st.body, *((st.orelse,) if st.orelse else ()),
                fallthrough=not st.orelse)
        if isinstance(st, ast.Match):
            wild = any(isinstance(c.pattern, ast.MatchAs) and
                       c.pattern.pattern is None for c in st.cases)
            return self._branches(
                replied, *(c.body for c in st.cases),
                fallthrough=not wild)
        if isinstance(st, (ast.With, ast.AsyncWith)):
            return self.block(st.body, replied)
        if isinstance(st, ast.Try):
            sb, rb = self.block(list(st.body) + list(st.orelse),
                                replied)
            outs = [] if sb is _RESOLVED else [rb]
            for h in st.handlers:
                sh, rh = self.block(h.body, replied)
                if sh is _OPEN:
                    outs.append(rh)
            entry = all(outs) if outs else True
            sf, rf = self.block(st.finalbody, entry)
            if sf is _RESOLVED or not outs:
                return _RESOLVED, rf
            return _OPEN, rf
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            # findings inside still count; the loop itself only
            # guarantees resolution when it can never exit
            self.block(st.body, replied)
            self.block(st.orelse, replied)
            infinite = isinstance(st, ast.While) and \
                isinstance(st.test, ast.Constant) and \
                bool(st.test.value) and not any(
                    isinstance(n, ast.Break)
                    for n in _loop_body_nodes(st))
            return (_RESOLVED if infinite else _OPEN), replied
        # simple statement: a reply call anywhere in it answers the
        # client for the rest of this path
        if any(isinstance(n, ast.Call) and _reply_call(n)
               for n in ast.walk(st)):
            replied = True
        return _OPEN, replied


def _class_has_respond(cls: ast.ClassDef) -> bool:
    return any(isinstance(n, ast.Call) and
               _self_attr(n.func) == "_respond"
               for n in ast.walk(cls))


class ReplyOnAllPathsRule:
    id = "reply-on-all-paths"
    doc = """
Dispatch/command handler with an execution path that never answers.

The bug class: a mgr module command path that neither returned a
result nor raised left the client waiting out its FULL 30s timeout —
the failure mode is silence, which no log line ever explains.  Two
conventions are checked: (1) command handlers (handle_command /
_handle_module_command) must `return` a (r, outs, outb) result or
raise on every CFG path — a bare `return` or falling off the end
hands the caller None; (2) RGW/Swift HTTP op methods (`_*_op` in a
class that replies via self._respond) must send a reply
(_respond/send_error/...), delegate (`return self._other_op(...)`),
or raise on every path — an early `return` before any reply leaves
the HTTP client hanging.

Fix: make the missing branch answer — return an explicit
(-errno, explanation, None), call self._respond with the right
status, or raise the typed error the wrapper maps to a reply.  For a
path that genuinely must not reply (a reply already owned by a
callee the rule can't see), waive inline with
`# cephck: ignore[reply-on-all-paths]` and a reason comment, or add
a baseline entry with the reason.
"""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _error_scope(ctx.rel):
            return
        parents = ctx.parents()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if fn.name in _RETURN_CONV:
                conv = "return"
            elif _OP_METHOD.match(fn.name) and isinstance(
                    parents.get(fn), ast.ClassDef) and \
                    _class_has_respond(parents[fn]):
                conv = "respond"
            else:
                continue
            scan = _PathScan(conv)
            status, replied = scan.block(fn.body, False)
            for node, msg in scan.findings:
                yield ctx.finding(self.id, node,
                                  f"{fn.name}(): {msg}",
                                  symbol=ctx.qualname(fn))
            if status is _OPEN:
                if conv == "return":
                    yield ctx.finding(
                        self.id, fn,
                        f"{fn.name}() can fall off the end without "
                        f"returning a (r, outs, outb) result — the "
                        f"caller unpacks None (30s-client-hang "
                        f"class)", symbol=ctx.qualname(fn))
                elif not replied:
                    yield ctx.finding(
                        self.id, fn,
                        f"{fn.name}() has a path that falls off the "
                        f"end without sending a reply — the HTTP "
                        f"client waits out its full timeout",
                        symbol=ctx.qualname(fn))


class BareRetryRule:
    id = "bare-retry"
    doc = """
Retry loop pacing itself with raw time.sleep / hand-rolled delay
math instead of common/backoff.Backoff.

common/backoff unified retry pacing for a reason: fixed-delay retries
synchronize (every client re-hits the dead mon on the same beat),
hand-rolled `delay *= 2` forgets the cap or the jitter, and none of
it is clock-injectable for tests.  Backoff(base_s, cap_s) gives
capped exponential full-jitter pacing (AWS-architecture shape), a
fail()/ready() non-blocking form for tick loops, and deterministic
tests via rng/clock injection.

The rule fires on (a) a time.sleep inside an except handler inside a
loop — the classic catch-sleep-retry shape — and (b) a loop that
sleeps on a delay variable it multiplies/exponentiates itself.
Fixed-interval tick/poll pacing (sleep in the loop body, no handler
involvement) is not a retry and is not flagged; sleeps driven by a
Backoff (.next_delay()/.sleep()) are the fix, never flagged.

Fix: hoist a Backoff(base_s=..., cap_s=...) out of the loop, call
.sleep() where the raw sleep was, and .reset() on success.
"""

    def _is_time_sleep(self, node: ast.Call, mod) -> bool:
        name = dotted(node.func)
        if not name:
            return False
        canon = mod.expand(name) if mod else name
        if canon != "time.sleep" and name != "time.sleep" and \
                not (mod is None and name == "sleep"):
            return False
        # a Backoff-derived delay is the sanctioned spelling
        return not any(
            isinstance(n, ast.Call) and
            dotted(n.func).split(".")[-1] == "next_delay"
            for a in node.args for n in ast.walk(a))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _error_scope(ctx.rel) or \
                ctx.rel.endswith("common/backoff.py"):
            return
        mod = ctx.module()
        parents = ctx.parents()

        def inside(node: ast.AST, kinds) -> ast.AST | None:
            cur = parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Module)):
                if isinstance(cur, kinds):
                    return cur
                cur = parents.get(cur)
            return None

        flagged: set[ast.AST] = set()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and
                    self._is_time_sleep(node, mod)):
                continue
            loop = inside(node, (ast.For, ast.AsyncFor, ast.While))
            if loop is None:
                continue
            # (a) sleep inside an except handler inside the loop
            handler = inside(node, ast.ExceptHandler)
            if handler is not None and node not in flagged:
                flagged.add(node)
                yield ctx.finding(
                    self.id, node,
                    f"catch-sleep-retry loop paced by raw "
                    f"time.sleep — use common.backoff.Backoff "
                    f"(capped exponential, jittered, "
                    f"clock-injectable) and .reset() on success")
                continue
            # (b) sleep(delay) where the loop multiplies delay itself
            arg = node.args[0] if node.args else None
            if not isinstance(arg, ast.Name):
                continue
            grows = any(
                (isinstance(n, ast.AugAssign) and
                 isinstance(n.target, ast.Name) and
                 n.target.id == arg.id and
                 isinstance(n.op, (ast.Mult, ast.Pow))) or
                (isinstance(n, ast.Assign) and
                 any(isinstance(t, ast.Name) and t.id == arg.id
                     for t in n.targets) and
                 any(isinstance(b, ast.BinOp) and
                     isinstance(b.op, (ast.Mult, ast.Pow))
                     for b in ast.walk(n.value)))
                for n in _loop_body_nodes(loop)
                if isinstance(n, (ast.AugAssign, ast.Assign)))
            if grows and node not in flagged:
                flagged.add(node)
                yield ctx.finding(
                    self.id, node,
                    f"hand-rolled exponential delay ({arg.id!r} "
                    f"multiplied in-loop) — common.backoff.Backoff "
                    f"already does capped full-jitter pacing; "
                    f"hand-rolled math forgets the cap or the jitter")


#: the port's three device-contract rules, then the reference's twelve
#: others in the reference's order.  The reference's jax-timing,
#: jit-static, jit-retrace-churn and tracer-leak check JAX tracing: the
#: port's counterparts are cuda-timing and devguard's runtime
#: recompile count
ALL_RULES = [CudaTimingRule, HostSyncHotPathRule, ImplicitTransferRule,
             RawLockRule, WireSchemaRule, UnregisteredMessageRule,
             TxnAtomicityRule, SilentThreadRule, BareExceptRule,
             GuardedByRule, BlockingInDispatchRule,
             SwallowedErrorRule, ErrnoConflationRule,
             ReplyOnAllPathsRule, BareRetryRule]
