"""cephck rules of the port: the device contract on the CUDA path.

Each rule is small: an ``id``, a ``doc`` a finder can read, and
``check(ctx)`` yielding findings over one parsed file.  Every rule has a
red and a green snippet in tests/test_torch_analysis.py.

A *kernel wrapper* is a function that counts a launch
(``LAUNCHES[...] += 1``, where the port's CUDA wrappers launch their
kernels) or a function named ``*_cuda``; the rules reach them through
the project call graph.

The port's copies of three rules of `ceph_tpu.analysis.rules`:
`JaxTimingRule` (:407) as ``cuda-timing``, `HostSyncHotPathRule`
(:700) as ``host-sync-hot-path`` and `ImplicitTransferRule` (:1037) as
``implicit-transfer``.
"""
from __future__ import annotations

import ast
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


ALL_RULES = [CudaTimingRule, HostSyncHotPathRule, ImplicitTransferRule]
