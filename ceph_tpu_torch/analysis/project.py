"""Project-wide context: symbol table, import aliases and call graph.

Per-file AST matching cannot see that a loop in osd/ec_backend.py calls
a helper in ec/kernels/bitmatmul.py that syncs with the card, or that a
timed region in chip_smoke.py calls a function that launches a kernel
two modules away.  ProjectContext is built once over every scanned file
and handed to the rules beside each FileContext.  It carries

* a module table (repo-relative path -> dotted module name -> AST);
* per-module import aliases expanded to canonical dotted names
  (``np.asarray`` -> ``numpy.asarray``), imports inside functions
  included;
* a symbol table of every module-level function and method;
* the launchers: every function that adds to a kernel's launch count
  (``LAUNCHES[...] += 1``), which is where the port's CUDA wrappers
  launch their kernels and nowhere else;
* a best-effort call graph over project-internal calls (plain names,
  imported symbols, module attributes, ``self.method``).

The port's copy of `ceph_tpu.analysis.project`, with the launchers in
place of the jit registry.  Resolution stays conservative: a name the
table cannot pin resolves to None, and rules stay silent about it.
"""
from __future__ import annotations

import ast
from typing import Iterator


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target: ``time.perf_counter``,
    ``self._loop``; empty for dynamic targets."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""


def module_name(rel: str) -> str:
    """Dotted module name for a repo-relative path
    (``ceph_tpu_torch/ec/gf.py`` -> ``ceph_tpu_torch.ec.gf``)."""
    parts = rel.split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p) or "<module>"


def counts_a_launch(fn: ast.AST) -> bool:
    """True when `fn`'s own body adds to a ``LAUNCHES[...]`` count."""
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Subscript) and \
                dotted(node.target.value).split(".")[-1] == "LAUNCHES":
            return True
    return False


class ModuleInfo:
    """One scanned module's symbols, import aliases and launchers."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.name = module_name(rel)
        self.tree = tree
        #: local alias -> canonical dotted prefix ("np" -> "numpy")
        self.imports: dict[str, str] = {}
        #: qualname ("f", "Cls.meth") -> def node
        self.functions: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
        #: qualnames of the functions that count a kernel launch
        self.launchers: set[str] = set()
        self._collect()

    def expand(self, name: str) -> str:
        """Canonical dotted name for a local spelling: resolves the
        first component through the import table; unknown heads pass
        through unchanged."""
        if not name:
            return name
        head, _, rest = name.partition(".")
        target = self.imports.get(head)
        if target is None:
            return name
        return f"{target}.{rest}" if rest else target

    def imports_module(self, prefix: str) -> bool:
        return any(v == prefix or v.startswith(prefix + ".")
                   for v in self.imports.values())

    def _collect(self) -> None:
        pkg = self.name.split(".")[:-1]
        if self.rel.endswith("__init__.py"):
            pkg = self.name.split(".")
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        self.imports.setdefault(head, head)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    up = pkg[:len(pkg) - (node.level - 1)] \
                        if node.level <= len(pkg) + 1 else []
                    base = ".".join(up + ([node.module]
                                          if node.module else []))
                else:
                    base = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{base}.{a.name}" if base else a.name
                    self.imports[a.asname or a.name] = full
        for node in self.tree.body:
            self._collect_stmt(node, prefix="")

    def _collect_stmt(self, node: ast.stmt, prefix: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{prefix}{node.name}"
            self.functions[qual] = node
            if counts_a_launch(node):
                self.launchers.add(qual)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                self._collect_stmt(item, prefix=f"{node.name}.")


class ProjectContext:
    """The cross-module pass: module and symbol tables plus the call
    graph over every file of one engine run."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}     # dotted name ->
        self.by_rel: dict[str, ModuleInfo] = {}
        #: (modname, qualname) -> {(modname, qualname), ...}
        self.call_graph: dict[tuple[str, str],
                              set[tuple[str, str]]] = {}
        #: reverse: callee -> {caller, ...} (built by finalize)
        self.callers: dict[tuple[str, str],
                           set[tuple[str, str]]] = {}
        self._finalized = False

    def add(self, rel: str, tree: ast.Module) -> ModuleInfo:
        mod = ModuleInfo(rel, tree)
        self.modules[mod.name] = mod
        self.by_rel[rel] = mod
        self._finalized = False
        return mod

    def module_for(self, rel: str) -> ModuleInfo | None:
        return self.by_rel.get(rel)

    def resolve(self, mod: ModuleInfo, name: str,
                caller_qual: str = "") -> tuple[ModuleInfo, str] | None:
        """Resolve a call-target spelling in `mod` to a (module,
        qualname) the project owns; None for externals and dynamic
        targets."""
        if not name:
            return None
        if name.startswith("self.") and "." in caller_qual:
            qual = f"{caller_qual.split('.')[0]}.{name[5:]}"
            return (mod, qual) if qual in mod.functions else None
        if name in mod.functions:
            return mod, name
        parts = mod.expand(name).split(".")
        # the longest module prefix the project owns; the rest is the
        # qualname inside it
        for cut in range(len(parts) - 1, 0, -1):
            owner = self.modules.get(".".join(parts[:cut]))
            if owner is not None:
                qual = ".".join(parts[cut:])
                return (owner, qual) if qual in owner.functions else None
        return None

    def finalize(self) -> None:
        """Build the project call graph (idempotent)."""
        if self._finalized:
            return
        self.call_graph = {}
        for mod in self.modules.values():
            for qual, fn in mod.functions.items():
                edges = self.call_graph.setdefault((mod.name, qual), set())
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        target = self.resolve(mod, dotted(node.func), qual)
                        if target is not None:
                            edges.add((target[0].name, target[1]))
        # reverse edges (callee -> callers): caller-walking rules
        # (guarded-by coverage) would otherwise rescan the whole graph
        # per hop
        self.callers = {}
        for src, dsts in self.call_graph.items():
            for dst in dsts:
                self.callers.setdefault(dst, set()).add(src)
        self._finalized = True

    def callees(self, mod: ModuleInfo, qual: str) -> set[tuple[str, str]]:
        self.finalize()
        return self.call_graph.get((mod.name, qual), set())

    def reachable(self, mod: ModuleInfo, qual: str,
                  max_depth: int = 3) -> Iterator[tuple[str, str]]:
        """(modname, qualname) pairs reachable from one function,
        breadth-first and depth-bounded."""
        self.finalize()
        seen: set[tuple[str, str]] = set()
        frontier = {(mod.name, qual)}
        for _ in range(max_depth):
            nxt: set[tuple[str, str]] = set()
            for node in frontier:
                for tgt in self.call_graph.get(node, ()):
                    if tgt not in seen:
                        seen.add(tgt)
                        nxt.add(tgt)
                        yield tgt
            if not nxt:
                return
            frontier = nxt

    def is_launcher(self, modname: str, qual: str) -> bool:
        m = self.modules.get(modname)
        return m is not None and qual in m.launchers

    def reaches_launch(self, mod: ModuleInfo, qual: str,
                       max_depth: int = 3) -> bool:
        """True when `qual` counts a launch itself or calls, within
        `max_depth` hops, a function that does."""
        if qual in mod.launchers:
            return True
        return any(self.is_launcher(*t)
                   for t in self.reachable(mod, qual, max_depth))
