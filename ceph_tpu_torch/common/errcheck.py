"""errcheck: runtime error-path coverage sanitizer — "which except
handlers have ever actually run?"

The static half (ceph_tpu_torch/analysis) judges how handlers are
WRITTEN; this module measures which handlers ever FIRE.  A handler that
no test, chaos schedule or EIO-injection run has ever entered is dead
code until a fault finally reaches it in production.

Armed by ``CEPH_TPU_ERRCHECK=1`` (the ``errcheck`` config option):

* ``enable()`` installs a meta-path import hook in FRONT of the normal
  machinery.  Imports of instrumented packages (default:
  ceph_tpu_torch) recompile from source — bytecode caches are
  bypassed, never written — with one extra statement at the top of
  every ``except`` handler body::

      except RadosError as ex:
          __errcheck_hit__("ceph_tpu_torch.osd.ec_backend", 1184)
          ...original body...

  The bump records (module, handler line, concrete exception type from
  ``sys.exc_info()``) -> count.  Nothing else about the module changes:
  same names, same control flow, same tracebacks (the inserted call
  carries the handler's own location).

* ``coverage_report()`` merges the fired counters with a static census
  of EVERY handler in the tree (an AST walk — the denominator exists
  whether or not a module was ever imported) into per-module
  fired/total ratios plus the never-fired list.

* Subprocess daemons (tools/daemon_main) arm from the same env and, if
  ``CEPH_TPU_ERRCHECK_DIR`` names a directory, dump their counters
  there at exit (one ``errcheck-<pid>.json`` each) for the parent to
  ``merge_dir()`` — multi-process runs count like threaded ones.

When the option is off nothing is installed: imports go through the
pristine machinery, modules carry no ``__errcheck_hit__``, and there
is zero overhead.  The import hook is the no-dependency way to see
every handler entry without tracing.

The port's copy of `ceph_tpu.common.errcheck`, whole.  Its finder
matches on the top-level package name, as the reference's does, so the
two hooks can sit in one process's ``sys.meta_path``: this one claims
``ceph_tpu_torch`` (and any probe package it is widened to), the
reference's ``ceph_tpu``; neither instruments the other's modules or
itself.
"""
from __future__ import annotations

import ast
import atexit
import importlib.abc
import importlib.machinery
import json
import os
import sys

__all__ = ["enable", "disable", "enabled", "enable_if_configured",
           "counters", "reset", "dump", "merge_dir", "handler_census",
           "coverage_report", "HIT_NAME"]

#: the global injected into instrumented modules (dunder: invisible to
#: `from mod import *`, unmistakable in tracebacks)
HIT_NAME = "__errcheck_hit__"

_enabled = False
_finder: "_Finder | None" = None
#: (module, handler lineno, exception type name) -> fired count.
#: Deliberately lock-free: _hit runs inside HOT handlers (store ENOENT
#: probes, backoff loops) and a lock round-trip per fire measurably
#: slowed tier-1.  Under the GIL each dict op is atomic; a racing
#: read-modify-write can drop an increment, which coverage does not
#: care about — fired-vs-never only needs the first count to land, and
#: a key insert cannot be lost.
_counters: dict[tuple[str, int, str], int] = {}


def _hit(module: str, line: int) -> None:
    """The counter bump compiled into every instrumented handler.
    Must never raise and never touch the live exception beyond
    reading its type."""
    etype = sys.exc_info()[0]
    name = etype.__name__ if etype is not None else "<reraise>"
    key = (module, line, name)
    try:
        _counters[key] += 1
    except KeyError:
        _counters[key] = 1


# ------------------------------------------------------- AST transform

def _instrument_tree(tree: ast.Module, module: str) -> None:
    """Insert ``__errcheck_hit__(module, lineno)`` as the first
    statement of every except-handler body, in place."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        bump = ast.Expr(value=ast.Call(
            func=ast.Name(id=HIT_NAME, ctx=ast.Load()),
            args=[ast.Constant(value=module),
                  ast.Constant(value=node.lineno)],
            keywords=[]))
        # the bump wears the handler's own location so tracebacks and
        # coverage of the ORIGINAL first statement are undisturbed
        ast.copy_location(bump, node.body[0])
        for sub in ast.walk(bump):
            ast.copy_location(sub, node.body[0])
        node.body.insert(0, bump)
    ast.fix_missing_locations(tree)


class _Loader(importlib.machinery.SourceFileLoader):
    """SourceFileLoader that compiles an instrumented AST.  Bytecode
    caches are bypassed both ways: get_code always recompiles from
    source (a stale pristine .pyc must not shadow the instrumented
    build) and set_data never writes (an instrumented .pyc must not
    leak into later UNinstrumented runs)."""

    def get_code(self, fullname):
        path = self.get_filename(fullname)
        return self.source_to_code(self.get_data(path), path)

    def set_data(self, path, data, *, _mode=0o666):
        return None

    def source_to_code(self, data, path, *, _optimize=-1):
        try:
            tree = ast.parse(data)
            _instrument_tree(tree, self.name)
            return compile(tree, path, "exec", dont_inherit=True,
                           optimize=_optimize)
        except SyntaxError:
            # the sanitizer must not change WHAT imports: let the
            # pristine compiler raise the module's own SyntaxError
            return super().source_to_code(data, path,
                                          _optimize=_optimize)

    def exec_module(self, module):
        # seed the hook BEFORE the module body runs: module-level
        # handlers (import fallbacks!) fire during exec
        module.__dict__[HIT_NAME] = _hit
        super().exec_module(module)


class _Finder(importlib.abc.MetaPathFinder):
    """Front-of-meta_path finder: claims source modules under the
    instrumented top-level packages, delegates the actual file search
    to the stock PathFinder, swaps in the instrumenting loader."""

    def __init__(self, prefixes: set[str]):
        self.prefixes = set(prefixes)

    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".", 1)[0] not in self.prefixes:
            return None
        if fullname == __name__:
            return None     # never instrument the sanitizer itself
        spec = importlib.machinery.PathFinder.find_spec(fullname, path)
        if spec is None or spec.origin is None \
                or not spec.origin.endswith(".py") \
                or not isinstance(spec.loader,
                                  importlib.machinery.SourceFileLoader):
            return None     # extensions/namespaces: stock machinery
        spec.loader = _Loader(fullname, spec.origin)
        return spec


# ----------------------------------------------------------- lifecycle

def enabled() -> bool:
    return _enabled


def enable(prefixes=("ceph_tpu_torch",)) -> None:
    """Install the import hook for `prefixes` (top-level package
    names).  Idempotent; a second call widens the prefix set of the
    live finder.  Arm BEFORE importing the modules you want counted —
    already-imported modules stay uninstrumented (they still appear
    in the census denominator)."""
    global _enabled, _finder
    tops = {p.split(".", 1)[0] for p in prefixes}
    if _enabled and _finder is not None:
        _finder.prefixes |= tops
        return
    _finder = _Finder(tops)
    sys.meta_path.insert(0, _finder)
    _enabled = True
    d = os.environ.get("CEPH_TPU_ERRCHECK_DIR")
    if d:
        atexit.register(
            dump, os.path.join(d, f"errcheck-{os.getpid()}.json"))


def disable() -> None:
    """Remove the hook (tests only).  Modules already imported stay
    instrumented — their `__errcheck_hit__` keeps counting."""
    global _enabled, _finder
    if not _enabled:
        return
    if _finder is not None and _finder in sys.meta_path:
        sys.meta_path.remove(_finder)
    _finder = None
    _enabled = False


def enable_if_configured() -> bool:
    """Arm when the `errcheck` option (env ``CEPH_TPU_ERRCHECK``) is
    on — the daemon_main/smoke entry point.  One parser for the
    option, same as lockdep/racecheck: off/0/false/no all disable."""
    from . import options
    # before the process's global config is built, read the option
    # through a fresh Config (the same env layer and parser): building
    # the global one installs the log_level observer, which imports
    # common.log and lockdep before the hook could instrument them
    cfg = options._global_config
    if (cfg if cfg is not None else options.Config())["errcheck"]:
        enable()
    return _enabled


def reset() -> None:
    """Drop accumulated counters (tests)."""
    _counters.clear()


def counters() -> dict[tuple[str, int, str], int]:
    """Snapshot of (module, handler line, exception type) -> count
    (dict(d) copies at C level in one GIL slice — safe against
    concurrent _hit inserts)."""
    return dict(_counters)


# ------------------------------------------- subprocess counter merging

def dump(path: str) -> None:
    """Write this process's counters as JSON (atexit target for
    daemon subprocesses when CEPH_TPU_ERRCHECK_DIR is set)."""
    snap = counters()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({f"{m}\x00{ln}\x00{exc}": n
                       for (m, ln, exc), n in snap.items()}, f)
    except OSError:
        pass    # a failed coverage dump must never fail the daemon


def merge_dir(dirpath: str) -> dict[tuple[str, int, str], int]:
    """This process's counters + every errcheck-*.json dump under
    `dirpath` (daemon subprocesses), summed."""
    merged = counters()
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("errcheck-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dirpath, name)) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            continue
        for k, n in raw.items():
            try:
                m, ln, exc = k.split("\x00")
                key = (m, int(ln), exc)
            except ValueError:
                continue
            merged[key] = merged.get(key, 0) + int(n)
    return merged


# ------------------------------------------------------ coverage report

def _catch_desc(handler: ast.ExceptHandler) -> str:
    """Human label for what a handler catches, from its source."""
    if handler.type is None:
        return "<bare>"
    try:
        return ast.unparse(handler.type)
    except Exception:
        return "<?>"


def handler_census(package_dir: str, package: str = "ceph_tpu_torch"
                   ) -> list[tuple[str, int, str]]:
    """Every except handler in the tree as (module, lineno, catches) —
    the static denominator.  Walks source, not sys.modules, so
    never-imported modules count too."""
    out: list[tuple[str, int, str]] = []
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, package_dir)
            mod = package + "." + rel[:-3].replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[:-len(".__init__")]
            if mod == __name__:
                continue    # the sanitizer is never instrumented
            try:
                with open(path, "rb") as f:
                    tree = ast.parse(f.read())
            except (OSError, SyntaxError):
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.ExceptHandler):
                    out.append((mod, node.lineno, _catch_desc(node)))
    return out


def coverage_report(package_dir: str,
                    package: str = "ceph_tpu_torch",
                    fired: dict | None = None) -> dict:
    """Per-module fired/total handler ratios plus the never-fired
    list.  `fired` defaults to this process's live
    counters; pass merge_dir(...) output for multi-process runs."""
    if fired is None:
        fired = counters()
    fired_sites = {(m, ln) for (m, ln, _exc) in fired if fired[
        (m, ln, _exc)] > 0}
    census = handler_census(package_dir, package)
    mods: dict[str, dict] = {}
    never: list[dict] = []
    for mod, line, catches in census:
        st = mods.setdefault(mod, {"handlers": 0, "fired": 0})
        st["handlers"] += 1
        if (mod, line) in fired_sites:
            st["fired"] += 1
        else:
            never.append({"module": mod, "line": line,
                          "catches": catches})
    for st in mods.values():
        st["ratio"] = round(st["fired"] / st["handlers"], 4) \
            if st["handlers"] else 1.0
    total = len(census)
    nfired = total - len(never)
    return {
        "package": package,
        "handlers_total": total,
        "handlers_fired": nfired,
        "ratio": round(nfired / total, 4) if total else 1.0,
        "never_fired_count": len(never),
        "modules": {m: mods[m] for m in sorted(mods)},
        "never_fired": sorted(
            never, key=lambda d: (d["module"], d["line"])),
    }
