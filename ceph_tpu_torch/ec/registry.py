"""Erasure-code plugin registry of the port.

Python analogue of Ceph's singleton dlopen-based ErasureCodePluginRegistry
(ref: src/erasure-code/ErasureCodePlugin.cc:92 factory, :126 load,
:186 preload).  Plugins are Python classes registered by name, directly
or lazily via a module path (the analogue of deferred dlopen).

The port registers the reference's plugin names (jerasure, isa, tpu, lrc,
shec, clay), each loaded from `ceph_tpu_torch.ec.plugins.<name>`, so
profiles carry over unchanged.  `factory` takes the device the plugin's
kernels run on (None means "cuda"); lrc and clay build their sub-codes
through the registry on their own device.
"""
from __future__ import annotations

import importlib
from typing import Callable

from ..common.lockdep import make_lock
from .interface import ErasureCodeInterface, ErasureCodeProfile, ErasureCodeError


class ErasureCodePlugin:
    """A named plugin: a factory making ErasureCodeInterface instances
    (ref: ErasureCodePlugin.h ErasureCodePlugin::factory)."""

    def __init__(self, name: str, factory: Callable[..., ErasureCodeInterface]):
        self.name = name
        self._factory = factory

    def factory(self, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        ec = self._factory(device=device)
        ec.init(profile)
        return ec


class ErasureCodePluginRegistry:
    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = make_lock("ec.registry.instance")

    def __init__(self) -> None:
        self._lock = make_lock("ec.registry")
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self._lazy: dict[str, tuple[str, str]] = {}  # name -> (module, attr)

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
                # analogue of the osd_erasure_code_plugins preload list
                for name in ("jerasure", "isa", "tpu", "lrc", "shec",
                             "clay"):
                    cls._instance._lazy[name] = (
                        f"ceph_tpu_torch.ec.plugins.{name}", "PLUGIN")
        return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ErasureCodeError(f"plugin {name} already registered (-EEXIST)")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def load(self, name: str) -> ErasureCodePlugin:
        """Analogue of dlopen + __erasure_code_init
        (ref: ErasureCodePlugin.cc:126)."""
        with self._lock:
            if name in self._plugins:
                return self._plugins[name]
            if name not in self._lazy:
                raise ErasureCodeError(f"ENOENT: no erasure-code plugin {name!r}")
            module_name, attr = self._lazy[name]
            try:
                mod = importlib.import_module(module_name)
            except ImportError as e:
                raise ErasureCodeError(f"EIO: loading plugin {name}: {e}") from e
            plugin = getattr(mod, attr, None)
            if not isinstance(plugin, ErasureCodePlugin):
                raise ErasureCodeError(
                    f"EXDEV: plugin {name} has no entry point {attr}")
            self._plugins[name] = plugin
            return plugin

    def factory(self, plugin_name: str, profile: ErasureCodeProfile,
                device=None) -> ErasureCodeInterface:
        """Load (if needed) and instantiate
        (ref: ErasureCodePlugin.cc:92 factory)."""
        return self.load(plugin_name).factory(dict(profile), device)

    def preload(self, plugins: list[str]) -> None:
        for name in plugins:
            self.load(name)


def factory(plugin_name: str, profile: ErasureCodeProfile,
            device=None) -> ErasureCodeInterface:
    """Module-level convenience matching ErasureCodePluginRegistry::factory."""
    return ErasureCodePluginRegistry.instance().factory(
        plugin_name, profile, device)
