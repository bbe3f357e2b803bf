"""
Pickle interop with reference Sniffles2 SNF files.

SNF blocks are pickled object graphs; the pickle stream stores each
class as a (module, qualname) global reference. Reference Sniffles2
(reference: snf.py:116-119) unpickles with the stdlib loader, so the
only class paths it can resolve are its own ("sniffles.sv.SVCall", ...).
Our data-model classes mirror the reference's names and field layouts
one-to-one (svcall.py, leads.py, cluster.py, region.py); registering
them under the reference module paths makes every SNF this tool writes
directly loadable by reference Sniffles2 and by the JAX package
`sniffles_tpu` — the write-side counterpart of the read-side
_CompatUnpickler in io/snf.py.
A copy of sniffles_tpu/compat.py.

Both packages register the same alias names, so a process that imports
both resolves "sniffles.sv" to whichever registered first: compare the
two packages' outputs in separate processes.

Resolution of the "sniffles.*" alias names is provided by a meta-path
finder rather than one-shot sys.modules entries: pickling re-imports
the module named by a class's __module__ on every dump/load, and
embedding applications (or tests exercising the genuine reference
package) may purge "sniffles*" from sys.modules at any time. The finder
sits at the END of sys.meta_path, so a genuinely installed `sniffles`
package always wins; our reader does not depend on the alias either way
(_CompatUnpickler maps reference paths to our classes explicitly).
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys
import types

# reference module name -> our implementing module name
_ALIASES: dict[str, str] = {}


class _AliasLoader(importlib.abc.Loader):
    """Produces a fresh module object whose namespace is the implementing
    module's: attribute lookups (and pickle's save-side identity check,
    `getattr(sys.modules[m], name) is cls`) resolve to the very same
    class objects, while the implementing module itself keeps its own
    __name__/__spec__ untouched."""

    def __init__(self, impl_name: str, is_package: bool):
        self._impl_name = impl_name
        self._is_package = is_package

    def create_module(self, spec):
        mod = types.ModuleType(spec.name)
        if self._is_package:
            mod.__path__ = []
        return mod

    def exec_module(self, module):
        if self._impl_name:
            impl = importlib.import_module(self._impl_name)
            for k, v in impl.__dict__.items():
                if k not in ("__name__", "__spec__", "__loader__",
                             "__package__", "__path__", "__file__"):
                    module.__dict__.setdefault(k, v)


class _ReferenceAliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname == "sniffles" and _ALIASES:
            return importlib.util.spec_from_loader(
                fullname, _AliasLoader("", True), is_package=True)
        impl = _ALIASES.get(fullname)
        if impl is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, _AliasLoader(impl, False))


_FINDER = _ReferenceAliasFinder()


def alias_module_for_pickle(ref_name: str, module_name: str, classes) -> None:
    """Make `classes` of module `module_name` pickle as members of the
    reference module `ref_name` (e.g. "sniffles.sv"), resolvable through
    the alias finder for unpickling in-process."""
    for cls in classes:
        cls.__module__ = ref_name
    _ALIASES[ref_name] = module_name
    if _FINDER not in sys.meta_path:
        sys.meta_path.append(_FINDER)


# ---------------------------------------------------------------------------
# Pickle state application for slots dataclasses
# ---------------------------------------------------------------------------

_STATE_META_CACHE: dict[type, tuple] = {}


def _state_meta(cls) -> tuple:
    """Per-class pickle-state metadata: (frozenset of slot names,
    ((name, default, is_factory), ...) for every defaulted field,
    {name: bound slot-descriptor __set__}). Cached — this runs once per
    class, not per object (SNF combine deserializes 10^5-10^6 SVCall
    objects per run, so every per-object nanosecond here is wall-clock)."""
    cached = _STATE_META_CACHE.get(cls)
    if cached is None:
        import dataclasses
        defaults = tuple(
            (f.name, f.default_factory, True)
            if f.default_factory is not dataclasses.MISSING
            else (f.name, f.default, False)
            for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING
            or f.default_factory is not dataclasses.MISSING)
        # direct slot-descriptor setters skip the per-setattr type-dict
        # walk of object.__setattr__ (and double as the membership test)
        setters = {name: getattr(cls, name).__set__
                   for name in cls.__slots__}
        cached = (frozenset(cls.__slots__), defaults, setters)
        _STATE_META_CACHE[cls] = cached
    return cached


def _apply_pickle_state(obj, state) -> None:
    """__setstate__ body for slots dataclasses that must load both their
    own slots pickle form and dict-form states from the reference's
    plain dataclasses (SNF interop) or from pre-slots builds.

    Dict-form states may lack fields added since (-> dataclass default)
    and may carry stale cached-property entries (-> ignored).

    Later sources win (slots dict over instance dict over defaults), so
    each key is written once: slots-form states from this build's own
    SNF files skip the default pass entirely."""
    if isinstance(state, tuple):
        d, s = state
    else:
        d, s = state, None
    fields, defaults, setters = _state_meta(obj.__class__)
    sget = setters.get
    if not d:
        # fast path — the slots-form state this build's own pickles
        # produce (SNF combine deserializes 10^5-10^6 of these, so no
        # per-key bookkeeping here)
        for k, v in s.items():
            setter = sget(k)
            if setter is not None:
                setter(obj, v)
        for k, v, is_factory in defaults:
            if k not in s:
                sget(k)(obj, v() if is_factory else v)
        return
    applied = set()
    for src in (s, d):
        if src:
            for k, v in src.items():
                if k in fields and k not in applied:
                    sget(k)(obj, v)
                    applied.add(k)
    for k, v, is_factory in defaults:
        if k not in applied:
            sget(k)(obj, v() if is_factory else v)
