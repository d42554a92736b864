"""The port's rules: TCL001 and TCL002 with torch sinks, TCL006 over
``src/repro_torch``; TCL004 is ``tools.tclint.rules.check_int32_products``
under the port's config.

TCL001 reuses tclint's function-local taint fixpoint with torch seeds:
any ``torch.*`` call result (bar the host-side helpers below) and the
resident-store attributes. TCL002 is syntactic, with a small host-taint
pass for ``copy_`` sources.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from tools.tclint import Config, Violation, parse_pragmas
from tools.tclint.deadcode import (
    _identifiers_used,
    _module_graph,
    _non_import_identifiers,
    _public_defs,
)
from tools.tclint.rules import (
    _Taint,
    _attr_root,
    _func_name,
    _iter_scopes,
    _make_violation,
    _matches,
    _scope_nodes,
)

_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch.* calls whose results live on the host (no device value).
_HOST_TORCH_FUNCS = {
    "from_numpy", "device", "Size", "iinfo", "finfo", "is_tensor", "is_available",
    "current_stream", "get_device_name", "device_count", "Generator",
}
# Tensor methods and attributes that read metadata, not data.
_META_METHODS = {
    "numel", "nelement", "dim", "size", "element_size", "data_ptr", "is_contiguous",
    "stride", "storage_offset", "get_device",
}
_META_ATTRS = {"device", "is_cuda", "is_cpu", "layout"}


class _TorchTaint(_Taint):
    """tclint's taint fixpoint, seeded by ``torch.*`` results."""

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            return False
        if isinstance(node, ast.Compare):
            return any(self.is_tainted(x) for x in (node.left, *node.comparators))
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _META_METHODS:
                return False
            if _attr_root(fn) == "torch":
                return _func_name(node) not in _HOST_TORCH_FUNCS
        return super().is_tainted(node)


def check_host_sync(tree: ast.Module, path: str, source: str, config: Config) -> list[Violation]:
    """TCL001: a tensor read back to the host inside an execute-path module."""
    if not _matches(path, config.execute_modules):
        return []
    out: list[Violation] = []
    for qual, scope in _iter_scopes(tree):
        taint = _TorchTaint(scope, config)
        for node in _scope_nodes(scope):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            hit = None
            if (isinstance(fn, ast.Name) and fn.id in _SYNC_BUILTINS and node.args
                    and taint.is_tainted(node.args[0])):
                hit = f"{fn.id}() on a device value"
            elif isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS and taint.is_tainted(
                    fn.value):
                hit = f".{fn.attr}() on a device value"
            elif _func_name(node) == "synchronize":
                hit = "synchronize()"
            if hit:
                out.append(_make_violation(
                    "TCL001", node, path, source, qual,
                    f"implicit host sync: {hit} — route the readback through a "
                    f"CountFuture close or mark '# tclint: sync-ok(<reason>)'",
                ))
    return out


class _HostTaint(_Taint):
    """Values that live in host memory: NumPy results, ``torch.from_numpy``
    and ``torch.tensor``/``as_tensor`` without a device, and what is derived
    from them."""

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            root, name = _attr_root(node.func), _func_name(node)
            if root == "np":
                return True
            if root == "torch":
                return name == "from_numpy" or (
                    name in ("tensor", "as_tensor")
                    and not any(kw.arg == "device" for kw in node.keywords))
            if isinstance(node.func, ast.Attribute):
                return self.is_tainted(node.func.value)
            return False
        return super().is_tainted(node)


def _names_a_device(node: ast.AST) -> bool:
    """A ``.to()`` argument that names a device rather than a dtype."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Call):
        return _func_name(node) == "device"
    ident = node.id if isinstance(node, ast.Name) else (
        node.attr if isinstance(node, ast.Attribute) else "")
    return "dev" in ident.lower()


def _transfer_kind(node: ast.Call, host: _HostTaint) -> str | None:
    fn = node.func
    name = _func_name(node)
    kwargs = {kw.arg for kw in node.keywords}
    if any(kw.arg == "pin_memory" and not (isinstance(kw.value, ast.Constant)
                                           and kw.value.value is False)
           for kw in node.keywords):
        return "pin_memory="
    if not isinstance(fn, ast.Attribute):
        return None
    if name == "to" and ("device" in kwargs or (node.args and _names_a_device(node.args[0]))):
        return ".to(<device>)"
    if name in ("cuda", "pin_memory"):
        return f".{name}()"
    if name == "copy_" and node.args and host.is_tainted(node.args[0]):
        return ".copy_() from the host"
    if name in ("tensor", "as_tensor") and _attr_root(fn) == "torch" and "device" in kwargs:
        return f"torch.{name}(device=)"
    return None


def check_transfers(tree: ast.Module, path: str, source: str, config: Config) -> list[Violation]:
    """TCL002: a host->device copy outside the staging module."""
    if _matches(path, config.transfer_modules):
        return []
    host_config = dataclasses.replace(config, device_attrs=())
    out: list[Violation] = []
    for qual, scope in _iter_scopes(tree):
        host = _HostTaint(scope, host_config)
        for node in _scope_nodes(scope):
            kind = _transfer_kind(node, host) if isinstance(node, ast.Call) else None
            if kind:
                out.append(_make_violation(
                    "TCL002", node, path, source, qual,
                    f"unsanctioned transfer: {kind} outside the staging module — "
                    f"stage through repro_torch.runtime.staging.stage, or mark "
                    f"'# tclint: transfer-ok(<reason>)'",
                ))
    return out


def _usage_files(root: Path, patterns) -> list[Path]:
    files: set[Path] = set()
    for pattern in patterns:
        files.update(f for f in root.glob(pattern) if "__pycache__" not in f.parts)
    return sorted(files)


def find_dead_exports(root: Path, config: Config) -> tuple[list[Violation], int]:
    """TCL006 over ``config.export_root``: tclint's mark-and-sweep, with
    ``config.usage_roots`` read as glob patterns under ``root`` (so a
    single script such as ``chip_smoke.py`` can be a usage root).
    Returns ``(violations, pragma_suppressed_count)``."""
    export_root = root / config.export_root
    if not export_root.is_dir():
        return [], 0
    modules: dict[Path, ast.Module] = {}
    sources: dict[Path, str] = {}
    for f in _usage_files(root, config.usage_roots):
        try:
            sources[f] = f.read_text()
            modules[f] = ast.parse(sources[f], filename=str(f))
        except (SyntaxError, UnicodeDecodeError):
            sources.pop(f, None)
    usage = {f: _identifiers_used(t) for f, t in modules.items()}

    violations: list[Violation] = []
    suppressed = 0
    for f, tree in modules.items():
        if not f.is_relative_to(export_root):
            continue
        pragmas = parse_pragmas(sources[f])
        pkg_init = f.parent / "__init__.py"

        def externally_used(name: str) -> bool:
            for other, idents in usage.items():
                if other == f or name not in idents:
                    continue
                # A package __init__'s re-export alone is not a use.
                if other != pkg_init or name in _non_import_identifiers(modules[other]):
                    return True
            return False

        defs, refs, loose = _module_graph(tree)
        live = {n for n in defs if externally_used(n)}
        pending = set(loose).union(*(refs.get(n, set()) for n in live))
        while pending:
            name = pending.pop()
            if name in defs and name not in live:
                live.add(name)
                pending |= refs.get(name, set())
        for name, node in _public_defs(tree).items():
            if name in live:
                continue
            span = range(node.lineno - 1, (node.end_lineno or node.lineno) + 1)
            if any("TCL006" in pragmas.get(ln, ()) for ln in span):
                suppressed += 1
                continue
            violations.append(Violation(
                rule="TCL006", path=f.relative_to(root).as_posix(), line=node.lineno,
                col=node.col_offset, scope="<module>",
                message=(f"dead export: '{name}' is public but unreachable from any use "
                         f"in the port, its tests, tools or chip_smoke.py — delete it (or "
                         f"mark '# tclint: export-ok(<reason>)')"),
                snippet=f"def-or-assign {name}", end_line=node.lineno,
            ))
    return violations, suppressed
