"""Minimal OmegaConf-style config node: dict with attribute access, deep
merge, dotted-path get/set, and ${...} interpolation (incl. ${env:VAR}).

A copy of lama_tpu/config/node.py, so the port imports nothing of lama_tpu.
"""
import os
import re
from typing import Any, Dict, List, Optional

_INTERP_RE = re.compile(r'\$\{([^}]+)\}')


class ConfigNode(dict):
    """dict subclass with attribute access; nested dicts are wrapped."""

    def __init__(self, data: Optional[Dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, ConfigNode):
            v = ConfigNode(v)
        elif isinstance(v, list):
            v = [ConfigNode(e) if isinstance(e, dict) and not isinstance(e, ConfigNode)
                 else e for e in v]
        super().__setitem__(k, v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        del self[k]

    # ---------------------------------------------------------- dotted paths
    def select(self, path: str, default=None):
        node: Any = self
        for part in path.split('.'):
            if isinstance(node, ConfigNode) and part in node:
                node = node[part]
            elif isinstance(node, list) and part.isdigit() and int(part) < len(node):
                node = node[int(part)]
            else:
                return default
        return node

    def set_path(self, path: str, value):
        parts = path.split('.')
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = value


def to_dict(node) -> Any:
    if isinstance(node, ConfigNode):
        return {k: to_dict(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_dict(v) for v in node]
    return node


def merge(base: ConfigNode, override: Dict) -> ConfigNode:
    """Deep merge `override` into `base` (in place), OmegaConf semantics:
    dicts merge recursively, everything else replaces."""
    for k, v in override.items():
        if (k in base and isinstance(base[k], ConfigNode)
                and isinstance(v, dict)):
            merge(base[k], v)
        else:
            base[k] = v
    return base


def _parse_scalar(s: str):
    if not isinstance(s, str):
        return s
    low = s.lower()
    if low in ('true', 'false'):
        return low == 'true'
    if low in ('null', 'none', '~'):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def resolve_interpolations(root: ConfigNode, max_iters: int = 10) -> ConfigNode:
    """Resolve ${a.b.c} and ${env:VAR} references against the root, repeatedly
    until a fixed point (references may chain)."""

    def resolve_value(v):
        if isinstance(v, str):
            full = _INTERP_RE.fullmatch(v.strip())
            if full:
                return lookup(full.group(1), v)

            def sub(m):
                r = lookup(m.group(1), m.group(0))
                return str(r)
            return _INTERP_RE.sub(sub, v)
        return v

    def lookup(expr: str, original):
        expr = expr.strip()
        if expr.startswith('env:'):
            return os.environ.get(expr[4:], '')
        if expr.startswith('oc.env:'):
            return os.environ.get(expr[7:], '')
        val = root.select(expr, default=original)
        return val

    def walk(node):
        changed = False
        if isinstance(node, ConfigNode):
            for k, v in list(node.items()):
                if isinstance(v, (ConfigNode, list)):
                    changed |= walk(v)
                else:
                    nv = resolve_value(v)
                    if nv is not v and nv != v:
                        node[k] = nv
                        changed = True
        elif isinstance(node, list):
            for i, v in enumerate(node):
                if isinstance(v, (ConfigNode, list)):
                    changed |= walk(v)
                else:
                    nv = resolve_value(v)
                    if nv is not v and nv != v:
                        node[i] = nv
                        changed = True
        return changed

    for _ in range(max_iters):
        if not walk(root):
            break
    return root
