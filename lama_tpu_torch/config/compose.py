"""Hydra-style config composition: a named preset YAML with a `defaults:`
list of group entries composed from `configs/<context>/<group>/<name>.yaml`,
`# @package` headers, `${...}` interpolation and `a.b.c=value` overrides.

A copy of lama_tpu/config/compose.py, so the port imports nothing of
lama_tpu.
"""
import copy
import os
import re
from typing import Dict, List, Optional, Sequence

import yaml

from .node import ConfigNode, merge, resolve_interpolations, to_dict, _parse_scalar

_PACKAGE_RE = re.compile(r'^#\s*@package\s+(\S+)', re.MULTILINE)


def load_yaml(path: str) -> ConfigNode:
    with open(path) as f:
        text = f.read()
    data = yaml.safe_load(text) or {}
    node = ConfigNode(data)
    m = _PACKAGE_RE.search(text)
    node.__dict__['_package'] = m.group(1) if m else None
    return node


class _Delete:
    """Sentinel for hydra's `~key` deletion overrides."""


DELETE = _Delete()


def parse_overrides(overrides: Sequence[str]) -> Dict[str, object]:
    result = {}

    def put(k, v):
        if k in result and (v is DELETE) != (result[k] is DELETE):
            raise ValueError(
                f'Conflicting overrides for {k!r}: both a ~{k} deletion and '
                f'a {k}=value assignment were given')
        result[k] = v

    for ov in overrides:
        if ov.startswith('~'):  # hydra deletion: ~a.b.c
            put(ov[1:].split('=', 1)[0], DELETE)
            continue
        if '=' not in ov:
            raise ValueError(f'Override must look like key=value: {ov}')
        k, v = ov.split('=', 1)
        if k.startswith('+'):  # hydra append: +a.b.c=value (set_path creates)
            k = k[1:]
        if v.startswith('[') or v.startswith('{'):
            put(k, yaml.safe_load(v))
        else:
            put(k, _parse_scalar(v))
    return result


def with_overrides(defaults: Dict, overrides: Sequence[str] = ()) -> ConfigNode:
    """A CLI's config without a YAML: a copy of `defaults` with the
    `a.b.c=value` overrides set (bin/to_stablehlo.py's ConfigNode and
    set_path)."""
    result = ConfigNode(copy.deepcopy(defaults))
    for k, v in parse_overrides(overrides).items():
        result.set_path(k, v)
    return result


def compose(config_dir: str, config_name: str,
            overrides: Sequence[str] = ()) -> ConfigNode:
    """Compose configs/<config_dir>/<config_name>.yaml with its defaults list
    plus CLI overrides."""
    if not config_name.endswith('.yaml'):
        config_name += '.yaml'
    preset_path = os.path.join(config_dir, config_name)
    preset = load_yaml(preset_path)

    parsed = parse_overrides(overrides)
    group_swaps = {k: v for k, v in parsed.items()
                   if '.' not in k and isinstance(v, str)
                   and os.path.isdir(os.path.join(config_dir, k))}
    value_overrides = {k: v for k, v in parsed.items() if k not in group_swaps}

    result = ConfigNode()
    defaults = preset.pop('defaults', [])
    for entry in defaults:
        if isinstance(entry, str):
            if entry == '_self_':
                merge(result, preset)
                continue
            group, name = entry, None
        else:
            (group, name), = entry.items()
        name = group_swaps.get(group, name)
        if name is None:
            continue
        group_file = os.path.join(config_dir, group, f'{name}.yaml')
        node = load_yaml(group_file)
        pkg = node.__dict__.get('_package')
        if pkg in ('_group_', None):
            target = ConfigNode({group: node}) if pkg == '_group_' else node
        elif pkg == '_global_':
            target = node
        else:
            target = ConfigNode()
            target.set_path(pkg.replace('/', '.'), node)
        merge(result, target)

    # the preset itself wins over its defaults (hydra 1.1 behaviour)
    merge(result, preset)

    for k, v in value_overrides.items():
        if v is DELETE:
            parent = result.select('.'.join(k.split('.')[:-1])) \
                if '.' in k else result
            leaf = k.split('.')[-1]
            if not isinstance(parent, dict) or leaf not in parent:
                raise ValueError(f'Cannot delete missing config key: {k}')
            del parent[leaf]
        else:
            result.set_path(k, v)

    resolve_interpolations(result)
    return result


def save_config(config: ConfigNode, path: str):
    with open(path, 'w') as f:
        yaml.safe_dump(to_dict(config), f, sort_keys=False)
