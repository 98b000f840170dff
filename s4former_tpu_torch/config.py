"""mmcv-style python-dict config system (the port's own copy of
``s4former_tpu/config.py``; it imports nothing of the JAX package).

Preserves the reference's config-driven public API (reference:
configs/setr/*.py use ``_base_`` composition, ``_delete_=True`` semantics and
CLI ``--cfg-options`` deep-merge; see tools/train.py:77-86,119-121). The
implementation is from scratch: config files are plain python files executed
in an isolated namespace; every module-level variable becomes a config key.
"""
from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import sys
import tempfile
import types
from typing import Any, Dict, List, Optional, Union

BASE_KEY = '_base_'
DELETE_KEY = '_delete_'
RESERVED_KEYS = ('filename',)


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            wrapped = [ConfigDict._wrap(v) for v in value]
            return type(value)(wrapped)
        return value

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            for k, v in dict(arg).items():
                self[k] = ConfigDict._wrap(v)
        for k, v in kwargs.items():
            self[k] = ConfigDict._wrap(v)


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    if not filename.endswith('.py'):
        raise ValueError('only .py config files are supported')
    # Validate syntax early with a clear error.
    with open(filename, encoding='utf-8') as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f'config file {filename} has a syntax error: {e}')
    module_name = f'_s4cfg_{abs(hash(filename))}'
    mod = types.ModuleType(module_name)
    mod.__file__ = filename
    sys.modules[module_name] = mod
    try:
        exec(compile(content, filename, 'exec'), mod.__dict__)
        cfg = {
            k: v
            for k, v in mod.__dict__.items()
            if not k.startswith('__') and not isinstance(v, types.ModuleType)
            and not isinstance(v, types.FunctionType) and not isinstance(v, type)
        }
    finally:
        sys.modules.pop(module_name, None)
    return cfg


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Deep merge ``override`` into ``base`` (override wins).

    A dict with ``_delete_=True`` replaces the base value entirely instead of
    merging (reference semantics: segformer config ``_delete_=True``).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.pop(DELETE_KEY, False):
            out[k] = copy.deepcopy(v)
        elif (k in out and isinstance(out[k], dict) and isinstance(v, dict)):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Config:
    """A loaded config; ``cfg.key`` and ``cfg['key']`` both work."""

    def __init__(self, cfg_dict: Optional[Dict] = None,
                 filename: Optional[str] = None):
        object.__setattr__(self, '_cfg_dict', ConfigDict(cfg_dict or {}))
        object.__setattr__(self, '_filename', filename)

    # ---------------------------------------------------------- loading
    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict = Config._load_with_bases(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _load_with_bases(filename: str) -> Dict:
        cfg = _exec_pyfile(filename)
        bases = cfg.pop(BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
        for base in bases:
            base_cfg = Config._load_with_bases(osp.join(cfg_dir, base))
            dup = set(merged) & set(base_cfg)
            # later bases win on duplicate keys, matching mmcv behaviour of
            # disallowing silent conflicts would be stricter; we merge deeply.
            merged = merge_dict(merged, base_cfg) if dup else {**merged, **base_cfg}
        return merge_dict(merged, cfg)

    @staticmethod
    def fromstring(content: str) -> 'Config':
        with tempfile.NamedTemporaryFile(
                'w', suffix='.py', delete=False) as f:
            f.write(content)
            tmp = f.name
        try:
            return Config.fromfile(tmp)
        finally:
            os.unlink(tmp)

    # ---------------------------------------------------------- access
    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = ConfigDict._wrap(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict:
        return _plain(self._cfg_dict)

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(self._cfg_dict), filename=self._filename)

    def __repr__(self):
        return f'Config (path: {self._filename}): {self._cfg_dict!r}'

    # ---------------------------------------------------------- merging
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key CLI options, e.g. {'model.backbone.depth': 12}.

        Mirrors mmcv ``Config.merge_from_dict`` used by ``--cfg-options``
        (reference tools/train.py:119-121).
        """
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        merged = merge_dict(self.to_dict(), nested)
        object.__setattr__(self, '_cfg_dict', ConfigDict(merged))

    # ---------------------------------------------------------- dumping
    def pretty_text(self) -> str:
        return _format_dict(self.to_dict())

    def dump(self, file: Optional[str] = None) -> Optional[str]:
        text = self.pretty_text()
        if file is None:
            return text
        with open(file, 'w', encoding='utf-8') as f:
            f.write(text)
        return None


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _format_dict(d: Dict, indent: int = 0) -> str:
    lines = []
    pad = ' ' * indent
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f'{pad}{k} = dict(' if indent == 0
                         else f'{pad}{k}=dict(')
            lines.append(_format_inner(v, indent + 4))
            lines.append(f'{pad})' + ('' if indent == 0 else ','))
        else:
            sep = ' = ' if indent == 0 else '='
            tail = '' if indent == 0 else ','
            lines.append(f'{pad}{k}{sep}{v!r}{tail}')
    return '\n'.join(lines)


def _format_inner(d: Dict, indent: int) -> str:
    lines = []
    pad = ' ' * indent
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f'{pad}{k}=dict(')
            lines.append(_format_inner(v, indent + 4))
            lines.append(f'{pad}),')
        else:
            lines.append(f'{pad}{k}={v!r},')
    return '\n'.join(lines)


class DictAction:
    """argparse action-compatible parser for ``key=value`` CLI options.

    Usage: ``parser.add_argument('--cfg-options', nargs='+',
    action=DictAction)``. Values are parsed as python literals when possible.
    """

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        self.option_strings = option_strings
        self.dest = dest
        self.nargs = nargs
        self.required = kwargs.get('required', False)
        self.default = kwargs.get('default', None)
        self.help = kwargs.get('help', None)
        self.const = None
        self.choices = None
        self.metavar = None
        self.type = None

    @staticmethod
    def parse_value(val: str):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            lowered = val.lower()
            if lowered in ('true', 'false'):
                return lowered == 'true'
            if lowered in ('none', 'null'):
                return None
            return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, val = kv.partition('=')
            if not sep:
                raise ValueError(f'cfg-option {kv!r} is not in key=value form')
            options[key] = self.parse_value(val)
        setattr(namespace, self.dest, options)
