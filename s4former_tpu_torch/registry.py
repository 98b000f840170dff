"""Minimal component registry (the port's own copy of
``s4former_tpu/registry.py``).

Rebuild of the mmcv registry machinery the reference relies on
(reference: mmseg/models/builder.py:8-15): registries are named dicts with a
``build`` helper that pops ``type`` from a config dict.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """Name -> class/function mapping with config-driven construction."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self,
                        name: Optional[str] = None,
                        module: Optional[Any] = None,
                        force: bool = False) -> Callable:
        """Register a class/function, usable as decorator or plain call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool):
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f'module must be a class or function, '
                            f'got {type(module)}')
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        """Instantiate from a config dict with a ``type`` key.

        Extra ``default_kwargs`` fill in arguments not present in ``cfg``.
        """
        if cfg is None:
            return None
        if not isinstance(cfg, dict):
            raise TypeError(f'cfg must be a dict, got {type(cfg)}')
        if 'type' not in cfg:
            raise KeyError(f'cfg must contain the key "type": {cfg}')
        args = dict(cfg)
        obj_type = args.pop('type')
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
            if obj_cls is None:
                raise KeyError(
                    f'{obj_type} is not in the {self._name} registry. '
                    f'Available: {sorted(self._module_dict)}')
        else:
            obj_cls = obj_type
        for k, v in default_kwargs.items():
            args.setdefault(k, v)
        return obj_cls(**args)


# Single shared MODELS registry: the reference aliases
# BACKBONES/NECKS/HEADS/LOSSES/SEGMENTORS to one registry
# (mmseg/models/builder.py:8-15); we do the same.
MODELS = Registry('models')
BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
LOSSES = MODELS
SEGMENTORS = MODELS

DATASETS = Registry('datasets')
PIPELINES = Registry('pipelines')
SAMPLERS = Registry('samplers')
HOOKS = Registry('hooks')

