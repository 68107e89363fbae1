"""YAML config system with recursive ``_base_`` includes (the port's own
copy of ``point_dae_tpu/utils/config.py``, which the port never imports).

Mirrors the reference config UX (``utils/config.py:19-59``): any ``_base_``
key whose value is a path is loaded and recursively merged underneath the
including dict, and configs support attribute access. Runtime overrides
(``--model_name`` replacing ``model.NAME``, ``--total_bs``, corrupt_type
propagation from the train dataset into the model config, cf.
``main.py:46-55`` in the reference) are implemented in the CLI layer on top
of this module.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict

import yaml


class ConfigDict(dict):
    """dict with attribute access (EasyDict-alike, minimal)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, key, default=None):  # keep dict semantics
        return dict.get(self, key, default)


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v) for v in obj)
    return obj


def to_plain(obj: Any) -> Any:
    """Inverse of _wrap, for serialization."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def merge_new_config(config: Dict, new_config: Dict, *, base_dir: str = ".") -> Dict:
    """Recursively merge ``new_config`` into ``config``.

    A ``_base_`` entry is a path (relative to ``base_dir`` or cwd) to a YAML
    file that is loaded and merged first, so sibling keys override it.
    """
    for key, val in new_config.items():
        if key == "_base_":
            if isinstance(val, dict):
                # already-inlined base: save_config serializes merged configs
                # with _base_ as a nested dict; re-reading the copied
                # config.yaml (the resume flow) must merge it, not
                # os.path.isabs(dict)-crash
                config["_base_"] = ConfigDict()
                merge_new_config(config["_base_"], val, base_dir=base_dir)
                continue
            path = val if os.path.isabs(val) else os.path.join(base_dir, val)
            if not os.path.exists(path) and os.path.exists(val):
                path = val
            with open(path) as f:
                base_cfg = yaml.safe_load(f) or {}
            config["_base_"] = ConfigDict()
            merge_new_config(config["_base_"], base_cfg, base_dir=base_dir)
        elif isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = ConfigDict()
            merge_new_config(config[key], val, base_dir=base_dir)
        else:
            # _wrap so dicts nested inside LISTS get attribute access too
            # (EasyDict parity; plain scalars pass through unchanged)
            config[key] = _wrap(val)
    return config


def cfg_from_yaml_file(path: str, *, base_dir: str | None = None) -> ConfigDict:
    cfg = ConfigDict()
    if base_dir is None:
        # _base_ paths in the reference configs are repo-root-relative
        # ("cfgs/dataset_configs/..."), so default to the directory that
        # contains the cfgs/ tree.
        base_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    with open(path) as f:
        new_cfg = yaml.safe_load(f) or {}
    merge_new_config(cfg, new_cfg, base_dir=base_dir)
    return cfg


def save_config(cfg: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_plain(cfg), f, sort_keys=False)


def propagate_corrupt_type(cfg: Dict) -> ConfigDict:
    """A copy of ``cfg`` in which an unset (or empty) ``model.corrupt_type``
    takes the train dataset's ``dataset.train.others.corrupt_type``, as a
    pretrain run's config load does (``point_dae_tpu/cli.py:116-125``, the
    reference's ``main.py:50-55``). The in-model dropouts of the DGCNN
    pretrain configs are named only in the dataset's list. Fine-tune,
    scratch and test runs leave the model's list untouched, so their
    entries never call this."""
    cfg = _wrap(copy.deepcopy(to_plain(cfg)))
    model_ct = cfg.get("model", {}).get("corrupt_type", None)
    train = cfg.get("dataset", {}).get("train", {})
    ds_ct = train.get("others", {}).get("corrupt_type", None)
    if (not model_ct) and ds_ct:
        cfg["model"]["corrupt_type"] = ds_ct
    return cfg
