"""Checkpoint and resume of model parameters and optimizer state.

Counterpart of flashattention_kernel_project_tpu/models/checkpoint.py on
one device: the parameter dict and the optional optimizer state are written
with torch.save into separate files, so a params-only restore (the serving
case) works against a checkpoint written during training, and the step and
config go to a meta.json sidecar, the dtype by name. Orbax's format and a
sharded restore are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

_PARAMS = "params.pt"
_OPT_STATE = "opt_state.pt"
_META = "meta.json"


def _config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for key, val in d.items():
        if isinstance(val, torch.dtype):
            d[key] = str(val).removeprefix("torch.")  # "bfloat16", as JAX names it
    return d


def _save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


def save_checkpoint(
    path: str,
    params: Any,
    *,
    step: int = 0,
    opt_state: Any = None,
    config=None,
) -> str:
    """Write a checkpoint directory: params (and opt_state) as torch files,
    step and config as a JSON sidecar. Returns the checkpoint's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _save(params, os.path.join(path, _PARAMS))
    if opt_state is not None:
        _save(opt_state, os.path.join(path, _OPT_STATE))
    meta = {"step": int(step)}
    if config is not None:
        meta["config"] = _config_to_dict(config)
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def _like(tree: Any, template: Any) -> Any:
    """Move each restored tensor to its template leaf's device, checking
    that shape and dtype agree."""
    if template is None:
        return tree
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise ValueError(f"checkpoint keys {sorted(tree)} differ from the "
                             f"template's {sorted(template)}")
        return {k: _like(tree[k], template[k]) for k in tree}
    if tree.shape != template.shape or tree.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {tree.dtype} {tuple(tree.shape)} "
                         f"does not match {template.dtype} {tuple(template.shape)}")
    return tree.to(template.device)


def restore_checkpoint(
    path: str,
    *,
    params_template: Any | None = None,
    opt_state_template: Any | None = None,
) -> dict:
    """Restore {params, opt_state?, step, config?} from `path`.

    A template (a dict of tensors like the saved one) places each restored
    tensor on its leaf's device and checks shape and dtype; without one,
    tensors load onto the devices they were saved from."""
    path = os.path.abspath(path)

    def load(name, template):
        tree = torch.load(os.path.join(path, name), weights_only=True)
        return _like(tree, template)

    out = {"params": load(_PARAMS, params_template)}
    if os.path.exists(os.path.join(path, _OPT_STATE)):
        out["opt_state"] = load(_OPT_STATE, opt_state_template)
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        out["step"] = meta.get("step", 0)
        if "config" in meta:
            out["config"] = meta["config"]
    return out
