"""Checkpoint and resume of model parameters and optimizer state, on one
device or sharded over a device mesh.

Counterpart of flashattention_kernel_project_tpu/models/checkpoint.py. The
parameters and the optional optimizer state are separate items, so a
params-only restore (the serving case) works against a checkpoint written
during training; the step and config go to a meta.json sidecar, the dtype
by name.

An item whose leaves are plain tensors is one torch.save file. An item
with DTensor leaves (the rank's shards on a mesh from parallel.make_mesh,
laid out by `to_dtensors`) is written by torch.distributed.checkpoint
(DCP): every rank calls save_checkpoint, each writes its own shards, and a
replicated leaf is written once. Restoring follows the template, as JAX's
restore follows its abstract template's shardings: DTensor leaves get the
rank's block of each saved array (the checkpoint may have been written on
one device or over any layout), plain leaves the whole array (a checkpoint
written over a mesh restores onto one device). Orbax's format is read by
models/convert.py's callers, not here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

import torch
import torch.distributed as dist

_PARAMS = "params"
_OPT_STATE = "opt_state"
_META = "meta.json"


def _config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for key, val in d.items():
        if isinstance(val, torch.dtype):
            d[key] = str(val).removeprefix("torch.")  # "bfloat16", as JAX names it
    return d


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _has_dtensor(tree: Any) -> bool:
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    return isinstance(tree, _dtensor())


def _placements(mesh, spec):
    """The DTensor placements of a spec (utils.sharding.P) on `mesh`: Shard
    along the dimension a mesh axis cuts, Replicate along an axis it does
    not name."""
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec or ())
    return [Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh.mesh_dim_names]


def to_dtensors(tree: Any, mesh, specs: Any) -> Any:
    """The rank's shards in `tree` (parallel.shard_params' result) as
    DTensors on `mesh` with the layout of `specs`, a tree of the same
    structure (models.param_shardings; `optimizer_specs` for a
    torch.optim state_dict); a None or P() spec is whole on every rank.
    Leaves that are not tensors stay as they are."""
    if isinstance(tree, dict):
        return {k: to_dtensors(v, mesh, specs.get(k) if isinstance(specs, dict)
                               else None) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return _dtensor().from_local(tree, mesh, _placements(mesh, specs),
                                 run_check=False)


def from_dtensors(tree: Any) -> Any:
    """The rank's local shards of the DTensor leaves of `tree`."""
    if isinstance(tree, dict):
        return {k: from_dtensors(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, _dtensor()) else tree


def optimizer_specs(opt_state: dict, opt_state_specs: dict) -> dict:
    """The specs tree of a torch.optim state_dict for `to_dtensors`:
    parameter i's entries of its shape laid out by opt_state_specs[i]
    (parallel.make_optax_train_step's), its scalar entries (the step
    counts) whole, param_groups as it is."""
    return {"state": {i: {k: (opt_state_specs[i] if v.dim() else None)
                          for k, v in entries.items()}
                      for i, entries in opt_state["state"].items()}}


def _write(path: str, write) -> None:
    """write(tmp) then rename onto `path`: a reader never sees a
    half-written file, and ranks writing the same file race harmlessly."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def _save_item(obj: Any, path: str) -> None:
    import torch.distributed.checkpoint as dcp

    if _has_dtensor(obj):
        dcp.save(obj, checkpoint_id=path)
    else:
        _write(path + ".pt", lambda tmp: torch.save(obj, tmp))


def save_checkpoint(
    path: str,
    params: Any,
    *,
    step: int = 0,
    opt_state: Any = None,
    config=None,
) -> str:
    """Write a checkpoint directory: params (and opt_state) as torch files,
    or, where their leaves are DTensors, as DCP directories written by
    every rank of the mesh, each calling this with its own shards; step and
    config as a JSON sidecar. Returns the checkpoint's path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _save_item(params, os.path.join(path, _PARAMS))
    if opt_state is not None:
        _save_item(opt_state, os.path.join(path, _OPT_STATE))
    meta = {"step": int(step)}
    if config is not None:
        meta["config"] = _config_to_dict(config)

    def dump(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)

    _write(os.path.join(path, _META), dump)
    return path


def _block(full: torch.Tensor, like) -> torch.Tensor:
    """The block of the whole array `full` that the DTensor `like` holds on
    this rank."""
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    out = full
    for axis, placement in enumerate(like.placements):
        if isinstance(placement, Shard):
            size = full.shape[placement.dim] // mesh.size(axis)
            out = out.narrow(placement.dim, coord[axis] * size, size)
    return out


def _like(tree: Any, template: Any) -> Any:
    """A whole array's tree laid out as the template: each leaf checked
    against its template leaf's (global) shape and dtype, then moved to its
    device, as the rank's block where the leaf is a DTensor."""
    if template is None:
        return tree
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise ValueError(f"checkpoint keys {sorted(tree)} differ from the "
                             f"template's {sorted(template)}")
        return {k: _like(tree[k], template[k]) for k in tree}
    if not isinstance(template, torch.Tensor):
        return tree
    if tree.shape != template.shape or tree.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {tree.dtype} {tuple(tree.shape)} "
                         f"does not match {template.dtype} {tuple(template.shape)}")
    if isinstance(template, _dtensor()):
        local = template.to_local()
        return _dtensor().from_local(
            _block(tree, template).to(local.device).contiguous(),
            template.device_mesh, template.placements, run_check=False)
    return tree.to(template.device)


def _empty_like(template: Any) -> Any:
    if isinstance(template, dict):
        return {k: _empty_like(v) for k, v in template.items()}
    if isinstance(template, list):
        return [_empty_like(v) for v in template]
    if isinstance(template, torch.Tensor):
        return torch.empty_like(template)
    return template


def _load_item(path: str, template: Any) -> Any:
    import torch.distributed.checkpoint as dcp

    if os.path.exists(path + ".pt"):
        return _like(torch.load(path + ".pt", weights_only=True), template)
    no_dist = not dist.is_initialized()
    if template is None:
        # the whole arrays on the CPU, read through a torch.save file; dict
        # keys come back as strings (an optimizer state's parameter indices
        # too)
        from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

        with tempfile.TemporaryDirectory() as tmp:
            dcp_to_torch_save(path, os.path.join(tmp, "item.pt"))
            return torch.load(os.path.join(tmp, "item.pt"), weights_only=True)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    _check(saved, template)
    out = _empty_like(template)
    dcp.load(out, checkpoint_id=path, no_dist=no_dist)
    return out


def _check(saved: dict, template: Any, key: str = "") -> None:
    """The template's tensor leaves against a sharded item's metadata
    (`saved`: DCP's by dotted key): the same keys, (global) shapes and
    dtypes, or ValueError, as the torch file's `_like` checks."""
    if isinstance(template, dict):
        for k, v in template.items():
            _check(saved, v, f"{key}{k}.")
        return
    if not isinstance(template, torch.Tensor):
        return
    meta = saved.get(key[:-1])
    if meta is None or not hasattr(meta, "size"):
        raise ValueError(f"checkpoint has no array {key[:-1]!r}")
    if meta.size != template.shape or meta.properties.dtype != template.dtype:
        raise ValueError(f"checkpoint leaf {meta.properties.dtype} "
                         f"{tuple(meta.size)} does not match {template.dtype} "
                         f"{tuple(template.shape)}")


def restore_checkpoint(
    path: str,
    *,
    params_template: Any | None = None,
    opt_state_template: Any | None = None,
) -> dict:
    """Restore {params, opt_state?, step, config?} from `path`.

    A template (a tree like the saved one) places each restored leaf: a
    plain tensor leaf gets the whole array on its device, a DTensor leaf
    this rank's block of it on the DTensor's mesh and layout (every rank of
    the mesh calls restore_checkpoint); shapes and dtypes are checked.
    Without a template, a torch file loads onto the devices it was saved
    from, and a sharded item as whole arrays on the CPU."""
    path = os.path.abspath(path)
    out = {"params": _load_item(os.path.join(path, _PARAMS), params_template)}
    opt = os.path.join(path, _OPT_STATE)
    if os.path.exists(opt) or os.path.exists(opt + ".pt"):
        out["opt_state"] = _load_item(opt, opt_state_template)
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        out["step"] = meta.get("step", 0)
        if "config" in meta:
            out["config"] = meta["config"]
    return out
