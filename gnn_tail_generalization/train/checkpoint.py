"""Checkpoint / resume: pytree save/load (params + SE tables + opt state).

The reference uses bare torch.save/load of state_dicts with multi-GPU
prefix stripping (``/root/reference/utils.py:958-986``); here the whole
train state (params pytree incl. structural-embedding tables, optimizer
state, epoch counter) round-trips through one ``.npz`` archive keyed by
each leaf's tree path — one file, no pickle of arbitrary objects.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np

import jax


def _leaf_keys(tree: Any):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return ([jax.tree_util.keystr(p) for p, _ in leaves],
            [v for _, v in leaves], treedef)


def save_pytree(tree: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys, leaves, _ = _leaf_keys(tree)
    with open(path, "wb") as f:  # a file object: np.savez adds no suffix
        np.savez(f, **{k: np.asarray(v) for k, v in zip(keys, leaves)})


def load_pytree(template: Any, path: str) -> Any:
    """Restore into the structure of ``template``: every leaf path must be
    in the file with the template's shape (structure-validated, unlike
    torch's strict=False loads)."""
    keys, leaves, treedef = _leaf_keys(template)
    out = []
    with np.load(path, allow_pickle=False) as z:
        for k, t in zip(keys, leaves):
            if k not in z:
                raise KeyError(f"checkpoint {path} has no leaf {k}")
            a = z[k]
            if isinstance(t, (bool, int, float)):
                out.append(type(t)(a))
                continue
            if a.shape != np.shape(t):
                raise ValueError(f"{k}: checkpoint shape {a.shape} != "
                                 f"template shape {np.shape(t)}")
            out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def save_sharded_state(dirpath: str, state: Any, *,
                       overwrite: bool = True) -> None:
    """Multi-host-safe checkpoint of a (possibly sharded) train-state
    pytree via orbax: every process writes only its addressable shards,
    writes are coordinated across the process group, and the layout is
    the standard OCDBT/zarr tree. Use for DistGraph/multi-host runs where
    ``save_pytree``'s ``np.asarray`` would have to materialize
    non-addressable global arrays (impossible off-host).

    The reference's torch.save state_dicts (utils.py:958-986) have no
    sharded analog. orbax is imported here only: single-process runs never
    load it."""
    import orbax.checkpoint as ocp

    # force=True delegates overwrite to orbax, which deletes on the primary
    # host AFTER its save-start barrier — a hand-rolled pre-barrier rmtree
    # races with other processes' existence checks on non-coherent shared
    # filesystems (NFS attribute caches etc.)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(dirpath), state, force=overwrite)
    ckptr.wait_until_finished()


def load_sharded_state(dirpath: str, template: Any) -> Any:
    """Restore a sharded checkpoint. ``template`` is a pytree of arrays OR
    jax.ShapeDtypeStructs; leaves carrying a ``.sharding`` restore straight
    onto those device shardings (each process reads only its shards) —
    including shardings that DIFFER from the ones at save time (orbax
    reshards on load, so a pod checkpoint restores fine on one chip)."""
    import orbax.checkpoint as ocp

    def abstract(x):
        if isinstance(x, (int, float, str, bytes)):
            return x
        sharding = getattr(x, "sharding", None)
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding)

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(dirpath),
                         jax.tree.map(abstract, template))


def _sharded_dir(path: str) -> str:
    return os.path.splitext(path)[0] + ".orbax"


def _needs_sharded_io(state: Any) -> bool:
    """A single-file save is wrong under a process group: every process would
    race on the same file, and ``np.asarray`` cannot materialize leaves
    whose shards live on other hosts."""
    if jax.process_count() > 1:
        return True
    return any(isinstance(leaf, jax.Array) and not leaf.is_fully_addressable
               for leaf in jax.tree.leaves(state))


def save_train_state(path: str, *, params, opt_state=None, batch_stats=None,
                     epoch: int = 0, extra: dict | None = None,
                     sharded: bool | None = None) -> None:
    """``sharded=None`` auto-routes: multi-host (or non-addressable
    leaves) -> orbax directory next to ``path``; otherwise one ``.npz``
    file (reference torch.save analog, utils.py:958-960)."""
    state = {"params": params, "epoch": epoch}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if batch_stats is not None:
        state["batch_stats"] = batch_stats
    if extra:
        state["extra"] = extra
    if sharded is None:
        sharded = _needs_sharded_io(state)
    if sharded:
        save_sharded_state(_sharded_dir(path), state)
        # drop a stale single file from an earlier single-host run at the same
        # path, or load_train_state could later prefer the older file
        if jax.process_index() == 0 and os.path.exists(path):
            os.remove(path)
    else:
        save_pytree(state, path)


def load_train_state(path: str, template: dict) -> dict:
    d = _sharded_dir(path)
    has_dir, has_file = os.path.isdir(d), os.path.exists(path)
    if has_dir and has_file:
        # both formats present (e.g. a single-host file run and a later
        # sharded run sharing a save dir): newest wins
        has_dir = os.path.getmtime(d) > os.path.getmtime(path)
    if has_dir:
        return load_sharded_state(d, template)
    return load_pytree(template, path)
