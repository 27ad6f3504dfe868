"""Checkpointing: save/restore/resume with atomic rotation.

Layout per step: ``<dir>/step_<n>/host_<i>/arrays.npz`` + ``manifest.json``
(tree paths, shapes, dtypes, step, wall time): the reference's format,
key names included, so a checkpoint one package writes, the other
restores. Writes go to a temp dir then ``rename``, so a preempted save
never corrupts the latest checkpoint. ``CheckpointManager`` rotates old
steps and can serialize off the caller's thread.

Trees are dicts (keys sorted), tuples and lists (keys ``"0"``, ``"1"``,
...) and NamedTuples (keys ``".<field>"``), joined with ``/``; ``None``
holds no leaf. Leaves are tensors, numpy arrays or scalars. A bfloat16
leaf is stored widened to float32 (npz has no bfloat16).

On a multi-host cluster each process saves its own leaves under
``host_<i>/``; the first host to publish a step renames it into place and
later hosts merge their shard dir into it.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _map_with_path(tree: Any, fn: Callable[[str, Any], Any],
                   path: tuple = ()) -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(key, leaf)``, where
    ``key`` is the leaf's path joined with ``/``, named as
    ``jax.tree_util`` names it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(tree[k], fn, path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(v, fn, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _host_array(leaf: Any) -> np.ndarray:
    """One leaf on the host as numpy, bfloat16 widened to float32 (npz
    cannot store it). A CPU tensor's array shares its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":   # ml_dtypes' bfloat16
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _host_array(leaf)
    _map_with_path(tree, put)
    return flat


def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, state: Any,
                    host_id: int = 0) -> pathlib.Path:
    """Save one host's leaves for ``step``; safe under concurrent hosts.

    Each host stages into its own ``.tmp_step_<n>_<host>`` dir and then
    publishes. The first host to publish renames the whole tmp dir into
    place (atomic); later hosts MERGE their ``host_<i>/`` shard dir into
    the already-published step dir instead of clobbering the shards every
    other host already wrote for it. A host re-saving the same step
    replaces only its own shard dir.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{host_id}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / f"host_{host_id}").mkdir(parents=True)
    flat = _flatten(state)
    np.savez(tmp / f"host_{host_id}" / "arrays.npz", **flat)
    manifest = {
        "step": int(step), "time": time.time(),
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in flat.items()},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if not final.exists():
        try:
            tmp.rename(final)          # atomic publish (first host wins)
            return final
        except OSError:
            pass                       # another host published first: merge
    # merge: move this host's shard dir into the published step (atomic
    # per-host rename), then fold its keys into the shared manifest
    host_dir = final / f"host_{host_id}"
    if host_dir.exists():              # same host re-saving this step
        shutil.rmtree(host_dir)
    (tmp / f"host_{host_id}").rename(host_dir)
    man_path = final / "manifest.json"
    try:
        merged = json.loads(man_path.read_text())
    except (OSError, json.JSONDecodeError):
        merged = {"step": int(step), "time": manifest["time"], "keys": {}}
    merged["keys"].update(manifest["keys"])
    man_path.write_text(json.dumps(merged))
    shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _like(arr: np.ndarray, leaf: Any, cut=None, key: str = "") -> Any:
    """``arr`` as the template leaf's kind: a tensor in its dtype on its
    device (``cut(key, tensor)`` first, on the host), a numpy array in its
    dtype, or a scalar of its type."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(arr)
        if cut is not None:
            t = cut(key, t)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return arr.astype(leaf.dtype)
    return type(leaf)(arr.item())


def restore_checkpoint(ckpt_dir: str | pathlib.Path, template: Any,
                       step: Optional[int] = None, host_id: int = 0, *,
                       cut=None) -> Any:
    """Restore into the structure of ``template``: each leaf cast to the
    template leaf's dtype and put on its device. ``cut(key, tensor)``:
    what to keep of each whole tensor leaf, taken on the host before it
    moves (a rank's block, so a device never holds the whole state)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}" / f"host_{host_id}" / "arrays.npz"
    with np.load(path) as data:
        return _map_with_path(template, lambda key, leaf: _like(
            data[key], leaf, cut, key))


class CheckpointManager:
    """Rotating checkpoint manager with optional async saves."""

    def __init__(self, ckpt_dir: str | pathlib.Path, keep: int = 3,
                 every: int = 100, async_save: bool = False):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.every = every
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.every:
            return False
        self.wait()
        # owned host copies BEFORE handing off to the thread: the caller's
        # next step may overwrite its tensors, and the writer thread touches
        # numpy only (a device tensor's copy ends in a sync)
        snap = {k: np.array(v) for k, v in _flatten(state).items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, snap), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, snap)
        return True

    def _save_and_gc(self, step: int, state: Any) -> None:
        save_checkpoint(self.dir, step, state)
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_latest(self, template: Any, *, cut=None) -> tuple[Any, int]:
        """(the latest checkpoint restored into ``template``'s structure
        (``cut``: see :func:`restore_checkpoint`), its step), or
        (``template``, 0) without one."""
        step = latest_step(self.dir)
        if step is None:
            return template, 0
        return restore_checkpoint(self.dir, template, step, cut=cut), step
