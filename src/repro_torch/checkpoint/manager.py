"""Fault-tolerant checkpointing: atomic, versioned, keep-k.

The reference's layout, file for file, so each package restores a
checkpoint the other wrote: one `.npy` file per leaf of the state tree
(`00000.npy`, ... in the reference's flattening order: dict keys sorted,
sequences in order), named in a JSON manifest by its tree path
(`params/0/w`, `opt/count`, ...) beside the step, the metadata (the
data cursor) and `"complete": true`.  Writes go to a temp dir renamed
into place, so a crash mid-save never corrupts the latest checkpoint;
`restore` picks the newest complete manifest and falls back past a
corrupt one.  Leaves are tensors (saved from any device, restored onto
the device of the tree they are restored into), numpy arrays or Python
scalars.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint write or read failed."""


class CorruptCheckpointError(CheckpointError):
    """A checkpoint directory exists but its contents are unreadable
    (truncated manifest, missing leaf file, torn npy)."""


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(path name, leaf) in the reference's flattening order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_names(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(like, by_name, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, by_name, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, by_name, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return by_name[prefix[:-1]]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None

    # ------------------------------------------------------------ save
    def save(self, step: int, tree, metadata: Optional[dict] = None):
        """Atomic save.  With async_save=True the device->host copy is
        synchronous (a snapshot) but the disk write happens on a thread;
        a failure there is re-raised from the next save() or wait()."""
        host = [(n, _host(v)) for n, v in _flatten_with_names(tree)]
        if self.async_save:
            self.wait()         # raises if the previous write failed
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, metadata or {}))
            self._thread.start()
        else:
            self._write(step, host, metadata or {})

    def _write_async(self, step: int, host, metadata: dict):
        try:
            self._write(step, host, metadata)
        except BaseException as e:  # noqa: BLE001 — surfaced in wait()
            self._async_error = e

    def wait(self):
        """Join any in-flight async write and re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise CheckpointError(
                f"async checkpoint write failed: {err!r}") from err

    def _write(self, step: int, host, metadata: dict):
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        names = []
        for i, (name, arr) in enumerate(host):
            np.save(tmp / f"{i:05d}.npy", arr)
            names.append(name)
        manifest = {"step": step, "names": names, "time": time.time(),
                    "metadata": metadata, "complete": True}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)           # atomic on POSIX
        self._gc()

    def _gc(self):
        ckpts = self.all_steps()
        for step in ckpts[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{step:010d}",
                          ignore_errors=True)

    # ------------------------------------------------------------ load
    def all_steps(self):
        steps = []
        for p in self.dir.glob("step_*"):
            mf = p / "manifest.json"
            if not mf.exists():
                continue
            try:
                m = json.loads(mf.read_text())
                if m.get("complete"):
                    steps.append(int(m["step"]))
            except (OSError, ValueError, KeyError, TypeError,
                    AttributeError):
                continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None):
        """Restore into the structure of `tree_like`; a tensor leaf comes
        back as a tensor on the device of its `tree_like` leaf.

        With `step=None`, a corrupt newest checkpoint (torn manifest,
        missing leaf file) falls back to the next-newest complete one
        with a RuntimeWarning; an explicit `step` raises
        `CorruptCheckpointError`."""
        if step is not None:
            return self._restore_step(tree_like, step)
        candidates = self.all_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._restore_step(tree_like, s)
            except CorruptCheckpointError as e:
                warnings.warn(
                    f"checkpoint step {s} is corrupt ({e}); falling back "
                    f"to the next-newest complete checkpoint",
                    RuntimeWarning, stacklevel=2)
                last_err = e
        raise CorruptCheckpointError(
            f"all {len(candidates)} checkpoint(s) in {self.dir} are "
            f"corrupt") from last_err

    def _restore_step(self, tree_like, step: int):
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CorruptCheckpointError(
                f"unreadable manifest in {d}: {e}") from e
        by_index = {n: i for i, n in enumerate(manifest["names"])}
        leaves = {}
        for name, like in _flatten_with_names(tree_like):
            if name not in by_index:
                raise KeyError(f"checkpoint missing leaf {name}")
            try:
                arr = np.load(d / f"{by_index[name]:05d}.npy")
            except (OSError, EOFError, ValueError) as e:
                raise CorruptCheckpointError(
                    f"unreadable leaf {name} in {d}: {e}") from e
            like_shape = tuple(like.shape) if hasattr(like, "shape") \
                else np.shape(like)
            if tuple(arr.shape) != tuple(like_shape):
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != {like_shape}")
            if isinstance(like, torch.Tensor):
                leaves[name] = torch.from_numpy(arr).to(like.device)
            elif isinstance(like, np.ndarray) or hasattr(like, "dtype"):
                leaves[name] = arr
            else:
                leaves[name] = arr.item()   # plain python scalar leaf
        return _rebuild(tree_like, leaves), manifest["metadata"], step
