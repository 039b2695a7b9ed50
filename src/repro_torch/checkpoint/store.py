"""Fault-tolerant checkpointing: atomic, async, keep-N, elastic reshard,
on the JAX package's on-disk layout (one directory per step):

    <root>/step_00000123/
        index.json      # n_leaves, shards, dtypes, shapes, "committed"
        shard_000.npz   # the leaves, keyed leaf_%05d, split every ~512 MB
    <root>/step_00000123.tmp/   # staging dir, renamed on commit

Leaves are numbered in JAX's tree-flatten order: dict keys sorted, lists
and tuples in order, None an empty subtree.  That is not the port's
tree_leaves order (dict insertion order), so this module flattens on its
own, and either package restores what the other wrote, leaf for leaf.
bfloat16 and fp8 leaves are stored as raw void records (V2, V1) and
named in `dtypes` by their numpy names ("bfloat16"), as the JAX package
stores its ml_dtypes arrays; the JAX package's `treedef` field (a repr
of its own treedef, which no restore reads) is a structure string of
this module's own here.

Crash-safety contract: a checkpoint is valid iff its directory has no
".tmp" suffix and index.json parses with committed=true; `latest_step`
returns only valid ones, so a process killed mid-save restarts from the
previous round.

CheckpointManager copies the tree to host memory in `save` (the state
is updated in place by the next step) and hands the copy to a writer
thread.  `reshard_members` maps a member-stacked tree onto K' members.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_map

_CHUNK_BYTES = 512 * 1024 * 1024

# torch dtypes numpy has no type for: stored as raw records of their size
_RAW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
        torch.float8_e5m2: torch.uint8}


def _jax_order(tree) -> list:
    """The leaves of a dict/list/tuple tree in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_order(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_order(v)]
    return [tree]


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _host(leaf: torch.Tensor) -> tuple:
    """A tensor on any device -> (its own numpy copy, its dtype's name);
    raw records for bf16 and fp8."""
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).split(".")[-1]
    if t.dtype in _RAW:
        raw = t.view(_RAW[t.dtype]).numpy()
        return raw.view(f"V{raw.itemsize}"), name
    return t.numpy(), name


def _host_tree(tree) -> tuple:
    """-> (numpy leaves in JAX order, dtype names, structure string)."""
    pairs = [_host(x) for x in _jax_order(tree)]
    return [a for a, _ in pairs], [n for _, n in pairs], _structure(tree)


def _key_str(i: int) -> str:
    return f"leaf_{i:05d}"


def _write(root: str, step: int, host: tuple,
           fail_before_commit: bool = False) -> str:
    leaves, dtypes, structure = host
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shards, cur, cur_bytes = [], {}, 0
    for i, arr in enumerate(leaves):
        cur[_key_str(i)] = arr
        cur_bytes += arr.nbytes
        if cur_bytes >= _CHUNK_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if cur:
        shards.append(cur)
    for s, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{s:03d}.npz"), **shard)
    index = {
        "step": step,
        "treedef": structure,
        "n_leaves": len(leaves),
        "shards": len(shards),
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in leaves],
        "committed": True,
    }
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if fail_before_commit:
        return tmp  # a crash: the stage dir is left behind, never renamed
    if os.path.exists(final):
        shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final


def save_checkpoint(root: str, step: int, tree: Any,
                    fail_before_commit: bool = False) -> str:
    """Blocking atomic save of a tree of tensors (any device).
    `fail_before_commit` is a test hook: it stops after the data is
    written, before the commit rename, as a crash there would."""
    return _write(root, step, _host_tree(tree), fail_before_commit)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            idx = os.path.join(root, name, "index.json")
            try:
                with open(idx) as f:
                    if json.load(f).get("committed"):
                        steps.append(int(name.split("_")[1]))
            except (OSError, ValueError):
                continue
    return max(steps) if steps else None


def _rebuild(template, fn):
    """A tree of template's structure (dicts keep its key order), with
    fn called on its leaves in JAX's flatten order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], fn) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, fn) for v in template]
        if hasattr(template, "_fields"):        # a NamedTuple
            return type(template)(*out)
        return type(template)(out)
    return fn(template)


def restore_checkpoint(root: str, step: int, template: Any) -> Any:
    """Restore into the structure of `template`, a tree of tensors: each
    leaf gets its template's dtype, shape and device."""
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    arrays: dict = {}
    for s in range(index["shards"]):
        with np.load(os.path.join(path, f"shard_{s:03d}.npz")) as z:
            arrays.update({k: z[k] for k in z.files})
    n = len(_jax_order(template))
    if n != index["n_leaves"]:
        raise ValueError(f"{path} holds {index['n_leaves']} leaves, the "
                         f"template {n}")
    count = iter(range(n))

    def leaf(ref: torch.Tensor) -> torch.Tensor:
        i = next(count)
        arr = arrays[_key_str(i)]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: stored shape {arr.shape} != "
                             f"template {tuple(ref.shape)}")
        if arr.dtype.kind == "V":
            # raw records of a dtype numpy lacks (bf16, fp8): view them
            # through the template's dtype, which must be the one index
            # names (bf16 bits read as fp16 would be other numbers)
            name = str(ref.dtype).split(".")[-1]
            if index["dtypes"][i] != name or ref.dtype not in _RAW:
                raise ValueError(f"leaf {i}: stored {index['dtypes'][i]} "
                                 f"records != template {name}")
            raw = _RAW[ref.dtype]
            t = torch.from_numpy(arr.view(str(raw).split(".")[-1]).copy())
            return t.view(ref.dtype).to(ref.device)
        return torch.from_numpy(arr.copy()).to(device=ref.device,
                                               dtype=ref.dtype)

    return _rebuild(template, leaf)


def gc_keep_last(root: str, keep: int) -> None:
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(root)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"),
                      ignore_errors=True)
    # stale staging dirs from crashes are garbage
    for n in os.listdir(root):
        if n.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)


class CheckpointManager:
    """Async keep-N manager: save() copies the tree to host memory and
    returns; a writer thread drains the queue.  wait() barriers and
    re-raises the writer's first error; close() stops the thread."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: List[Exception] = []
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host = item
            try:
                _write(self.root, step, host)
                gc_keep_last(self.root, self.keep)
            except Exception as e:  # reported by wait()
                self._err.append(e)
            self._q.task_done()

    def save(self, step: int, tree: Any) -> None:
        host = _host_tree(tree)
        if self.async_save:
            self._q.put((step, host))
        else:
            _write(self.root, step, host)
            gc_keep_last(self.root, self.keep)

    def wait(self) -> None:
        if self.async_save:
            self._q.join()
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        if self.async_save:
            self._q.put(None)
            self._q.join()
            self._worker.join(timeout=60)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.root)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        s = step if step is not None else self.latest()
        if s is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return restore_checkpoint(self.root, s, template)


def reshard_members(state: Any, k_new: int, perturb: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> Any:
    """Elastic K -> K' on a tree of tensors with a leading member axis.

    Shrink: keep the first K' members.  Grow: cycle the members, and with
    a generator add perturb * N(0, 1) noise to the floating leaves of the
    new members only (the first K stay bit for bit), so that the copies
    diverge.  The noise is drawn from the torch generator: its values are
    not the JAX package's jax.random ones."""
    def one(x):
        k_old = x.shape[0]
        if k_new <= k_old:
            return x[:k_new].clone()
        reps = -(-k_new // k_old)
        out = torch.cat([x] * reps, 0)[:k_new]
        if perturb > 0.0 and generator is not None \
                and x.is_floating_point():
            noise = torch.randn(out[k_old:].shape, generator=generator,
                                dtype=torch.float32,
                                device=generator.device)
            out[k_old:] += (perturb * noise).to(out.device, out.dtype)
        return out

    return tree_map(one, state)
