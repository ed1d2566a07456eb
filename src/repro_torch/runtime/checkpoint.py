"""Fault-tolerant checkpointing (numpy archives, no extra dependency).

Counterpart of ``repro.runtime.checkpoint``, with its on-disk format, so
a checkpoint written by either package is read by the other:

* **atomicity**: a checkpoint is written to ``step_N.tmp/`` and renamed
  into place, so a crash mid-write never corrupts the latest checkpoint
  (``fault_hook`` lets the fault-injection harness die inside the write
  to prove it);
* **manifest**: a JSON manifest records each leaf's key, dtype and shape
  and the caller's metadata; restore checks the expected run identity
  and every leaf's presence and shape against it BEFORE the array archive
  is opened, so a mismatched or half-written checkpoint fails fast as
  ``ManifestMismatch``;
* **leaf keys** are the reference's ``jax.tree_util.keystr`` strings
  (``['memo']['mask']``, dict keys in sorted order, ``TrialStats`` leaves
  as ``[<flat index i>]``, a ``NamedTuple``'s fields as ``.step``,
  ``.m``, …; ``/`` stored as ``::``);
* **bf16 leaves** are stored as the reference stores them (``np.savez``
  keeps their two-byte bits, ``|V2``; the manifest says ``bfloat16``) and
  come back as bf16 tensors, or as the template's ``ml_dtypes`` array;
* **placement**: ``restore_checkpoint(..., device=)`` puts the leaves on
  that device (the counterpart of the reference's ``shardings=``); without
  it they come back as the template's kind (tensors on the template
  tensor's device, numpy arrays otherwise);
* **retention**: the last ``keep`` checkpoints stay (default 3);
* **MemoBank snapshots**: ``save_memobank`` / ``restore_memobank`` wrap
  the engine's memo (tables, charges, counters, ledger totals,
  ``version``), so a resumed sweep's cost accounting is bitwise an
  uninterrupted run's.

A tree is nested dicts (lists, tuples, ``NamedTuple``s such as
``optim.AdamWState``) of numpy arrays, tensors and ``TrialStats``;
tensors are saved from the host.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..core.sampling.tables import TrialStats

PyTree = Any

__all__ = ["ManifestMismatch", "save_checkpoint", "latest_step",
           "read_manifest", "restore_checkpoint", "save_memobank",
           "restore_memobank"]

_SEP = "::"


class ManifestMismatch(ValueError):
    """The checkpoint manifest does not match what the caller expects
    (wrong run identity, missing leaves, or leaf-shape drift), raised
    BEFORE any array data is read."""


def _leaves(tree: PyTree, key: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in the reference's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{key}[{k!r}]")
    elif isinstance(tree, TrialStats):
        for i, leaf in enumerate(tree.leaves()):
            yield f"{key}[<flat index {i}>]", leaf
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), f"{key}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{key}[{i}]")
    else:
        yield key, tree


def _rebuild(tree: PyTree, fn: Callable, key: str = "") -> PyTree:
    """``tree``'s structure with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{key}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, TrialStats):
        return TrialStats(*(fn(f"{key}[<flat index {i}>]", leaf)
                            for i, leaf in enumerate(tree.leaves())))
    if _is_namedtuple(tree):
        return type(tree)(**{f: _rebuild(getattr(tree, f), fn, f"{key}.{f}")
                             for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{key}[{i}]")
                          for i, v in enumerate(tree))
    return fn(key, tree)


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:        # numpy has no bfloat16
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _bf16_bits(arr: np.ndarray, tmpl, device):
    """A stored bf16 leaf (``|V2`` bits) as ``tmpl``'s kind: a bf16
    tensor, or the template's numpy bfloat16 array without ``device``."""
    bits = arr.view(np.int16)
    if device is None and not isinstance(tmpl, torch.Tensor):
        return bits.view(np.asarray(tmpl).dtype)
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return t.to(device if device is not None else tmpl.device)


def save_checkpoint(directory: str | Path, step: int, tree: PyTree,
                    *, extra: Optional[dict] = None, keep: int = 3,
                    fault_hook: Optional[Callable[[str, Path], None]] = None
                    ) -> Path:
    """Write ``tree`` + ``extra`` metadata as ``step_N/``, atomically.

    ``fault_hook(stage, tmpdir)`` is called mid-write, after the array
    archive lands (``stage="arrays"``) and after the manifest lands
    (``stage="manifest"``), both BEFORE the atomic rename, so the
    fault-injection harness can corrupt the tmp dir and crash where a
    real host would: the previous checkpoint must survive.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = dict(_leaves(tree))
    flat = {k: _host(v) for k, v in leaves.items()}
    np.savez(tmp / "arrays.npz", **{k.replace("/", _SEP): v
                                    for k, v in flat.items()})
    if fault_hook is not None:
        fault_hook("arrays", tmp)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": _dtype_name(leaves[k])}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if fault_hook is not None:
        fault_hook("manifest", tmp)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish

    ckpts = sorted((p for p in directory.glob("step_*")
                    if not p.name.endswith(".tmp")),
                   key=lambda p: int(p.name.split("_")[1]))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest published step in ``directory`` (None if there is none;
    half-written ``.tmp`` dirs do not count)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _jsonable(value):
    """Round-trip through JSON so tuples and numpy scalars compare equal
    to what the manifest stored."""
    return json.loads(json.dumps(value, default=str))


def read_manifest(directory: str | Path, *, step: Optional[int] = None
                  ) -> dict:
    """The manifest dict of ``step`` (default: latest); never touches the
    array archive."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return json.loads(
        (directory / f"step_{step}" / "manifest.json").read_text())


def restore_checkpoint(directory: str | Path, template: PyTree,
                       *, step: Optional[int] = None, device=None,
                       expect: Optional[dict] = None
                       ) -> tuple[PyTree, dict]:
    """Restore into the structure of ``template``; returns ``(tree,
    extra)``.

    Validation is manifest-first: ``expect`` (a dict that must match the
    manifest's ``extra`` key for key, the run-identity contract) and
    every template leaf's presence and shape are checked against the JSON
    manifest BEFORE ``arrays.npz`` is opened; any mismatch raises
    ``ManifestMismatch``. Leaves take the template leaf's dtype; with
    ``device`` they become tensors there, else they keep the template
    leaf's kind (a tensor on its device, or a numpy array).
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())

    if expect:
        stored = manifest.get("extra", {})
        for key, want in expect.items():
            got = stored.get(key)
            if got != _jsonable(want):
                raise ManifestMismatch(
                    f"checkpoint step {step} was written by a different "
                    f"run: extra[{key!r}] is {got!r}, expected "
                    f"{_jsonable(want)!r}")

    man_leaves = manifest["leaves"]
    for key, tmpl in _leaves(template):
        k = key.replace("/", _SEP)
        if k not in man_leaves:
            raise ManifestMismatch(f"checkpoint missing leaf {key}")
        if tuple(man_leaves[k]["shape"]) != tuple(np.shape(_host(tmpl))):
            raise ManifestMismatch(
                f"shape mismatch for {key}: "
                f"{tuple(man_leaves[k]['shape'])} vs "
                f"{tuple(np.shape(_host(tmpl)))}")

    data = np.load(path / "arrays.npz")

    def load(key, tmpl):
        arr = data[key.replace("/", _SEP)]
        if arr.dtype.kind == "V":
            return _bf16_bits(arr, tmpl, device)
        arr = arr.astype(_np_dtype(tmpl))
        if device is not None:
            return torch.as_tensor(arr).to(device)
        if isinstance(tmpl, torch.Tensor):
            return torch.as_tensor(arr).to(tmpl.device)
        return arr
    return _rebuild(template, load), manifest["extra"]


# ---------------------------------------------------------------- MemoBank
def save_memobank(directory: str | Path, step: int, bank,
                  *, extra: Optional[dict] = None, keep: int = 3,
                  fault_hook=None) -> Path:
    """Snapshot a ``MemoBank`` (tables, charges, counters, ledger totals,
    ``version``) as one atomic checkpoint; the bank's identity (app
    names, region counts, config reprs) rides in the manifest."""
    tree, meta = bank.state()
    merged = dict(extra or {})
    merged["memobank"] = meta
    return save_checkpoint(directory, step, tree, extra=merged, keep=keep,
                           fault_hook=fault_hook)


def restore_memobank(directory: str | Path, bank, *,
                     universe: Sequence = (), step: Optional[int] = None,
                     expect: Optional[dict] = None) -> dict:
    """Restore a ``save_memobank`` snapshot (of either package) INTO
    ``bank`` (same apps, any config-column order; ``universe`` supplies
    the config objects the manifest's reprs resolve against). Validates
    the identity before loading; returns the checkpoint's ``extra``."""
    manifest = read_manifest(directory, step=step)
    meta = manifest.get("extra", {}).get("memobank")
    if meta is None:
        raise ManifestMismatch(
            f"checkpoint in {directory} holds no memobank snapshot")
    bank.prepare_restore(meta, universe=universe)
    tree, _ = bank.state()
    restored, extra = restore_checkpoint(
        directory, tree, step=step, expect=expect)
    bank.load_state(restored, meta, universe=universe)
    return extra
