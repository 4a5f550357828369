"""Fault-tolerant checkpointing with verified restores (format v2).

The port's copy of the reference package's ``repro.checkpoint.manager``,
for its train state (nested dicts of tensors), writing and reading the
same files, so a checkpoint written by either package restores in the
other.  Layout: one SHARED directory per step that every host writes
into::

    step_00000040/
        shard_0.npz       one .npz per host (tmp-file + atomic rename):
                          leaf_i in JAX's flatten order (sorted dict keys)
        commit_0.json     per-host commit marker: CRC32 + leaf count
        ...
        manifest.json     final commit, written by host 0 (tmp + rename):
                          treedef, leaf paths/shapes/dtypes, n_hosts

A checkpoint only EXISTS once its manifest is on disk, and it is only
INTACT when every shard named by the manifest is present with a CRC32
matching its commit marker — a crash mid-save leaves an invisible partial
dir, a flipped bit leaves a detectably-corrupt one.  ``restore`` walks
steps newest-to-oldest and falls back to the newest intact checkpoint, so
a corrupted latest save costs one checkpoint interval, not the run.

Saves run on a background thread (async): :meth:`CheckpointManager.save_async`
copies every tensor to the host before it returns (the train step updates
the state in place, so the next step cannot reach the bytes being
written), and the write and its CRC run behind the following steps.

What the port does differently, and why:

* ``treedef`` and ``leaf_paths`` are the strings JAX would write for the
  same nested dict (``PyTreeDef({...})``, ``keystr`` paths), built here
  without JAX, so the reference's structure check accepts the port's
  files.
* bf16 leaves are stored as their raw 16-bit words under the manifest
  dtype ``bfloat16``, in the ``.npy`` header the reference's ml_dtypes
  arrays get (descr ``'<V2'``).  ``np.load`` reads such a leaf back as
  ``V2``; the port restores it to ``torch.bfloat16`` bit for bit, where
  the reference's own dtype audit rejects it as corrupt.
* Restore is IN PLACE: every leaf's shape and dtype is audited from the
  ``.npy`` headers first, then each leaf is read and ``copy_``'d into the
  tensor of ``like`` that already lives on its device, so no second copy
  of the state is ever made on the card.  A restore that fails its audit
  leaves ``like`` untouched.
* The reference's ``sharding_fn`` (re-placing a restored tree on a mesh)
  and its striped multi-host restore have no counterpart on one device.

Error contract: :class:`CheckpointCorruptError` means "this step is
damaged, try an older one" (the manager's fallback does exactly that);
:class:`TreeStructureError` means the CALLER's ``like`` tree disagrees
with what was saved — that is a bug, never silently absorbed, and the
error names the first diverging leaf path.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from itertools import zip_longest
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs import REGISTRY
from repro_torch.weights import BF16, bf16_from_words, to_numpy

FORMAT_VERSION = 2
# the .npy descr of an ml_dtypes bfloat16 array, which the reference writes
_BF16_DESCR = "<V2"
_IO_CHUNK = 1 << 26          # bytes a read or write call moves (64 MiB)


def _count_read(n: int) -> None:
    """Count ``n`` bytes of whole-file checkpoint reads (verify, load)
    under the reference's ``checkpoint_read_bytes{mode=full}`` (its other
    mode is its striped restore)."""
    REGISTRY.counter("checkpoint_read_bytes", n, mode="full")


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """Step is missing pieces or fails its checksums; fall back."""


class TreeStructureError(CheckpointError):
    """`like` and the saved tree disagree structurally; caller bug."""


def flatten_with_paths(tree: Any, prefix: str = ""
                       ) -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict of tensors in JAX's flatten
    order (sorted keys), each path as ``jax.tree_util.keystr`` spells it
    (``['opt']['mu']['embed']``)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix or '<root>'} is a "
                        f"{type(tree).__name__}, not a tensor")
    return [(prefix, tree)]


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy dtype name the manifest records for ``t``."""
    return to_numpy(torch.empty(0, dtype=t.dtype))[1]


def treedef_str(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` of a nested dict of tensors."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _write_json_atomic(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _write_shard(f, leaves: list) -> None:
    """The bytes ``np.savez(f, leaf_0=..., ...)`` writes for the
    reference's arrays: a stored (uncompressed) zip64 member per leaf, a
    version-1.0 ``.npy`` header, then the C-order data.  ``leaves`` (CPU
    tensors) is consumed: each entry becomes None once written, so the
    host memory of an async save's snapshot comes back as the file grows
    instead of after it."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i in range(len(leaves)):
            arr, name = to_numpy(leaves[i].contiguous())
            leaves[i] = None
            header = np.lib.format.header_data_from_array_1_0(arr)
            if name == BF16:
                header["descr"] = _BF16_DESCR
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, header)
                flat = arr.reshape(-1).view(np.uint8)
                for s in range(0, flat.size, _IO_CHUNK):
                    fid.write(memoryview(flat[s:s + _IO_CHUNK]))
            del arr, flat


def _save(path: str, step: int, treedef: str, paths: list[str],
          leaves: list, *, host_id: int, n_hosts: int,
          extra: dict | None) -> str:
    """save_checkpoint's work on a flattened tree of CPU tensors, which
    it consumes (see ``_write_shard``)."""
    t0 = time.monotonic()
    step_dir = _step_dir(path, step)
    os.makedirs(step_dir, exist_ok=True)
    shapes = [list(t.shape) for t in leaves]
    dtypes = [_dtype_name(t) for t in leaves]
    shard = os.path.join(step_dir, f"shard_{host_id}.npz")
    tmp = shard + ".tmp"
    with open(tmp, "wb") as f:
        _write_shard(f, leaves)
    t1 = time.monotonic()
    crc = _crc32_file(tmp)
    REGISTRY.observe("checkpoint_crc_s", time.monotonic() - t1)
    os.replace(tmp, shard)
    _write_json_atomic(os.path.join(step_dir, f"commit_{host_id}.json"),
                       {"host_id": host_id, "crc32": crc,
                        "n_leaves": len(paths)})
    if host_id == 0:
        manifest = {
            "format": FORMAT_VERSION,
            "step": step,
            "n_hosts": n_hosts,
            "treedef": treedef,
            "leaf_paths": paths,
            "n_leaves": len(paths),
            "shapes": shapes,
            "dtypes": dtypes,
            "extra": extra or {},
        }
        _write_json_atomic(os.path.join(step_dir, "manifest.json"), manifest)
    # pushed to the global registry (thread-safe: save_async calls this
    # from its background writer thread while the train loop records)
    REGISTRY.counter("checkpoint_ops", op="save")
    REGISTRY.observe("checkpoint_save_s", time.monotonic() - t0)
    return step_dir


def save_checkpoint(path: str, step: int, tree: Any, *, host_id: int = 0,
                    n_hosts: int = 1, extra: dict | None = None) -> str:
    """Write this host's shard (and, on host 0, the committing manifest).

    Every file lands via tmp-write + ``os.replace`` so readers never see a
    half-written shard; the shared step dir is created idempotently so
    concurrent hosts cannot clobber each other's shards.  Tensors on the
    card are copied to the host here, synchronously.
    """
    flat = flatten_with_paths(tree)
    return _save(path, step, treedef_str(tree), [p for p, _ in flat],
                 [t.detach().cpu() for _, t in flat], host_id=host_id,
                 n_hosts=n_hosts, extra=extra)


def _read_manifest(step_dir: str) -> dict:
    mpath = os.path.join(step_dir, "manifest.json")
    if not os.path.isfile(mpath):
        raise CheckpointCorruptError(f"{step_dir}: no manifest (save never "
                                     "committed)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(f"{step_dir}: unreadable manifest: {e}")
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointCorruptError(
            f"{step_dir}: unsupported format {manifest.get('format')!r}")
    return manifest


def verify_checkpoint(path: str, step: int) -> tuple[bool, str]:
    """Full integrity audit of one step: manifest present, every shard the
    manifest names present, each shard's CRC32 matching its commit marker
    and its leaf count matching the manifest.  Returns (ok, reason)."""
    t0 = time.monotonic()
    step_dir = _step_dir(path, step)

    def done(ok: bool, why: str) -> tuple[bool, str]:
        REGISTRY.counter("checkpoint_ops", op="verify")
        if not ok:
            REGISTRY.counter("checkpoint_verify_failures")
        REGISTRY.observe("checkpoint_verify_s", time.monotonic() - t0)
        return ok, why

    try:
        manifest = _read_manifest(step_dir)
    except CheckpointCorruptError as e:
        return done(False, str(e))
    for h in range(manifest.get("n_hosts", 1)):
        shard = os.path.join(step_dir, f"shard_{h}.npz")
        marker = os.path.join(step_dir, f"commit_{h}.json")
        if not os.path.isfile(shard):
            return done(False, f"shard {h} missing")
        if not os.path.isfile(marker):
            return done(False, f"shard {h} never committed")
        try:
            with open(marker) as f:
                commit = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return done(False, f"shard {h} commit marker unreadable: {e}")
        if commit.get("n_leaves") != manifest["n_leaves"]:
            return done(False,
                        (f"shard {h} has {commit.get('n_leaves')} leaves, "
                         f"manifest says {manifest['n_leaves']}"))
        try:
            crc = _crc32_file(shard)
            _count_read(os.path.getsize(shard))
        except OSError as e:
            # a concurrent writer's GC can reap the step mid-audit; that
            # is "fall back", not a crash
            return done(False, f"shard {h} vanished mid-audit: {e}")
        if crc != commit.get("crc32"):
            REGISTRY.counter("checkpoint_crc_failures")
            return done(False,
                        (f"shard {h} CRC32 {crc:#010x} != committed "
                         f"{commit.get('crc32', 0):#010x}"))
    return done(True, "ok")


def _all_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and "tmp" not in d)


def latest_step(path: str) -> int | None:
    """Newest step whose manifest committed (cheap; no CRC pass — restore
    verifies fully and falls back on damage)."""
    steps = [s for s in _all_steps(path)
             if os.path.isfile(os.path.join(_step_dir(path, s),
                                            "manifest.json"))]
    return max(steps) if steps else None


def verified_steps(path: str) -> list[int]:
    """All steps passing the full CRC audit, oldest first."""
    return [s for s in _all_steps(path) if verify_checkpoint(path, s)[0]]


def _check_structure(step: int, manifest: dict, like: Any
                     ) -> list[tuple[str, torch.Tensor]]:
    """Raise TreeStructureError naming the first diverging leaf path when
    `like` does not match the saved tree; returns like's (path, leaf)
    pairs."""
    flat = flatten_with_paths(like)
    treedef = treedef_str(like)
    if manifest["n_leaves"] == len(flat) and manifest["treedef"] == treedef:
        return flat
    saved_paths = manifest.get("leaf_paths", [])
    for i, (a, b) in enumerate(zip_longest(saved_paths, [p for p, _ in flat],
                                           fillvalue="<missing>")):
        if a != b:
            raise TreeStructureError(
                f"checkpoint step {step}: saved tree and restore target "
                f"diverge at leaf {i}: checkpoint has {a!r}, `like` has "
                f"{b!r}")
    raise TreeStructureError(
        f"checkpoint step {step}: treedef mismatch with identical leaf "
        f"paths (container types differ): saved {manifest['treedef']!r} "
        f"vs {treedef!r}")


def _read_header(fid) -> tuple[list[int], np.dtype, bool]:
    """(shape, dtype, fortran_order) of the ``.npy`` member ``fid``,
    which is left positioned at its data."""
    version = np.lib.format.read_magic(fid)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}.get(version)
    if read is None:
        raise ValueError(f"unsupported .npy version {version}")
    shape, fortran, dtype = read(fid)
    return list(shape), dtype, fortran


def _audit(step: int, manifest: dict, flat: list, headers: list) -> None:
    """Every leaf's header against the manifest (corruption) and against
    the `like` target (caller bug), before any byte is copied."""
    paths = manifest.get("leaf_paths", ["?"] * len(flat))
    for i, ((_, leaf), (shape, dtype, fortran)) in enumerate(
            zip(flat, headers)):
        want = manifest["dtypes"][i]
        # a bf16 leaf is the V2 payload ml_dtypes writes, by either package
        got = want if want == BF16 and dtype == np.dtype("V2") \
            else str(dtype)
        if shape != manifest["shapes"][i] or got != want or fortran:
            raise CheckpointCorruptError(
                f"step {step}: leaf {i} is {dtype}{shape}"
                f"{' (Fortran order)' if fortran else ''}, manifest "
                f"recorded {want}{manifest['shapes'][i]}")
        if shape != list(leaf.shape) or want != _dtype_name(leaf):
            raise TreeStructureError(
                f"step {step}: leaf {i} ({paths[i]}): checkpoint "
                f"{want}{shape} vs restore target "
                f"{_dtype_name(leaf)}{list(leaf.shape)}")


def _read_leaf(zf: zipfile.ZipFile, i: int, leaf: torch.Tensor,
               dtype_name: str) -> torch.Tensor:
    """Member ``leaf_i.npy``'s data as a CPU tensor shaped like ``leaf``,
    read in chunks into one host buffer of the leaf's size."""
    host = torch.empty(leaf.numel() * leaf.element_size(), dtype=torch.uint8)
    buf = host.numpy()
    with zf.open(f"leaf_{i}.npy") as fid:
        _read_header(fid)
        off = 0
        while off < buf.size:
            chunk = fid.read(min(_IO_CHUNK, buf.size - off))
            if not chunk:
                raise EOFError(f"leaf data ends at byte {off} of "
                               f"{buf.size}")
            buf[off:off + len(chunk)] = np.frombuffer(chunk, np.uint8)
            off += len(chunk)
    if dtype_name == BF16:
        src = bf16_from_words(buf.view(np.int16))
    else:
        src = torch.from_numpy(buf.view(np.dtype(dtype_name)))
    return src.reshape(leaf.shape)


def restore_checkpoint(path: str, step: int, like: Any, *,
                       host_id: int = 0, verify: bool = True) -> Any:
    """Verified restore INTO the tensors of `like` (a nested dict of
    tensors, each already on its device); returns `like`.  Raises
    CheckpointCorruptError on damage (fallback-able) and
    TreeStructureError on a `like` mismatch (not fallback-able); either
    raised by the audit leaves `like` untouched."""
    t0 = time.monotonic()
    step_dir = _step_dir(path, step)
    if verify:
        ok, why = verify_checkpoint(path, step)
        if not ok:
            raise CheckpointCorruptError(f"step {step}: {why}")
    manifest = _read_manifest(step_dir)
    flat = _check_structure(step, manifest, like)
    shard = os.path.join(step_dir, f"shard_{host_id}.npz")
    try:
        zf = zipfile.ZipFile(shard)
    except Exception as e:  # zipfile/zlib raise various types on damage
        raise CheckpointCorruptError(f"step {step}: shard {host_id} "
                                     f"unreadable: {e}")
    with zf:
        headers = []
        for i in range(len(flat)):
            try:
                with zf.open(f"leaf_{i}.npy") as fid:
                    headers.append(_read_header(fid))
            except Exception as e:
                raise CheckpointCorruptError(
                    f"step {step}: shard {host_id} leaf {i} unreadable: "
                    f"{e}")
        _audit(step, manifest, flat, headers)
        with torch.no_grad():
            for i, (_, leaf) in enumerate(flat):
                try:
                    src = _read_leaf(zf, i, leaf, manifest["dtypes"][i])
                except Exception as e:
                    raise CheckpointCorruptError(
                        f"step {step}: shard {host_id} leaf {i} "
                        f"unreadable: {e}")
                leaf.copy_(src)
                del src
    _count_read(os.path.getsize(shard))
    REGISTRY.counter("checkpoint_ops", op="restore")
    REGISTRY.observe("checkpoint_restore_s", time.monotonic() - t0)
    return like


class CheckpointManager:
    """Async checkpointing with bounded retention, restart discovery and
    verified-restore fallback."""

    def __init__(self, path: str, *, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1,
                 fault_hook: Callable[[int], None] | None = None):
        self.path = path
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        # fault injection seam (chaos `diskfull@N`): called with the step
        # on the writer thread BEFORE any bytes land; an exception it
        # raises surfaces at the next wait() like a real failed write
        self.fault_hook = fault_hook
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        """Device->host copy happens here (blocking: a host copy even of a
        CPU tensor, so an in-place update after this returns cannot reach
        the file); the disk write is backgrounded.  Call wait() before
        process exit."""
        t0 = time.monotonic()
        flat = flatten_with_paths(tree)
        treedef, paths = treedef_str(tree), [p for p, _ in flat]
        leaves = [t.detach().to("cpu", copy=True) for _, t in flat]
        del flat
        REGISTRY.observe("checkpoint_snapshot_s", time.monotonic() - t0)
        self.wait()

        def work():
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                _save(self.path, step, treedef, paths, leaves,
                      host_id=self.host_id, n_hosts=self.n_hosts,
                      extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in _all_steps(self.path)[:-self.keep]:
            shutil.rmtree(_step_dir(self.path, s), ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.path)

    def restore(self, like: Any, step: int | None = None
                ) -> tuple[int, Any] | None:
        """Restore `step` (default: newest) into `like`, falling back
        through older checkpoints when the newer ones fail verification.
        Returns (step, like) or None when nothing intact exists.  A
        tree-structure mismatch raises immediately — older checkpoints
        would mismatch the same way, and silently restoring the wrong
        structure is the one failure this module exists to prevent."""
        def load(s: int) -> Any:
            return restore_checkpoint(self.path, s, like,
                                      host_id=self.host_id)

        if step is not None:
            return step, load(step)
        for s in reversed(_all_steps(self.path)):
            try:
                return s, load(s)
            except CheckpointCorruptError as e:
                print(f"[ckpt] step {s} failed verification ({e}); "
                      f"falling back")
        return None
