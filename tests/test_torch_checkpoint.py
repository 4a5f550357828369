"""The port's format-v2 checkpoints (``repro_torch.checkpoint``) against
the reference's (``repro.checkpoint``): each package restores the other's
files bit for bit, the two write the same manifest and the same ``.npy``
payloads, and the port passes the reference's own checkpoint tests
(``tests/test_chaos.py``) on tensors.  bf16 is where they differ: the
reference cannot restore its own bf16 leaves (its dtype audit reads the
``V2`` words ``np.load`` returns as corruption); the port restores them,
and a test pins both behaviours.  Comparisons are exact (raw words)."""
import errno
import json
import os
import threading
import time
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointManager, TreeStructureError,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint, verified_steps,
                                    verify_checkpoint)
from repro_torch.checkpoint.manager import (flatten_with_paths,  # noqa: E402
                                            treedef_str)
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.runtime.chaos import (ChaosInjector,  # noqa: E402
                                       corrupt_checkpoint)
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-4b"


def _words(t):
    """A tensor's raw bits, as a comparable tensor."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_words(x), _words(y))
        for (_, x), (_, y) in zip(fa, fb))


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _train_state(dtype=np.float32, seed=0):
    """The reference's smoke train state as numpy (params cast to
    ``dtype``, moments random f32, step 3) and the same values as the
    port's tensors."""
    params = jax.tree.map(np.asarray, ref_get_bundle(ARCH, smoke=True)
                          .init_params(jax.random.PRNGKey(seed)))
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    opt = jax.tree.map(np.asarray, ref_adamw_init(params))
    rng = np.random.default_rng(seed)
    for k in ("mu", "nu"):
        opt[k] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), opt[k])
    opt["step"] = np.asarray(3, np.int32)
    state = {"params": params, "opt": opt}
    return state, from_jax_params(state)


def _tree(seed, n=3):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, n, generator=g),
            "b": torch.randn(n, generator=g)}


def _leaf_payloads(shard):
    with zipfile.ZipFile(shard) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# ---------------------------------------------------------------------------
# interop with the reference's files
# ---------------------------------------------------------------------------

def test_treedef_and_leaf_paths_equal_jax():
    state, pt = _train_state()
    flat, treedef = jax.tree_util.tree_flatten_with_path(state)
    assert treedef_str(pt) == str(treedef)
    assert [p for p, _ in flatten_with_paths(pt)] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for tree in ({}, {"a": {}}, {"z": torch.zeros(1), "a": torch.zeros(2)}):
        assert treedef_str(tree) == str(jax.tree.structure(
            tree_map(lambda t: t.numpy(), tree)))
    with pytest.raises(TypeError):
        flatten_with_paths({"a": [torch.zeros(1)]})


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference writes the smoke train state (f32); the port restores
    it into its own tensors, every leaf equal bit for bit, the 0-d int32
    step included."""
    state, pt = _train_state()
    ref_ckpt.save_checkpoint(str(tmp_path), 7, state)
    like = _zeros_like(pt)
    out = restore_checkpoint(str(tmp_path), 7, like)
    assert out is like and _equal(like, pt)
    step = like["opt"]["step"]
    assert step.shape == () and step.dtype == torch.int32 and int(step) == 3


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    """The port writes the same state: the reference's verified restore
    takes it, leaf for leaf; the two manifests are equal as JSON and every
    ``leaf_i.npy`` payload is the same bytes."""
    state, pt = _train_state()
    ref_dir, pt_dir = str(tmp_path / "ref"), str(tmp_path / "pt")
    ref_ckpt.save_checkpoint(ref_dir, 7, state)
    save_checkpoint(pt_dir, 7, pt)
    got = ref_ckpt.restore_checkpoint(pt_dir, 7, state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    manifests = [json.load(open(os.path.join(d, "step_00000007",
                                             "manifest.json")))
                 for d in (ref_dir, pt_dir)]
    assert manifests[0] == manifests[1]
    assert manifests[1]["dtypes"][manifests[1]["leaf_paths"].index(
        "['opt']['step']")] == "int32"
    shards = [_leaf_payloads(os.path.join(d, "step_00000007", "shard_0.npz"))
              for d in (ref_dir, pt_dir)]
    assert list(shards[0]) == list(shards[1]) == [
        f"leaf_{i}.npy" for i in range(len(shards[0]))]
    assert shards[0] == shards[1]


def test_bf16_leaves_restore_in_the_port_but_not_in_the_reference(tmp_path):
    """A departure, pinned: the reference writes a bf16 leaf as ml_dtypes'
    raw words (``'<V2'``, manifest ``bfloat16``); ``np.load`` reads it back
    as ``V2`` and the reference's own audit raises CheckpointCorruptError
    on it.  The port restores the same file bit for bit, and writes the
    same bytes for the same bf16 state."""
    state, pt = _train_state(ml_dtypes.bfloat16)
    assert pt["params"]["embed"].dtype == torch.bfloat16
    ref_dir, pt_dir = str(tmp_path / "ref"), str(tmp_path / "pt")
    ref_ckpt.save_checkpoint(ref_dir, 2, state)
    assert ref_ckpt.verify_checkpoint(ref_dir, 2)[0]
    with pytest.raises(ref_ckpt.CheckpointCorruptError,
                       match=r"\|V2.*manifest recorded bfloat16"):
        ref_ckpt.restore_checkpoint(ref_dir, 2, state)
    like = _zeros_like(pt)
    restore_checkpoint(ref_dir, 2, like)
    assert _equal(like, pt)
    save_checkpoint(pt_dir, 2, pt)
    assert _leaf_payloads(os.path.join(ref_dir, "step_00000002",
                                       "shard_0.npz")) == \
        _leaf_payloads(os.path.join(pt_dir, "step_00000002", "shard_0.npz"))
    # a jnp bf16 leaf, as the full-width reference trains it, the same
    one = {"w": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3),
                            jnp.bfloat16)}
    ref_ckpt.save_checkpoint(ref_dir, 3, one)
    like = {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}
    restore_checkpoint(ref_dir, 3, like)
    assert torch.equal(like["w"], torch.arange(6.).reshape(2, 3).bfloat16())


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# ---------------------------------------------------------------------------

def test_multi_host_shards_share_one_step_dir(tmp_path):
    path = str(tmp_path)
    t0, t1 = _tree(0), _tree(1)
    save_checkpoint(path, 5, t1, host_id=1, n_hosts=2)
    assert latest_step(path) is None               # no manifest yet
    save_checkpoint(path, 5, t0, host_id=0, n_hosts=2)
    assert latest_step(path) == 5
    step_dir = os.path.join(path, "step_00000005")
    assert sorted(os.listdir(step_dir)) == [
        "commit_0.json", "commit_1.json", "manifest.json",
        "shard_0.npz", "shard_1.npz"]
    ok, why = verify_checkpoint(path, 5)
    assert ok, why
    r0 = restore_checkpoint(path, 5, _zeros_like(t0), host_id=0)
    r1 = restore_checkpoint(path, 5, _zeros_like(t0), host_id=1)
    assert _equal(r0, t0) and _equal(r1, t1)


def test_verify_detects_missing_pieces(tmp_path):
    path = str(tmp_path)
    save_checkpoint(path, 1, _tree(0), n_hosts=2)  # shard 1 never arrives
    ok, why = verify_checkpoint(path, 1)
    assert not ok and "shard 1" in why
    save_checkpoint(path, 1, _tree(1), host_id=1, n_hosts=2)
    assert verify_checkpoint(path, 1)[0]
    os.remove(os.path.join(path, "step_00000001", "commit_1.json"))
    ok, why = verify_checkpoint(path, 1)
    assert not ok and "never committed" in why


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_newest_falls_back_to_intact(tmp_path, mode):
    path = str(tmp_path)
    t1, t2 = _tree(1), _tree(2)
    save_checkpoint(path, 10, t1)
    save_checkpoint(path, 20, t2)
    corrupt_checkpoint(path, 20, mode=mode)
    assert verified_steps(path) == [10]
    mgr = CheckpointManager(path)
    like = _zeros_like(t1)
    step, tree = mgr.restore(like)
    assert step == 10 and tree is like and _equal(like, t1)
    # explicit-step restore must NOT silently fall back
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_zeros_like(t1), step=20)


def test_treedef_mismatch_names_first_diverging_path(tmp_path):
    path = str(tmp_path)
    save_checkpoint(path, 3, {"layers": {"attn": torch.zeros(2),
                                         "mlp": torch.zeros(3)}})
    mgr = CheckpointManager(path)
    with pytest.raises(TreeStructureError) as ei:
        mgr.restore({"layers": {"attn": torch.zeros(2),
                                "moe": torch.zeros(3)}})
    msg = str(ei.value)
    assert "mlp" in msg and "moe" in msg           # names both sides
    # shape divergence with identical structure is also a caller bug
    with pytest.raises(TreeStructureError) as ei:
        mgr.restore({"layers": {"attn": torch.zeros(2),
                                "mlp": torch.zeros(7)}})
    assert "mlp" in str(ei.value)
    # and so is a dtype the checkpoint does not hold (port: restore copies
    # into `like`, it cannot quietly cast)
    with pytest.raises(TreeStructureError) as ei:
        mgr.restore({"layers": {"attn": torch.zeros(2),
                                "mlp": torch.zeros(3, dtype=torch.bfloat16)}})
    assert "mlp" in str(ei.value) and "bfloat16" in str(ei.value)


@pytest.mark.parametrize("field,value", [("dtypes", "float64"),
                                         ("shapes", [4, 4])])
def test_manifest_shape_dtype_audit_leaves_like_untouched(tmp_path, field,
                                                          value):
    """A shard whose arrays disagree with the manifest is corrupt, not
    silently restored; the audit runs before any byte lands, so `like`
    keeps its values."""
    path = str(tmp_path)
    t = _tree(0)
    save_checkpoint(path, 4, t)
    man = os.path.join(path, "step_00000004", "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m[field][1] = value                  # leaf 1 is "w", the second key
    with open(man, "w") as f:
        json.dump(m, f)
    like = _tree(5)
    before = tree_map(torch.clone, like)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(path, 4, like, verify=False)
    assert _equal(like, before)


def test_restore_never_picks_uncommitted_step_dir(tmp_path):
    path = str(tmp_path)
    t1 = _tree(1)
    save_checkpoint(path, 4, t1)
    newer = os.path.join(path, "step_00000008")     # shard landed, no
    os.makedirs(newer)                              # manifest yet
    np.savez(os.path.join(newer, "shard_0.npz"),
             leaf_0=np.zeros(3, np.float32))
    assert latest_step(path) == 4
    step, tree = CheckpointManager(path).restore(_zeros_like(t1))
    assert step == 4 and _equal(tree, t1)


def test_crash_mid_commit_stray_markers_both_directions(tmp_path):
    path = str(tmp_path)
    t = _tree(0)
    save_checkpoint(path, 5, t)
    with open(os.path.join(path, "step_00000005", "commit_7.json"),
              "w") as f:
        json.dump({"host_id": 7, "crc32": 0, "n_leaves": 99}, f)
    ok, why = verify_checkpoint(path, 5)
    assert ok, why                                  # (a) stray -> ignored
    save_checkpoint(path, 6, t, n_hosts=2)          # shard 1 never written
    with open(os.path.join(path, "step_00000006", "commit_1.json"),
              "w") as f:
        json.dump({"host_id": 1, "crc32": 123, "n_leaves": len(t)}, f)
    ok, why = verify_checkpoint(path, 6)
    assert not ok and "shard 1 missing" in why      # (b) marker != data
    step, _ = CheckpointManager(path).restore(_zeros_like(t))
    assert step == 5


def test_concurrent_save_and_restore_race(tmp_path):
    """A writer committing new steps while a reader restores in a loop:
    the reader ALWAYS gets a fully-committed tree (bit-equal to what that
    step saved) and never crashes on a half-written newest dir."""
    path = str(tmp_path)
    trees = {s: _tree(s) for s in range(1, 13)}
    save_checkpoint(path, 1, trees[1])              # reader never starves
    done = threading.Event()
    errors = []

    def writer():
        try:
            for s in range(2, 13):
                save_checkpoint(path, s, trees[s])
                time.sleep(0.002)
        finally:
            done.set()

    def reader():
        mgr = CheckpointManager(path)
        try:
            while not done.is_set():
                step, tree = mgr.restore(_zeros_like(trees[1]))
                assert _equal(tree, trees[step]), step
        except Exception as e:  # noqa: BLE001 — surfaced to the test
            errors.append(e)

    tw, tr = threading.Thread(target=writer), threading.Thread(target=reader)
    tw.start(), tr.start()
    tw.join(timeout=60), tr.join(timeout=60)
    assert not tw.is_alive() and not tr.is_alive()
    assert not errors, errors
    assert verified_steps(path)[-1] == 12


# ---------------------------------------------------------------------------
# the port's own: async snapshot, in-place restore, diskfull, retention
# ---------------------------------------------------------------------------

def test_in_place_update_after_save_async_does_not_reach_the_file(tmp_path):
    """The train step updates the state in place right after the save is
    handed over: what lands on disk is the state at save time."""
    t = _tree(3)
    want = tree_map(torch.clone, t)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, t)
    for leaf in t.values():
        leaf.add_(1.0)                   # the next step, at once
    mgr.wait()
    got = restore_checkpoint(str(tmp_path), 2, _zeros_like(t))
    assert _equal(got, want) and not _equal(got, t)


def test_restore_writes_into_likes_own_tensors(tmp_path):
    _, pt = _train_state()
    save_checkpoint(str(tmp_path), 1, pt)
    like = _zeros_like(pt)
    ptrs = [(p, t.data_ptr()) for p, t in flatten_with_paths(like)]
    step, out = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 1 and out is like and _equal(like, pt)
    assert [(p, t.data_ptr()) for p, t in flatten_with_paths(like)] == ptrs


def test_diskfull_surfaces_oserror_at_wait(tmp_path):
    chaos = ChaosInjector(["diskfull@4"])
    mgr = CheckpointManager(str(tmp_path),
                            fault_hook=chaos.checkpoint_write_hook)
    mgr.save_async(2, _tree(0))
    mgr.wait()
    mgr.save_async(4, _tree(1))
    with pytest.raises(OSError) as ei:
        mgr.wait()
    assert ei.value.errno == errno.ENOSPC
    mgr.wait()                           # the error is raised once
    mgr.save_async(6, _tree(2))
    mgr.wait()
    assert verified_steps(str(tmp_path)) == [2, 6]
    assert chaos.fired == ["diskfull@4"]


def test_manager_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    assert verified_steps(str(tmp_path)) == [3, 4] and mgr.latest() == 4
    assert mgr.restore(_zeros_like(_tree(0)))[0] == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        _tree(0)) is None


def test_checkpoint_metrics_reach_the_registry_under_the_references_names(
        tmp_path):
    from repro_torch.obs import REGISTRY
    # every checkpoint series, the striped restore's too (another test in
    # this process may have left them), so the counts below are this run's
    names = ("checkpoint_ops", "checkpoint_verify_failures",
             "checkpoint_crc_failures", "checkpoint_read_bytes",
             "checkpoint_save_s", "checkpoint_verify_s",
             "checkpoint_restore_s", "checkpoint_snapshot_s",
             "checkpoint_crc_s", "checkpoint_stripe_bytes",
             "checkpoint_stripe_read_s", "checkpoint_stripe_exchange_s",
             "checkpoint_stripe_crc_s")
    REGISTRY.reset(names)
    path = str(tmp_path)
    mgr = CheckpointManager(path)
    mgr.save_async(1, _tree(0))
    mgr.wait()
    size = os.path.getsize(os.path.join(path, "step_00000001",
                                        "shard_0.npz"))
    mgr.restore(_zeros_like(_tree(0)))
    corrupt_checkpoint(path, 1)
    assert not verify_checkpoint(path, 1)[0]
    snap = REGISTRY.snapshot()
    assert {k: v for k, v in snap["counters"].items()
            if k.startswith("checkpoint")} == {
        "checkpoint_ops{op=save}": 1, "checkpoint_ops{op=verify}": 2,
        "checkpoint_ops{op=restore}": 1, "checkpoint_verify_failures": 1,
        "checkpoint_crc_failures": 1,
        "checkpoint_read_bytes{mode=full}": 3 * size}
    assert {k: h["count"] for k, h in snap["histograms"].items()
            if k.startswith("checkpoint")} == {
        "checkpoint_save_s": 1, "checkpoint_verify_s": 2,
        "checkpoint_restore_s": 1, "checkpoint_snapshot_s": 1,
        "checkpoint_crc_s": 1}
